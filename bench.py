"""Benchmark: one JSON line for one of three kinds of work.

  sweep (default)  diffuse-sweep throughput in cells*angles/s: the full
                   192-direction (nAngularLevel 3) three-band sweep on a
                   256^3 uniform grid, float32, XLA slab scan (core.sweep)
  rays             point-source tracer throughput in rays/s: 8 sources at
                   maxPixelLevel 6 on a 128^3 grid
  step             a full mode-8 transport+chemistry iteration (tracer +
                   sweep + equilibrium chemistry), 128^3, 192 directions

Every line names the platform, device kind and device count it ran on.
The bench needs a GPU and raises if JAX finds none; the one exception is
a rehearsal with JAX_PLATFORMS=cpu set explicitly, whose line then says
"cpu".  Times are the best of BENCH_REPS warm runs, each ended by
jax.block_until_ready; the first (compiling) run is reported as
compile_s.

Environment knobs:
  BENCH_KIND     sweep | rays | step
  BENCH_N        grid size per side (sweep 256, rays/step 128)
  BENCH_LEVEL    angular level (default 3 -> 192 directions)
  BENCH_SOURCES  point sources (rays/step, default 8)
  BENCH_REPS     timed repetitions (default 3)
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


def _device_record() -> dict:
    """platform / device_kind / count of the backend; raises unless it is
    a GPU or the caller explicitly asked for a CPU rehearsal."""
    import jax
    dev = jax.devices()[0]
    cpu_requested = "cpu" in os.environ.get("JAX_PLATFORMS", "").split(",")
    if dev.platform != "gpu" and not (dev.platform == "cpu"
                                      and cpu_requested):
        raise RuntimeError(
            f"bench.py needs a GPU, found {dev.platform!r} "
            "(set JAX_PLATFORMS=cpu explicitly for a CPU rehearsal)")
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def _time_runs(run, reps: int) -> tuple[float, float]:
    """(compile+first-run seconds, best warm seconds) of `run`, each run
    ended by block_until_ready."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(run())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    return first, min(times)


def _sources(n: int, n_src: int):
    from radiativetransfer_tpu.core import rays
    rng = np.random.default_rng(0)
    pos = (np.floor(rng.uniform(0.3, 0.7, (n_src, 3)) * n) + 0.5) / n
    return rays.SourceBatch(position=pos, weight=np.ones(n_src),
                            table_idx=np.zeros(n_src, np.int32))


def bench_rays(reps: int) -> dict:
    """Point-source tracer throughput: S sources at maxPixelLevel 6 on a
    BENCH_N^3 grid (12288 rays/source at the final phase)."""
    import jax.numpy as jnp

    from radiativetransfer_tpu.constants import KPC, MYR
    from radiativetransfer_tpu.core import rays, step as step_mod
    from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
    from radiativetransfer_tpu.tables import stellar

    n = int(os.environ.get("BENCH_N", "128"))
    n_src = int(os.environ.get("BENCH_SOURCES", "8"))
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    # volume-normalized quadrature tables, as the CLI builds them
    ctx = step_mod.StellarContext.build(
        stellar.blackbody_population(q_ionizing=1.0e51),
        _sources(n, n_src), geom, 10.0 * MYR, metal_coefs=[(0, 0.0)])
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=jnp.float32)

    def run():
        return rays.trace_point_sources(state, geom, ctx.sources, ctx.tables,
                                        max_pixel_level=6,
                                        dtype=jnp.float32,
                                        rates_mode="quadrature")[0]

    first, dt = _time_runs(run, reps)
    total_rays = n_src * sum(12 * 4 ** (l - 1) for l in range(1, 7))
    return {"metric": f"point-source rays/s ({n}^3 grid, {n_src} sources, "
                      "maxPixelLevel 6, quadrature rates, f32)",
            "value": total_rays / dt, "unit": "rays/s",
            "seconds": dt, "compile_s": first}


def bench_step(reps: int) -> dict:
    """Full production iteration: mode-8 (point-source trace + sweep +
    equilibrium chemistry) on a BENCH_N^3 grid, f32."""
    import jax.numpy as jnp

    from radiativetransfer_tpu.config import RunConfig
    from radiativetransfer_tpu.constants import KPC, MYR
    from radiativetransfer_tpu.core import step as step_mod
    from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
    from radiativetransfer_tpu.tables import stellar

    n = int(os.environ.get("BENCH_N", "128"))
    level = int(os.environ.get("BENCH_LEVEL", "3"))
    n_src = int(os.environ.get("BENCH_SOURCES", "8"))
    cfg = RunConfig(mode=8, current_redshift=6.55, n_angular_level=level,
                    reionization_model=10, grid="bench")
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    model = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float32)
    ctx = step_mod.StellarContext.build(
        stellar.blackbody_population(q_ionizing=1.0e51),
        _sources(n, n_src), geom, 10.0 * MYR, metal_coefs=[(0, 0.0)])
    step = model.make_step(stellar=ctx)
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=jnp.float32)

    first, dt = _time_runs(lambda: step(state)[0], reps)
    ndir = 12 * 4 ** (level - 1)
    return {"metric": f"full mode-8 iteration ({n}^3, {ndir} directions, "
                      f"{n_src} sources, f32)",
            "value": dt, "unit": "s/iteration", "compile_s": first}


def bench_sweep(reps: int) -> dict:
    """Uniform diffuse sweep on the seeded lognormal opacity field."""
    from radiativetransfer_tpu.core import sweep

    n = int(os.environ.get("BENCH_N", "256"))
    level = int(os.environ.get("BENCH_LEVEL", "3"))
    kappa, uvb, cell = sweep_inputs(n)
    plan = sweep.build_sweep_plan(level, n)
    run = sweep.make_jitted_sweep(plan)
    first, dt = _time_runs(lambda: run(kappa, uvb, cell), reps)
    return {"metric": f"sweep cells*angles/s ({n}^3 grid, "
                      f"{plan.n_directions} directions, 3 bands, f32)",
            "value": n ** 3 * plan.n_directions / dt,
            "unit": "cells*angles/s", "seconds": dt, "compile_s": first}


def sweep_inputs(n: int, dtype=None):
    """(kappa (3, n, n, n), uvb (3,), cell size) of the sweep benchmark:
    lognormal band opacities of mean optical depth ~0.8 per cell, seed 0."""
    import jax.numpy as jnp

    from radiativetransfer_tpu.constants import KPC
    dtype = dtype or jnp.float32
    rng = np.random.default_rng(0)
    cell = (2000.0 / n) * KPC
    kappa = jnp.asarray(
        rng.lognormal(mean=0.0, sigma=1.0, size=(3, n, n, n)) * (0.5 / cell),
        dtype)
    uvb = jnp.asarray([1e-21, 5e-22, 1e-22], dtype)
    return kappa, uvb, cell


def main() -> None:
    from radiativetransfer_tpu.runtime import enable_compile_cache
    enable_compile_cache()
    device = _device_record()
    kind = os.environ.get("BENCH_KIND", "sweep")
    reps = int(os.environ.get("BENCH_REPS", "3"))
    benches = {"sweep": bench_sweep, "rays": bench_rays, "step": bench_step}
    if kind not in benches:
        raise ValueError(f"BENCH_KIND must be one of {sorted(benches)}")
    record = benches[kind](reps)
    record.update(device)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
