"""Multi-device scaling measurement of the sharded transport+chemistry step.

Runs the full UVB-transfer step on an N-device mesh for N in {1,2,4,8} and
reports throughput + efficiency.  On GPUs the collectives run over NCCL;
on the CPU it runs on 8 virtual devices (__graft_entry__.dryrun_multichip
validates the multi-device path the same way).

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python examples/scaling_bench.py [n]
"""

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from radiativetransfer_tpu.config import MODE_UVB_TRANSFER_ONLY, RunConfig
from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import step as step_mod
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu.parallel import mesh as pmesh


from radiativetransfer_tpu.core import opacity, sweep
from radiativetransfer_tpu.parallel import sweep_dist


def bench_full_step(model, state0, n, cfg, results):
    """GSPMD auto-sharded full transport+chemistry step."""
    for nd in (1, 2, 4, 8):
        if nd > len(jax.devices()):
            break
        mesh = pmesh.make_grid_mesh(nd)
        state = pmesh.shard_state(state0, mesh)
        step = jax.jit(model.transport_chemistry_step)
        out = step(state)
        jax.block_until_ready(out.HI)  # compile + run
        t0 = time.perf_counter()
        reps = 2
        for _ in range(reps):
            out = step(state)
            jax.block_until_ready(out.HI)
        dt = (time.perf_counter() - t0) / reps
        thr = n ** 3 * cfg.n_directions / dt
        results[f"gspmd/{nd}"] = thr
        eff = thr / (results["gspmd/1"] * nd)
        print(f"gspmd      devices={nd}  dt={dt:.3f}s  "
              f"{thr:.3e} cells*angles/s  efficiency={eff:.2f}")


def bench_explicit_sweeps(model, state0, n, cfg, results):
    """Explicit shard_map sweeps (sweep only, both strategies)."""
    kappa = opacity.compute_opacities(state0.HI, state0.HeI, state0.HeII,
                                      model.opacity_coef)
    uvb = jnp.asarray(model.uvb, kappa.dtype)
    cell = model.geom.cell_size
    base = None
    for strategy in ("pipelined", "zones"):
        for nd in (1, 2, 4, 8):
            if nd > len(jax.devices()):
                break
            mesh = pmesh.make_grid_mesh(nd)
            k_in = (jax.device_put(kappa, pmesh.band_field_sharding(mesh))
                    if strategy == "pipelined" else kappa)
            run = sweep_dist.make_jitted_sweep_dist(model.sweep_plan, mesh,
                                                    strategy)
            jax.block_until_ready(run(k_in, uvb, cell))
            t0 = time.perf_counter()
            reps = 2
            for _ in range(reps):
                jax.block_until_ready(run(k_in, uvb, cell))
            dt = (time.perf_counter() - t0) / reps
            thr = n ** 3 * cfg.n_directions / dt
            results[f"{strategy}/{nd}"] = thr
            if nd == 1:
                base = thr
            eff = thr / (base * nd)
            print(f"{strategy:<10} devices={nd}  dt={dt:.3f}s  "
                  f"{thr:.3e} cells*angles/s  efficiency={eff:.2f}")


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 48
    cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                    n_angular_level=2, reionization_model=10, grid="scal")
    geom = GridGeometry(n, n, n, 500.0 * KPC)
    model = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float32)
    state0 = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float32)

    results = {}
    bench_full_step(model, state0, n, cfg, results)
    bench_explicit_sweeps(model, state0, n, cfg, results)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
