"""Smoke test of the main path on an NVIDIA GPU, at real sizes.

    python chip_smoke.py           phases 1-5 on one card
    python chip_smoke.py --four    the four-card path and its one-card
                                   reference only (needs four cards)
    python chip_smoke.py --tiny    rehearsal at toy sizes; runs on the CPU
                                   too and never prints the result line

Phases of the default run, all in this one process:
  1 environment: the card's name and power limit, JAX's devices, the
    compile-cache directory; stops unless JAX's backend is a GPU
  2 uniform sweep (core.sweep) 256^3 x 192 directions x 3 bands on the
    bench's seeded lognormal opacity, f32 against f64 on the card
  3 point-source tracer (core.rays) 128^3, 8 sources, maxPixelLevel 6,
    quadrature rates, f32 against f64 on the card
  4 uniform mode-8 CLI run (cli.main): 128^3, 8 sources, 192 directions,
    3 iterations, f32 against --x64
  5 block-sparse mode-8 CLI run: 128^3 + 3 refined levels, 8 sources,
    12 directions, 2 iterations; first-iteration (set-up + compile) and
    step times, peak device memory

--four runs phase 5's grid through the CLI on one card and then on four
(--mesh-shape 4 and --mesh-shape 2,2), and the uniform pipelined and
zones sweeps (parallel.sweep_dist) at 256^3 against the one-device sweep.

Each phase prints its results on lines of its own; a failed phase prints
its traceback and the script exits 1 after the remaining phases.  The
last line of standard output, printed only when every phase passed on a
GPU, is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Stated tolerances, f32 on the card against f64 on the card (or four
# cards against one).  Each is compared with the largest relative error
# over the "significant" cells, those above 1e-3 of the field's maximum.
# Rate deposits and the distributed psums are sums taken in an order that
# differs between runs (atomics, collectives), so none of these compares
# bit patterns.
SWEEP_RTOL = 1e-4       # expected ~1e-5: f32 rounding along 256-slab chains
TRACER_RTOL = 1e-3      # f32 optical depths summed over ~1e3 segments
NEUTRAL_RTOL = 1e-4     # neutral fraction after each CLI iteration
HI_RTOL = 1e-2          # per-cell HI of the last snapshot
SWEEP_DIST_RTOL = 1e-5  # four devices against one: same dtype, other order
DIST_RTOL = 1e-4        # the same, carried through two chemistry solves


@dataclasses.dataclass(frozen=True)
class Sizes:
    sweep_n: int = 256
    sweep_level: int = 3
    tracer_n: int = 128
    n_sources: int = 8
    pixel_level: int = 6
    uniform_n: int = 128
    uniform_level: int = 3
    uniform_iters: int = 3
    sparse_n: int = 128
    sparse_levels: int = 4
    sparse_level: int = 1
    sparse_iters: int = 2


    # the CLI picks block-sparse storage itself at the real size only
    sparse_flags: tuple[str, ...] = ()


TINY = Sizes(sweep_n=16, sweep_level=2, tracer_n=16, n_sources=3,
             pixel_level=3, uniform_n=16, uniform_level=1, sparse_n=16,
             sparse_levels=3, sparse_flags=("--amr-storage", "sparse"))

PHASES = ("sweep", "tracer", "uniform_cli", "sparse_cli")
FOUR_PHASES = ("four_card",)


def select_phases(four: bool) -> tuple[str, ...]:
    """The compute phases a run makes after the environment phase."""
    return FOUR_PHASES if four else PHASES


def card_line() -> str:
    """`nvidia-smi` name and power limit of each card (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def require_gpu(devices, allow_cpu: bool = False) -> None:
    """Raise unless JAX's first device is a GPU (or, for a rehearsal,
    a CPU)."""
    platform = devices[0].platform
    if platform == "gpu" or (allow_cpu and platform == "cpu"):
        return
    raise RuntimeError(f"JAX found no GPU (backend {platform!r}); this "
                       "smoke test never falls back to the CPU")


def significant_rel_err(a, ref, floor: float = 1e-3) -> float:
    """Largest |a - ref| / |ref| over cells with |ref| > floor * max|ref|."""
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.max(np.abs(ref))
    if not np.all(np.isfinite(a)):
        return float("inf")
    if scale == 0.0:
        return float(np.max(np.abs(a)))
    mask = np.abs(ref) > floor * scale
    return float(np.max(np.abs(a - ref)[mask] / np.abs(ref)[mask]))


def check(name: str, value: float, tol: float) -> None:
    status = "ok" if value <= tol else "FAIL"
    print(f"  {name}: {value:.3e} (tolerance {tol:.0e}) {status}",
          flush=True)
    if value > tol:
        raise AssertionError(f"{name} {value:.3e} exceeds {tol:.0e}")


def peak_bytes() -> int | None:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


class _Tee(io.TextIOBase):
    """Echo writes to the real stdout and keep a timestamped copy."""

    def __init__(self, out):
        self.out = out
        self.buf = io.StringIO()
        self.stamps = []           # (perf_counter, text) per write

    def write(self, s):
        self.buf.write(s)
        self.stamps.append((time.perf_counter(), s))
        return self.out.write(s)

    def seconds_until(self, t0: float, marker: str) -> float | None:
        """Seconds from t0 until the first write containing marker."""
        return next((t - t0 for t, s in self.stamps if marker in s), None)

    def flush(self):
        self.out.flush()


def run_cli(argv: list[str]) -> dict:
    """Run cli.main(argv) in this process; return the neutral fractions,
    per-iteration times and coupling depth it printed, and when its set-up
    steps ended (seconds after the call)."""
    from radiativetransfer_tpu import cli
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        cli.main(argv)
    text = tee.buf.getvalue()
    iters = re.findall(r"itime=(\d+) neutral=([0-9.eE+-]+) dt=([0-9.]+)s",
                       text)
    eq = re.search(r"ionization equilibrium: ([0-9.eE+-]+)", text)
    depth = re.search(r"coupling depth: (\d+)", text)
    return {"nf0": float(eq.group(1)) if eq else None,
            "nf": [float(x[1]) for x in iters],
            "dt": [float(x[2]) for x in iters],
            "depth": int(depth.group(1)) if depth else None,
            "ingested_s": tee.seconds_until(t0, "box ="),
            "validated_s": tee.seconds_until(t0, "coupling depth"),
            "ready_s": tee.seconds_until(t0, "ionization equilibrium")}


def make_grid(out: str, n: int, levels: int) -> str:
    """scripts/make_production_grid.py into `out`; returns its config."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import make_production_grid
    make_production_grid.main(["--out", out, "--n", str(n),
                               "--levels", str(levels)])
    return os.path.join(out, "inputParameters")


def last_hi(snap_dir: str) -> np.ndarray:
    from radiativetransfer_tpu.io import snapshot
    with np.load(snapshot.latest_snapshot(snap_dir)) as f:
        return f["HI"]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_sweep(sz: Sizes, card: str, tmp: str) -> None:
    import jax
    import jax.numpy as jnp

    from bench import sweep_inputs
    from radiativetransfer_tpu.core import sweep

    n = sz.sweep_n
    plan = sweep.build_sweep_plan(sz.sweep_level, n)
    run = sweep.make_jitted_sweep(plan)
    kappa, uvb, cell = sweep_inputs(n, jnp.float32)
    t0 = time.perf_counter()
    j32 = jax.block_until_ready(run(kappa, uvb, cell))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    j32 = jax.block_until_ready(run(kappa, uvb, cell))
    warm_s = time.perf_counter() - t0
    print(f"  f32 sweep {n}^3 x {plan.n_directions} dirs x 3 bands: "
          f"first call {compile_s:.2f} s, warm {warm_s:.4f} s "
          f"({n ** 3 * plan.n_directions / warm_s:.3e} cells*angles/s) "
          f"on {card}", flush=True)
    with jax.enable_x64(True):
        k64, u64, _ = sweep_inputs(n, jnp.float64)
        j64 = np.asarray(run(k64, u64, cell))
    check("sweep f32 vs f64 max rel err (J > 1e-3 max J)",
          significant_rel_err(j32, j64), SWEEP_RTOL)


def _tracer_inputs(n: int, n_src: int, dtype):
    """Lognormal ionized gas (x_HI = 1e-3, x_HeI = 1e-2, x_HeII = 0.1)
    around sources near the center: optical depths span the full range up
    to the kill depth, and every rate channel stays well above the f32
    subnormal range."""
    import jax.numpy as jnp

    from radiativetransfer_tpu.constants import KPC, MH, MHE, MYR, PSI
    from radiativetransfer_tpu.core import rays, step as step_mod
    from radiativetransfer_tpu.core.state import GridGeometry, make_state
    from radiativetransfer_tpu.tables import stellar

    rng = np.random.default_rng(1)
    nh = 2e-4 * rng.lognormal(0.0, 1.0, (n, n, n))
    rho = nh * MH / PSI
    nhe = (1.0 - PSI) * rho / MHE
    state = make_state(rho, np.full(nh.shape, 1.5e4), 1e-3 * nh,
                       HeI=1e-2 * nhe, HeII=0.1 * nhe, dtype=dtype)
    # the bench's 15.6 kpc cells at every n: the per-volume heating
    # weights of bigger cells reach the f32 subnormal range
    geom = GridGeometry(n, n, n, 2000.0 * KPC * n / 128)
    pos = (np.floor(rng.uniform(0.35, 0.65, (n_src, 3)) * n) + 0.5) / n
    batch = rays.SourceBatch(position=pos, weight=np.ones(n_src),
                             table_idx=np.zeros(n_src, np.int32))
    ctx = step_mod.StellarContext.build(
        stellar.blackbody_population(q_ionizing=1.0e51), batch, geom,
        10.0 * MYR, metal_coefs=[(0, 0.0)])
    return state, geom, ctx


def phase_tracer(sz: Sizes, card: str, tmp: str) -> None:
    import jax
    import jax.numpy as jnp

    from radiativetransfer_tpu.core import rays

    def trace(dtype):
        state, geom, ctx = _tracer_inputs(sz.tracer_n, sz.n_sources, dtype)
        t0 = time.perf_counter()
        rf, _ = rays.trace_point_sources(
            state, geom, ctx.sources, ctx.tables,
            max_pixel_level=sz.pixel_level, dtype=dtype,
            rates_mode="quadrature")
        rf = jax.block_until_ready(rf)
        return rf, time.perf_counter() - t0

    rf32, first = trace(jnp.float32)
    rf32, warm = trace(jnp.float32)
    print(f"  f32 tracer {sz.tracer_n}^3, {sz.n_sources} sources, "
          f"maxPixelLevel {sz.pixel_level}: first call {first:.2f} s, "
          f"warm {warm:.3f} s on {card}", flush=True)
    with jax.enable_x64(True):
        rf64, _ = trace(jnp.float64)
        rf64 = {k: np.asarray(v) for k, v in vars(rf64).items()}
    for name, ref in rf64.items():
        check(f"{name} f32 vs f64 max rel err (> 1e-3 max)",
              significant_rel_err(getattr(rf32, name), ref), TRACER_RTOL)


def phase_uniform_cli(sz: Sizes, card: str, tmp: str) -> None:
    import jax

    cfg = make_grid(os.path.join(tmp, "uniform"), sz.uniform_n, 1)
    argv = [cfg, "--iters", str(sz.uniform_iters),
            "--angular-level", str(sz.uniform_level)]
    d32, d64 = os.path.join(tmp, "u32"), os.path.join(tmp, "u64")
    os.makedirs(d32)
    os.makedirs(d64)
    r32 = run_cli(argv + ["--snapshot-dir", d32])
    try:
        r64 = run_cli(argv + ["--snapshot-dir", d64, "--x64"])
    finally:
        jax.config.update("jax_enable_x64", False)
    nf = [r32["nf0"]] + r32["nf"]
    print(f"  f32 neutral fraction by iteration: {nf}; iteration times "
          f"{r32['dt']} s on {card}", flush=True)
    if len(r32["nf"]) != sz.uniform_iters or not np.all(np.isfinite(nf)):
        raise AssertionError(f"bad neutral fractions {nf}")
    steps = np.abs(np.diff(nf))
    if not np.all(steps[1:] <= steps[:-1]):
        raise AssertionError(f"neutral fraction does not settle: {nf}")
    check("neutral fraction f32 vs f64 max rel err",
          significant_rel_err(r32["nf"], r64["nf"], floor=0.0), NEUTRAL_RTOL)
    check("last-snapshot HI f32 vs f64 max rel err (> 1e-3 max)",
          significant_rel_err(last_hi(d32), last_hi(d64)), HI_RTOL)


def phase_sparse_cli(sz: Sizes, card: str, tmp: str) -> None:
    cfg = make_grid(os.path.join(tmp, "sparse"), sz.sparse_n,
                    sz.sparse_levels)
    snap = os.path.join(tmp, "s1")
    os.makedirs(snap)
    r = run_cli([cfg, "--iters", str(sz.sparse_iters), "--angular-level",
                 str(sz.sparse_level), "--snapshot-dir", snap,
                 *sz.sparse_flags])
    nf = [r["nf0"]] + r["nf"]
    if len(r["nf"]) != sz.sparse_iters or not np.all(np.isfinite(nf)) \
            or not all(0.0 < x < 1.0 for x in nf):
        raise AssertionError(f"bad neutral fractions {nf}")
    print(f"  sparse mode-8, {12 * 4 ** (sz.sparse_level - 1)} directions:"
          f" set-up (first iteration, compile included) {r['dt'][0]:.2f} s,"
          f" step {r['dt'][-1]:.2f} s, neutral fraction {nf}, "
          f"peak_bytes_in_use {peak_bytes()} (process peak so far) "
          f"on {card}", flush=True)
    print(f"  sparse set-up before the first iteration: grid ingested at "
          f"{r['ingested_s']:.2f} s, coupling depth {r['depth']} validated "
          f"at {r['validated_s']:.2f} s, equilibrium ready at "
          f"{r['ready_s']:.2f} s", flush=True)


def phase_four_card(sz: Sizes, card: str, tmp: str) -> None:
    import jax
    import jax.numpy as jnp

    from bench import sweep_inputs
    from radiativetransfer_tpu.core import sweep
    from radiativetransfer_tpu.parallel import mesh as pmesh
    from radiativetransfer_tpu.parallel import sweep_dist

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 devices, found "
                           f"{len(jax.devices())}")
    # uniform explicit strategies against the one-device sweep
    n = sz.sweep_n
    plan = sweep.build_sweep_plan(sz.sweep_level, n)
    kappa, uvb, cell = sweep_inputs(n, jnp.float32)
    j_ref = np.asarray(sweep.make_jitted_sweep(plan)(kappa, uvb, cell))
    mesh = pmesh.make_grid_mesh(4)
    kappa_sh = jax.device_put(kappa, pmesh.band_field_sharding(mesh))
    for strategy in ("pipelined", "zones"):
        run = sweep_dist.make_jitted_sweep_dist(plan, mesh, strategy)
        jax.block_until_ready(run(kappa_sh, uvb, cell))
        t0 = time.perf_counter()
        j = jax.block_until_ready(run(kappa_sh, uvb, cell))
        dt = time.perf_counter() - t0
        print(f"  {strategy} sweep {n}^3 x {plan.n_directions} dirs on 4 "
              f"devices: warm {dt:.4f} s on {card}", flush=True)
        check(f"{strategy} vs one-device sweep max rel err (> 1e-3 max)",
              significant_rel_err(j, j_ref), SWEEP_DIST_RTOL)

    # the block-sparse production grid, one card against four
    cfg = make_grid(os.path.join(tmp, "sparse"), sz.sparse_n,
                    sz.sparse_levels)
    base = [cfg, "--iters", str(sz.sparse_iters), "--angular-level",
            str(sz.sparse_level), *sz.sparse_flags]
    runs = {}
    for label, extra in (("1 card", []), ("mesh 4", ["--mesh-shape", "4"]),
                         ("mesh 2,2", ["--mesh-shape", "2,2"])):
        snap = os.path.join(tmp, label.replace(" ", "_").replace(",", "x"))
        os.makedirs(snap)
        if runs:   # reuse the depth the one-card run validated
            extra = extra + ["--coupling-depth",
                             str(runs["1 card"]["depth"])]
        r = run_cli(base + extra + ["--snapshot-dir", snap])
        r["hi"] = last_hi(snap)
        runs[label] = r
        print(f"  sparse {label}: ready after {r['ready_s']:.2f} s, first "
              f"iteration {r['dt'][0]:.2f} s, step {r['dt'][-1]:.2f} s, "
              f"neutral fraction {r['nf']} on {card}", flush=True)
    ref = runs["1 card"]
    for label in ("mesh 4", "mesh 2,2"):
        check(f"sparse {label} vs 1 card neutral fraction max rel err",
              significant_rel_err(runs[label]["nf"], ref["nf"], floor=0.0),
              DIST_RTOL)
        check(f"sparse {label} vs 1 card last-snapshot HI max rel err "
              "(> 1e-3 max)",
              significant_rel_err(runs[label]["hi"], ref["hi"]), DIST_RTOL)


PHASE_FUNCS = {"sweep": phase_sweep, "tracer": phase_tracer,
               "uniform_cli": phase_uniform_cli,
               "sparse_cli": phase_sparse_cli,
               "four_card": phase_four_card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its reference")
    ap.add_argument("--tiny", action="store_true",
                    help="toy-size rehearsal (CPU allowed, no result line)")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)

    print("phase 1: environment", flush=True)
    card = card_line()
    print(f"  nvidia-smi: {card}", flush=True)
    card = card.replace("\n", "; ")
    import jax

    from radiativetransfer_tpu.runtime import enable_compile_cache
    cache = enable_compile_cache()
    devices = jax.devices()
    print(f"  jax {jax.__version__}, devices {devices}, device_kind "
          f"{devices[0].device_kind!r}, compile cache {cache}", flush=True)
    require_gpu(devices, allow_cpu=args.tiny)

    sizes = TINY if args.tiny else Sizes()
    failed = []
    for i, name in enumerate(select_phases(args.four), start=2):
        print(f"phase {i}: {name}", flush=True)
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                PHASE_FUNCS[name](sizes, card, tmp)
        except Exception:   # report every phase, then fail the run
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
        print(f"  phase {name}: {time.perf_counter() - t0:.1f} s, "
              f"{'FAILED' if name in failed else 'passed'}", flush=True)
    if failed:
        print(f"failed phases: {failed}", flush=True)
        return 1
    if args.tiny:
        print("rehearsal passed (no result line at toy sizes)")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
