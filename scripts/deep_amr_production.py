"""Production-scale deep-AMR demo:

a 128^3 base grid + 3 block-sparse refined levels (effective 1024^3, the
reference's production regime: /root/reference/inputParameters:3 with deep
nesting) ingests and runs a FULL UVB transport + chemistry step within one
device's memory.  Dense per-level storage would need ~68 GB for the fields
alone; block storage keeps the state at O(leaves).

Run on the GPU:          python scripts/deep_amr_production.py
Smoke-run on CPU (tiny): python scripts/deep_amr_production.py --smoke
"""

import argparse
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def clumpy_refinement(n, L, rng, centers_frac=((0.5, 0.5, 0.5),),
                      radius_frac=0.09):
    """Clustered refinement maps: spherical clumps refined at every level,
    shrinking with depth (the shape of cosmological zoom grids)."""
    from radiativetransfer_tpu.core import amr
    refined = []
    m = n
    r_frac = radius_frac
    for _ in range(L - 1):
        r = np.zeros((m, m, m), bool)
        for c in centers_frac:
            cx, cy, cz = (np.array(c) * m).astype(int)
            rad = max(2, int(r_frac * m))
            x, y, z = np.ogrid[:m, :m, :m]
            r |= (x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2 <= rad ** 2
        refined.append(r)
        m *= 2
        r_frac *= 0.55          # deeper levels refine a shrinking core
    refined = amr.enforce_balance(refined)
    cov = np.ones((n, n, n), bool)
    for l in range(L - 1):
        refined[l] &= cov
        cov = np.repeat(np.repeat(np.repeat(refined[l], 2, 0), 2, 1), 2, 2)
    return refined


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny CPU run")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--levels", type=int, default=4)
    ap.add_argument("--angular", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--dirs-per-launch", type=int, default=4)
    ap.add_argument("--eager", action="store_true",
                    help="run the sweep+chemistry tail eagerly (one compile "
                         "per zone-group scan instead of one monolithic "
                         "jit)")
    args = ap.parse_args()

    import jax
    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from radiativetransfer_tpu.config import (MODE_UVB_TRANSFER_ONLY,
                                              RunConfig)
    from radiativetransfer_tpu.constants import KPC, MH, PSI
    from radiativetransfer_tpu.core import amr_sparse, step as step_mod, \
        step_amr
    from radiativetransfer_tpu.core.state import GridGeometry, make_state

    n = args.n or (16 if args.smoke else 128)
    L = args.levels
    nal = 1 if args.smoke else args.angular
    rng = np.random.default_rng(0)

    print(f"platform={jax.devices()[0].platform} n={n} L={L} "
          f"(effective {n * 2 ** (L - 1)}^3) angular_level={nal}")

    nh = (rng.lognormal(0, 1.0, (n, n, n)) * 2e-4).astype(np.float32)
    base = make_state(nh * MH / PSI, np.full((n, n, n), 1e4, np.float32),
                      nh, dtype=jnp.float32)
    refined = clumpy_refinement(
        n, L, rng,
        centers_frac=((0.5, 0.5, 0.5), (0.22, 0.7, 0.35)))

    t0 = time.time()
    sp = amr_sparse.make_sparse_state(base, refined, be=8)
    build_s = time.time() - t0
    leaves = sp.n_leaves()
    state_gb = sp.memory_bytes() / 1e9
    # dense-equivalent: 14 scalar fields + 3 Jmean bands, 4 bytes each
    dense_gb = sum(17 * (n * 2 ** l) ** 3 * 4 for l in range(L)) / 1e9
    print(f"built in {build_s:.1f}s: leaves={leaves:,} "
          f"blocks/level={[lv.n_blocks for lv in sp.levels]} "
          f"state={state_gb:.2f} GB (dense-equivalent {dense_gb:.1f} GB, "
          f"{dense_gb / state_gb:.0f}x)")

    cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                    n_angular_level=nal, reionization_model=10,
                    grid="deep_amr_demo")
    geom = GridGeometry(n, n, n, 1200.0 * KPC)
    rt = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float32)
    model = step_amr.SparseMLModel.setup(rt, L)
    model.max_dirs_per_launch = args.dirs_per_launch
    step = model.make_step(split_compile=args.eager)

    for i in range(args.steps):
        t0 = time.time()
        sp = step(sp)
        jax.block_until_ready(sp.base.HI)
        dt = time.time() - t0
        nf = model.neutral_fraction(sp)
        tag = "compile+step" if i == 0 else "step"
        print(f"iter {i + 1}: {tag} {dt:.1f}s  neutral={nf:.6f}")
    print("OK")


if __name__ == "__main__":
    main()
