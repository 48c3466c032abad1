"""Per-collective breakdown of the distributed sweeps.

What the structure of the schedules fixes, before any multi-card timing:

1. EXACT collective accounting from the sweep plan: how many ppermute
   calls and how many bytes cross a shard face per full sweep for the
   pipelined (grid-decomposed) strategy.  These are trace-time statics —
   counted from the plan's chain tables, no model assumptions.
2. Measured cost isolation on the virtual CPU mesh: pipelined vs
   pipelined-with-no-halo (ppermute replaced by a local boundary feed —
   identical op count minus the collectives) vs the zones strategy
   (replicated fields, one psum).
3. The production-shape counts: halo bytes and calls of the pipelined
   schedule at 256^3 x 192 directions, the zones schedule's load-balance
   bound (ceil(24/P)/(24/P)) and psum payload, and the sparse zones
   schedule's psum count and payload at 128^3 + 3 levels.  A time
   prediction needs measured NVLink numbers from the card.

Run:  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python scripts/dist_sweep_breakdown.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

if jax.default_backend() != "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import sweep
from radiativetransfer_tpu.geometry.patterns import SEG_NONE
from radiativetransfer_tpu.parallel import mesh as pmesh, sweep_dist

N = int(os.environ.get("EXP_N", "48"))
LEVEL = int(os.environ.get("EXP_LEVEL", "2"))
REPS = 3


def timeit(fn, *args):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def halo_accounting(plan, n, itemsize=4):
    """Exact ppermute count/bytes per full pipelined sweep on a 1-D mesh.

    Per zone, per slab, each chain segment routed through the sharded
    yz shift exchanges one (ndir, 3, ny, 1) boundary line.  The chain
    tables are static, so this is exact, not estimated."""
    calls = 0
    bytes_total = 0
    for zone in plan.zones:
        # segment 1 never shifts; segments 2/3 shift yz unless chain==XZ
        from radiativetransfer_tpu.geometry.patterns import SEG_XZ
        for chain in (zone.chain2, zone.chain3):
            yz = (np.asarray(chain) != SEG_NONE) & (np.asarray(chain)
                                                    != SEG_XZ)
            # one ppermute per (slab) covering all dirs of the zone; the
            # exchanged line is (ndir, 3, ny, 1)
            nslab_with = int(yz.any(axis=0).sum())
            calls += nslab_with
            bytes_total += nslab_with * zone.ndir * 3 * n * itemsize
    return calls, bytes_total


def main():
    n = N
    plan = sweep.build_sweep_plan(LEVEL, n)
    ndir = plan.n_directions
    cell = 2000.0 * KPC / n
    rng = np.random.default_rng(0)
    kappa = jnp.asarray(rng.lognormal(0, 1, (3, n, n, n)) * 0.5 / cell,
                        jnp.float32)
    uvb = jnp.asarray([1e-21, 3e-22, 1e-22], jnp.float32)
    mesh = pmesh.make_grid_mesh(8)
    n_dev = 8

    calls, halo_bytes = halo_accounting(plan, n)
    print(f"grid {n}^3, {ndir} dirs, 8 virtual devices")
    print(f"pipelined halo accounting (exact, per full sweep, per shard "
          f"face): {calls} ppermute calls, {halo_bytes / 1e6:.2f} MB")

    kappa_sh = jax.device_put(kappa, pmesh.band_field_sharding(mesh))
    run_p = jax.jit(lambda k: sweep_dist.diffuse_sweep_pipelined(
        k, plan, uvb, cell, mesh))
    run_nh = jax.jit(lambda k: sweep_dist.diffuse_sweep_pipelined(
        k, plan, uvb, cell, mesh, no_halo=True))
    run_z = jax.jit(lambda k: sweep_dist.diffuse_sweep_zone_parallel(
        k, plan, uvb, cell, mesh))
    run_1 = jax.jit(lambda k: sweep.diffuse_sweep(k, plan, uvb, cell))

    t1 = timeit(run_1, kappa)
    tp = timeit(run_p, kappa_sh)
    tnh = timeit(run_nh, kappa_sh)
    tz = timeit(run_z, kappa)
    print(f"single-device sweep        : {t1 * 1e3:8.1f} ms")
    print(f"pipelined (halo exchange)  : {tp * 1e3:8.1f} ms")
    print(f"pipelined (no_halo)        : {tnh * 1e3:8.1f} ms   -> "
          f"collectives = {(tp - tnh) * 1e3:.1f} ms "
          f"({100 * (tp - tnh) / tp:.0f}% of pipelined time on the "
          f"shared-socket virtual mesh)")
    print(f"zones (replicated + psum)  : {tz * 1e3:8.1f} ms")

    # exact counts at production scale (256^3 x 192 dirs)
    import math
    plan256 = sweep.build_sweep_plan(3, 256)
    calls256, bytes256 = halo_accounting(plan256, 256)
    print()
    print("production shape (256^3 x 192 dirs):")
    print(f"  pipelined halo traffic {bytes256 / 1e6:.1f} MB in "
          f"{calls256} ppermute calls per shard face")
    for p in (2, 4, 8):
        zeff = (24 / p) / math.ceil(24 / p)
        print(f"  zones strategy at {p} devices: load-balance bound "
              f"{100 * zeff:.0f}% + one (3,256^3) psum "
              f"({3 * 256 ** 3 * 4 / 1e6:.0f} MB)")

    sparse_zones_accounting()


def sparse_zones_accounting():
    """Exact collective accounting for the SPARSE zones schedule at the
    production shape (the angle-decomposed deep-AMR sweep over devices).  Per direction-chunk group the runner issues ONE
    psum of the accumulators: j0 (3, n^3) + per-level J blocks
    (3, nb_l, be^3); chunk counts come from the same chunking
    diffuse_sweep_sparse uses, block counts from the production
    refinement geometry itself."""
    import math

    sys.path.insert(0, os.path.dirname(__file__))
    from deep_amr_production import clumpy_refinement

    n, L, be = 128, 4, 8
    refined = clumpy_refinement(
        n, L, np.random.default_rng(0),
        centers_frac=((0.5, 0.5, 0.5), (0.22, 0.7, 0.35)))
    # occupied tiles of level l (be^3 level-l cells = (be/2)^3 parents):
    # any refined parent in the tile -> block exists (+1 padding block)
    nbs = []
    for ell in range(1, L):
        r = np.asarray(refined[ell - 1], bool)
        t = be // 2
        m = r.shape[0] // t
        occ = r.reshape(m, t, m, t, m, t).any(axis=(1, 3, 5))
        nbs.append(int(occ.sum()) + 1)

    from radiativetransfer_tpu.core import sweep_multilevel, sweep_sparse
    plan = sweep_multilevel.build_ml_sweep_plan(3, n, L)   # 192 dirs
    groups = sweep_sparse.build_chunks(plan, max_dirs_per_launch=4)
    n_chunks = sum(len(v) for v in groups.values())
    acc_bytes = 4 * (3 * n ** 3
                     + sum(3 * nb * be ** 3 for nb in nbs))
    print()
    print(f"sparse zones schedule (production 128^3 + {L - 1} levels, "
          f"192 dirs, be={be}; blocks/level = {nbs}):")
    print(f"  {n_chunks} direction chunks in {len(groups)} size groups; "
          f"accumulator psum payload {acc_bytes / 1e6:.1f} MB")
    for p in (2, 4, 8):
        # non-eager: one psum per size group; eager: one per round
        rounds = sum(math.ceil(len(v) / p) for v in groups.values())
        psums = len(groups)
        bal = n_chunks / p / rounds
        print(f"  {p} devices: {psums} psums of "
              f"{acc_bytes / 1e6:.1f} MB per sweep, chunk load balance "
              f"{100 * bal:.0f}% ({rounds} rounds; eager adds "
              f"{rounds - psums} psums)")


if __name__ == "__main__":
    main()
