"""Explicit distributed diffuse sweeps (shard_map + collectives).

The reference is serial (SURVEY.md §5.8); `core.sweep` already runs sharded
under GSPMD auto-partitioning (tests/test_parallel.py), but the collective
schedule is then up to the compiler.  This module provides the two explicit
distribution strategies with hand-placed collectives:

1. `diffuse_sweep_pipelined` — **grid decomposition**.  The field keeps its
   NamedSharding on one grid axis; for every octant zone the rotated opacity
   is re-sharded onto the rotated *last* in-plane axis (an all-to-all XLA
   inserts at the sharding constraint), so the slab scan advances in lockstep
   on all devices and only the in-slab upwind `yz` shift crosses the shard
   boundary: one boundary *line* (ndir, 3, ny, 1) per chain segment per slab
   is exchanged with `jax.lax.ppermute` (NCCL over NVLink on the GPU).  There is no pipeline
   bubble — the scan axis is never sharded.  This is the halo-exchange
   pipeline of SURVEY.md §7.3 ("cross-device, the x-decomposed pipeline must
   overlap slabs with halo sends").

2. `diffuse_sweep_zone_parallel` — **angle decomposition** (the DP analog,
   SURVEY.md §2 "Angle/frequency batching").  The opacity field is
   replicated; the 24 octant zones are dealt round-robin to the devices
   (`lax.switch` on the device index), each device sweeps only its zones
   over the full grid, and the per-zone mean-intensity contributions are
   `psum`-reduced.  No per-slab communication at all — the right choice
   whenever the grid fits in one device's HBM.

Both match the single-device `core.sweep.diffuse_sweep` to float roundoff
(tests/test_parallel.py::TestExplicitDistributedSweep).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import sweep as core_sweep
from ..core.sweep import SweepPlan, ZoneBatch, _attenuate, _shift_j
from ..geometry import octants
from ..geometry.patterns import SEG_XZ


def _zone_params(zone: ZoneBatch, dtype):
    """Per-slab parameter pytree in scan layout (nslab, ndir)."""
    return {
        "len_xy": jnp.asarray(zone.len_xy.T, dtype),
        "len_xz": jnp.asarray(zone.len_xz.T, dtype),
        "len_yz": jnp.asarray(zone.len_yz.T, dtype),
        "chain2": jnp.asarray(zone.chain2.T),
        "chain3": jnp.asarray(zone.chain3.T),
        "n_active": jnp.asarray(zone.n_active.T, dtype),
    }


# --------------------------------------------------------------------------
# strategy 1: grid decomposition with per-slab ppermute halo lines
# --------------------------------------------------------------------------

def _sweep_zone_halo(kappa_rot, params, uvb, cell_size, weight,
                     axis_name: str, n_shards: int,
                     axis_name_j: str | None = None, n_shards_j: int = 1,
                     no_halo: bool = False):
    """One zone's slab scan on a local (nslab, 3, ny[/Pj], nz/Pk) block.

    Identical arithmetic to core.sweep.sweep_zone; the only difference is
    that the upwind in-plane shifts source their first line from the
    left-neighbor device via ppermute instead of a local slice, and only
    shard 0 of each sharded axis applies the UVB boundary.  With a 1-D mesh
    only the `yz` shift (array axis -1) is remote; on a 2-D mesh the `xz`
    shift (array axis -2, axis_name_j) exchanges its own boundary line too
    — the scan axis is never sharded either way, so the slab pipeline
    stays bubble-free (SURVEY.md §7.3, VERDICT r2 missing-6).
    """
    nslab, nb, ny, nz_loc = kappa_rot.shape
    ndir = params["len_xy"].shape[1]
    dtype = kappa_rot.dtype
    uvb = uvb.astype(dtype)
    idx = jax.lax.axis_index(axis_name)
    perm = [(i, i + 1) for i in range(n_shards - 1)]

    uvb_cell = uvb[None, :, None, None]
    i_top0 = jnp.broadcast_to(uvb_cell, (ndir, nb, ny, nz_loc)).astype(dtype)
    uvb_j = jnp.broadcast_to(uvb_cell, (ndir, nb, 1, nz_loc))
    uvb_k = jnp.broadcast_to(uvb_cell, (ndir, nb, ny, 1))

    def shift_k_halo(x):
        # upwind line from the left neighbor's last k-column, computed in the
        # same lockstep slab iteration; shard 0 takes the domain boundary.
        # no_halo (diagnostics only): drop the exchange and feed the UVB
        # boundary — measures the collective's cost share in isolation
        # (results are WRONG at interior shard faces)
        if no_halo:
            return jnp.concatenate([uvb_k, x[..., :-1]], axis=-1)
        halo = jax.lax.ppermute(x[..., -1:], axis_name, perm)
        first = jnp.where(idx == 0, uvb_k, halo)
        return jnp.concatenate([first, x[..., :-1]], axis=-1)

    if axis_name_j is None:
        shift_j_halo = lambda x: _shift_j(x, uvb_j)
    else:
        idx_j = jax.lax.axis_index(axis_name_j)
        perm_j = [(i, i + 1) for i in range(n_shards_j - 1)]

        def shift_j_halo(x):
            if no_halo:
                return jnp.concatenate([uvb_j, x[..., :-1, :]], axis=-2)
            halo = jax.lax.ppermute(x[..., -1:, :], axis_name_j, perm_j)
            first = jnp.where(idx_j == 0, uvb_j, halo)
            return jnp.concatenate([first, x[..., :-1, :]], axis=-2)

    xs = dict(params)
    xs["kappa"] = kappa_rot

    def slab_step(i_top, x):
        kappa = x["kappa"][None]

        def seg_tau(length):
            return kappa * (length * cell_size)[:, None, None, None]

        i_out1, lm1 = _attenuate(i_top, seg_tau(x["len_xy"]))

        is2_xz = (x["chain2"] == SEG_XZ)[:, None, None, None]
        act2 = (x["chain2"] != 0)[:, None, None, None]
        i_in2 = jnp.where(is2_xz, shift_j_halo(i_out1), shift_k_halo(i_out1))
        len2 = jnp.where(x["chain2"] == SEG_XZ, x["len_xz"], x["len_yz"])
        i_out2, lm2 = _attenuate(i_in2, seg_tau(len2))

        is3_xz = (x["chain3"] == SEG_XZ)[:, None, None, None]
        act3 = (x["chain3"] != 0)[:, None, None, None]
        i_in3 = jnp.where(is3_xz, shift_j_halo(i_out2), shift_k_halo(i_out2))
        len3 = jnp.where(x["chain3"] == SEG_XZ, x["len_xz"], x["len_yz"])
        i_out3, lm3 = _attenuate(i_in3, seg_tau(len3))

        n_act = x["n_active"][:, None, None, None]
        j_slab = (lm1 + jnp.where(act2, lm2, 0.0)
                  + jnp.where(act3, lm3, 0.0)) / n_act
        j_contrib = weight * jnp.sum(j_slab, axis=0)

        i_top_next = jnp.where(n_act == 3, i_out3,
                               jnp.where(n_act == 2, i_out2, i_out1))
        return i_top_next, j_contrib

    _, j_rot = jax.lax.scan(slab_step, i_top0, xs)
    return j_rot


def diffuse_sweep_pipelined(kappa, plan: SweepPlan, uvb, cell_size,
                            mesh: Mesh, no_halo: bool = False) -> jax.Array:
    """Grid-decomposed sweep with explicit per-slab ppermute halo lines.

    Args match core.sweep.diffuse_sweep; `kappa` is (3, nx, ny, nz), sharded
    (or shardable) over `mesh`'s first axis.  Returns Jmean (3, nx, ny, nz)
    sharded on the last grid axis.
    """
    axes = mesh.axis_names
    if len(axes) > 2:
        raise ValueError("pipelined strategy supports 1-D and 2-D meshes "
                         "(the scan axis must stay unsharded)")
    axis = axes[-1]
    n_shards = mesh.devices.shape[-1]
    axis_j = axes[0] if len(axes) == 2 else None
    n_shards_j = mesh.devices.shape[0] if len(axes) == 2 else 1
    uvb = jnp.asarray(uvb, kappa.dtype)
    kappa_l = jnp.moveaxis(kappa, 0, -1)                  # (nx,ny,nz,3)
    grid_spec = (P(None, axis_j, axis, None) if axis_j
                 else P(None, None, axis, None))
    jmean = jax.lax.with_sharding_constraint(
        jnp.zeros_like(kappa_l), NamedSharding(mesh, grid_spec))
    plane_spec = (P(None, None, axis_j, axis) if axis_j
                  else P(None, None, None, axis))

    for zone in plan.zones:
        krot = octants.rotate_to_sweep(kappa_l, zone.izone)
        krot = jnp.moveaxis(krot, -1, 1)                  # (nslab,3,ny,nz)
        # re-shard onto the rotated in-plane axes: the scan axis is never
        # sharded, so the slab pipeline runs bubble-free in lockstep
        krot = jax.lax.with_sharding_constraint(
            krot, NamedSharding(mesh, plane_spec))
        params = _zone_params(zone, kappa.dtype)
        kernel = jax.shard_map(
            partial(_sweep_zone_halo, uvb=uvb, cell_size=cell_size,
                    weight=plan.weight, axis_name=axis, n_shards=n_shards,
                    axis_name_j=axis_j, n_shards_j=n_shards_j,
                    no_halo=no_halo),
            mesh=mesh,
            in_specs=(plane_spec,
                      jax.tree_util.tree_map(lambda _: P(), params)),
            out_specs=plane_spec,
            check_vma=False)
        j_rot = kernel(krot, params)
        j_rot = jnp.moveaxis(j_rot, 1, -1)
        jmean = jmean + jax.lax.with_sharding_constraint(
            octants.rotate_from_sweep(j_rot, zone.izone),
            NamedSharding(mesh, grid_spec))
    return jnp.moveaxis(jmean, -1, 0)


# --------------------------------------------------------------------------
# strategy 2: angle (zone) decomposition, psum reduction
# --------------------------------------------------------------------------

def diffuse_sweep_zone_parallel(kappa, plan: SweepPlan, uvb, cell_size,
                                mesh: Mesh) -> jax.Array:
    """Angle-decomposed sweep: zones dealt round-robin to devices, Jmean
    psum-reduced.  `kappa` is replicated inside the shard_map (every device
    sweeps the full grid for its own zones); returns the replicated Jmean.

    Scaling is embarrassing (no per-slab halos), bounded by
    ceil(n_zones / n_devices) / (n_zones / n_devices); with the default 24
    zones it is perfect at 2/3/4/6/8/12/24 devices.
    """
    axis = mesh.axis_names[0]
    n_dev = int(np.prod(mesh.devices.shape))
    uvb = jnp.asarray(uvb, kappa.dtype)
    kappa_l = jnp.moveaxis(kappa, 0, -1)                  # (nx,ny,nz,3)
    n_zones = len(plan.zones)
    n_rounds = math.ceil(n_zones / n_dev)

    def make_branch(zone: ZoneBatch):
        # sweep_zone expects (ndir, nslab) layout and transposes internally
        params = {k: jnp.asarray(getattr(zone, k)) for k in
                  ("len_xy", "len_xz", "len_yz", "chain2", "chain3",
                   "n_active")}

        def branch(k_l):
            krot = octants.rotate_to_sweep(k_l, zone.izone)
            krot = jnp.moveaxis(krot, -1, 1)
            j_rot = core_sweep.sweep_zone(krot, params, uvb, cell_size,
                                          plan.weight)
            return octants.rotate_from_sweep(jnp.moveaxis(j_rot, 1, -1),
                                             zone.izone)
        return branch

    branches = [make_branch(z) for z in plan.zones]
    branches.append(lambda k_l: jnp.zeros_like(k_l))      # idle-round pad

    def worker(k_l):
        idx = jax.lax.axis_index(axis)
        j = jnp.zeros_like(k_l)
        for r in range(n_rounds):
            z = r * n_dev + idx
            z = jnp.where(z < n_zones, z, n_zones)        # pad branch
            j = j + jax.lax.switch(z, branches, k_l)
        return jax.lax.psum(j, axis)

    jmean_l = jax.shard_map(worker, mesh=mesh, in_specs=P(),
                            out_specs=P(), check_vma=False)(kappa_l)
    return jnp.moveaxis(jmean_l, -1, 0)


# --------------------------------------------------------------------------
# strategy 2b: angle (zone) decomposition for the BLOCK-SPARSE deep-AMR path
# --------------------------------------------------------------------------

_SPARSE_ZONES_CACHE: dict = {}


def _get_sparse_zones_runner(mesh: Mesh, L: int, weight: float,
                             n_coupling_iters: int, window_w=None):
    """Jitted shard_map runner for one group of direction chunks: each
    device scans its local chunk slice (scaled so padding chunks drop
    out), then the Jmean contributions psum-reduce to replicated
    accumulators.  Cached per (mesh, L, weight, depth); jit itself caches
    per chunk-shape signature, so production loops reuse the executable
    across iterations."""
    key = (mesh, L, float(weight), n_coupling_iters, window_w)
    fn = _SPARSE_ZONES_CACHE.get(key)
    if fn is not None:
        return fn
    from ..core import sweep_sparse
    axes = tuple(mesh.axis_names)
    chunk_axis = axes[0] if len(axes) == 1 else axes
    chunk_spec = P(chunk_axis)

    def worker(izones, stacked, scales, starts, ctx, uvb, cell_size,
               j0_in, jb_in):
        def body(carry, x):
            iz, pars, sc, w0 = x
            j0u, jbu = sweep_sparse._chunk_contrib(
                (iz, pars, w0), ctx, uvb, cell_size, L=L, weight=weight,
                n_coupling_iters=n_coupling_iters, window_w=window_w)
            j0_a, jb_a = carry
            return (j0_a + sc * j0u,
                    tuple(a + sc * b for a, b in zip(jb_a, jbu))), None

        zeros = (jnp.zeros_like(j0_in),
                 tuple(jnp.zeros_like(b) for b in jb_in))
        (j0, jbs), _ = jax.lax.scan(body, zeros,
                                    (izones, stacked, scales, starts))
        j0 = jax.lax.psum(j0, axes)
        jbs = tuple(jax.lax.psum(b, axes) for b in jbs)
        return j0_in + j0, tuple(a + b for a, b in zip(jb_in, jbs))

    def specs(izones, stacked, scales, starts, ctx, uvb, cell_size, j0,
              jb):
        tm = jax.tree_util.tree_map
        return (chunk_spec, tm(lambda _: chunk_spec, stacked), chunk_spec,
                chunk_spec, tm(lambda _: P(), ctx), P(), P(), P(),
                tm(lambda _: P(), jb))

    def make(izones, stacked, scales, starts, ctx, uvb, cell_size, j0, jb):
        in_specs = specs(izones, stacked, scales, starts, ctx, uvb,
                         cell_size, j0, jb)
        out_specs = (P(), jax.tree_util.tree_map(lambda _: P(), jb))
        mapped = jax.shard_map(worker, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False)
        return mapped(izones, stacked, scales, starts, ctx, uvb,
                      cell_size, j0, jb)

    fn = _SPARSE_ZONES_CACHE[key] = jax.jit(make)
    return fn


def diffuse_sweep_sparse_zones(k0, lv_kappas, state, plan, uvb, cell_size,
                               mesh: Mesh, n_coupling_iters: int = 4,
                               max_dirs_per_launch: int = 4,
                               eager_rounds: bool = False,
                               window="auto"):
    """Angle-decomposed block-sparse L-level sweep over the device mesh.

    The distributed form of core.sweep_sparse.diffuse_sweep_sparse: the
    per-zone direction chunks (the same chunking — the additive units) are
    dealt to the devices, each device sweeps its chunks over the full
    replicated sparse grid, and the base-level + per-level-block Jmean
    contributions are psum-reduced.  This is the strategy the deep-AMR
    production regime uses across devices; per-sweep communication is
    ONE psum of the accumulators, so scaling is bounded only by chunk
    load balance.

    eager_rounds: dispatch one round (n_devices chunks) per jitted call
    with a device sync between rounds — the bounded-dispatch form (the
    distributed analog of diffuse_sweep_sparse's eager_zones).

    Returns (J0 (3, n, n, n), [J blocks (3, nb, be, be, be) per refined
    level]), replicated over the mesh.  Parity with the single-device
    sparse sweep is exact up to the psum's accumulation-order roundoff
    (tests/test_amr_sparse.py::TestSparseZonesDistributed).
    """
    from ..core import sweep_sparse
    L = state.n_levels
    n_dev = int(np.prod(mesh.devices.shape))
    dtype = k0.dtype
    uvb = jnp.asarray(uvb, dtype)
    cell_size = jnp.asarray(cell_size, dtype)

    ctx = sweep_sparse.build_ctx(k0, lv_kappas, state)
    groups = sweep_sparse.build_chunks(plan, max_dirs_per_launch)
    if isinstance(window, str) and window == "auto":
        window = (None
                  if isinstance(state.refined0, jax.core.Tracer)
                  else sweep_sparse.compute_window(state))
    win_w = window[0] if window is not None else None
    runner = _get_sparse_zones_runner(mesh, L, plan.weight,
                                      n_coupling_iters, win_w)

    def starts_of(z):
        if window is None:
            return np.zeros(2, np.int32)
        return np.asarray(window[1][z.izone], np.int32)

    j0_acc = jnp.zeros(k0.shape[1:] + (3,), dtype)          # (n,n,n,3)
    jb_acc = tuple(jnp.zeros_like(k) for k in lv_kappas)

    for zones in groups.values():
        pad = (-len(zones)) % n_dev
        scales = np.concatenate([np.ones(len(zones), np.float32),
                                 np.zeros(pad, np.float32)])
        zones = zones + [zones[0]] * pad      # padding chunks scale to 0
        izones = jnp.asarray([z.izone - 1 for z in zones], jnp.int32)
        stacked = tuple(
            {key: jnp.asarray(np.stack([z.params[l][key] for z in zones]))
             for key in zones[0].params[l]}
            for l in range(L))
        starts = jnp.asarray(np.stack([starts_of(z) for z in zones]))
        if eager_rounds:
            rounds = len(zones) // n_dev
            for r in range(rounds):
                sl = slice(r * n_dev, (r + 1) * n_dev)
                j0_acc, jb_acc = runner(
                    izones[sl],
                    jax.tree_util.tree_map(lambda x: x[sl], stacked),
                    jnp.asarray(scales[sl]), starts[sl], ctx, uvb,
                    cell_size, j0_acc, jb_acc)
                # one dispatch in flight at a time (see
                # sweep_sparse.diffuse_sweep_sparse's eager_zones)
                jax.block_until_ready(j0_acc)
        else:
            j0_acc, jb_acc = runner(izones, stacked, jnp.asarray(scales),
                                    starts, ctx, uvb, cell_size,
                                    j0_acc, jb_acc)

    return jnp.moveaxis(j0_acc, -1, 0), list(jb_acc)


def make_jitted_sweep_dist(plan: SweepPlan, mesh: Mesh,
                           strategy: str = "pipelined"):
    """jit-compiled distributed sweep closed over a fixed plan and mesh.

    strategy: "pipelined" (grid decomposition, per-slab halo lines) or
    "zones" (angle decomposition, psum).
    """
    fn = {"pipelined": diffuse_sweep_pipelined,
          "zones": diffuse_sweep_zone_parallel}[strategy]
    return jax.jit(lambda kappa, uvb, cell_size:
                   fn(kappa, plan, uvb, cell_size, mesh))
