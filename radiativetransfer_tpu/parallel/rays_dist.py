"""Distributed point-source ray tracing: source parallelism (EP analog).

The reference traces stars one at a time in a serial loop
(/root/reference/equiSources.f90:1260-1364).  Here the merged source list is
sharded across the device mesh: every device runs the lockstep phased tracer
(core.rays) on its own source subset against a locally-replicated field copy
(rays are random access over the whole grid, so each shard all-gathers the
five packed field arrays once — ~5 n^3 words — instead of issuing per-segment
remote gathers), then the per-cell rate deposits are combined with a
reduce-scatter back onto the grid decomposition and the per-source
diagnostics concatenate along the sharded source axis.

Design notes:
* sources are padded to a multiple of the mesh size with zero-weight
  dummies; dead rays march but deposit nothing (lane-bound tracer, so the
  padding cost is bounded by one source's rays);
* the deposit reduce-scatter (psum_scatter over the last grid axis) leaves
  the RateFields in exactly the FieldState sharding — no resharding when
  the chemistry step consumes them;
* escape-fraction/spectrum diagnostics shard over sources, matching their
  (S, nradius)/(S, nenergy) leading axis.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..constants import MAX_PIXEL_LEVEL, NO_DUST
from ..core import rays as rays_mod
from ..core.rays import _HIGHEST, RayDiagnostics, SourceBatch


# jitted shard_map tracers, keyed on every static the worker closures
# capture (tracer kind, geom, mesh, padded source count, dust mode, pixel
# depth, dtype, rates mode, band count, AMR depth).  Without this the
# production step would re-trace + recompile the distributed tracer every
# iteration (the single-device tracers cache via _TRACER_CACHE).
_DIST_TRACER_CACHE: dict = {}


def pad_sources(sources: SourceBatch, n_shards: int) -> tuple[SourceBatch, int]:
    """Pad the source batch to a multiple of n_shards with zero-weight
    dummies (they trace but deposit w=0)."""
    s = sources.n_sources
    pad = (-s) % n_shards
    if pad == 0:
        return sources, s
    center = np.full((pad, 3), 0.5)
    return SourceBatch(
        position=np.concatenate([sources.position, center]),
        weight=np.concatenate([sources.weight, np.zeros(pad)]),
        table_idx=np.concatenate([sources.table_idx,
                                  np.zeros(pad, sources.table_idx.dtype)]),
    ), s


def trace_point_sources_dist(state_fields, geom, sources: SourceBatch,
                             tables, mesh: Mesh,
                             dust_approximation: int = NO_DUST,
                             max_pixel_level: int = MAX_PIXEL_LEVEL,
                             dtype=jnp.float32, rates_mode: str = "auto",
                             n_bands: int = 3):
    """Drop-in distributed analog of core.rays.trace_point_sources.

    Returns (RateFields, RayDiagnostics) where the rate fields carry the
    (None, None, axis) grid sharding of parallel.mesh.field_sharding and the
    diagnostics are sharded over sources.  Bitwise-equivalent per shard to
    the single-device tracer on the same source subset; the cross-shard
    deposit sum is the only reduction (matching the serial accumulation
    order within each shard).
    """
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    from .mesh import _grid_spec
    axes = mesh.axis_names          # k mesh axes -> last k grid axes
    grid_entries = _grid_spec(mesh)
    n_shards = int(np.prod(mesh.devices.shape))
    n = geom.nx

    padded, n_real = pad_sources(sources, n_shards)
    s_local = padded.n_sources // n_shards

    # host-side per-shard ray spawn (source-major layout is preserved per
    # shard, so core.rays' implicit pixel indexing stays valid)
    init_state = rays_mod._spawn_phase(padded, 1, dtype)
    init_state = dataclasses.replace(
        init_state,
        cell=jnp.clip((init_state.pos * n).astype(jnp.int32), 0, n - 1))

    fields = {
        "HI": state_fields.HI.astype(dtype),
        "HeI": state_fields.HeI.astype(dtype),
        "HeII": state_fields.HeII.astype(dtype),
        "nH": state_fields.nh.astype(dtype),
        "abun2": state_fields.abun2.astype(dtype),
    }
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}

    field_spec = P(*grid_entries)
    src_axis = axes[0] if len(axes) == 1 else tuple(axes)
    ray_spec = jax.tree_util.tree_map(lambda _: P(src_axis), init_state)
    sharded_dims = [(d, name) for d, name in enumerate(grid_entries)
                    if name is not None]

    def worker(fields, init_state, tables_dev):
        # one all-gather per (field, mesh axis): replicate the grid for
        # the tracer's random-access gathers
        def gather(v):
            for d, name in sharded_dims:
                v = jax.lax.all_gather(v, name, axis=d, tiled=True)
            return v.reshape(-1)

        full = {k: gather(v) for k, v in fields.items()}
        rf, diag = rays_mod._trace_all_phases(
            full, init_state, tables_dev, geom=geom, n_sources=s_local,
            dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode, n_bands=n_bands)

        # reduce-scatter each deposit field onto the grid decomposition,
        # one mesh axis at a time (sum over all shards, scattered back)
        def scatter(x):
            x = x.reshape(n, n, n)
            for d, name in sharded_dims:
                x = jax.lax.psum_scatter(x, name, scatter_dimension=d,
                                         tiled=True)
            return x

        rf = jax.tree_util.tree_map(scatter, rf)
        return rf, diag

    key = ("uniform", geom, mesh, padded.n_sources, dust_approximation,
           max_pixel_level, jnp.dtype(dtype).name, rates_mode, n_bands,
           frozenset(tables_dev))
    fn = _DIST_TRACER_CACHE.get(key)
    if fn is None:
        out_specs = (
            jax.tree_util.tree_map(lambda _: field_spec,
                                   _rate_fields_struct(rates_mode, n, dtype)),
            jax.tree_util.tree_map(lambda _: P(src_axis),
                                   RayDiagnostics.zeros(1, dtype)),
        )
        # check_vma off: the tracer's zero-initialized loop carries are
        # replicated values that become device-varying inside the while_loop,
        # which the static varying-axis checker rejects
        mapped = jax.shard_map(
            worker, mesh=mesh,
            in_specs=({k: field_spec for k in fields}, ray_spec,
                      {k: P() for k in tables_dev}),
            out_specs=out_specs, check_vma=False)
        fn = _DIST_TRACER_CACHE[key] = jax.jit(mapped)
    rf, diag = fn(fields, init_state, tables_dev)
    if n_real != padded.n_sources:
        diag = jax.tree_util.tree_map(lambda x: x[:n_real], diag)
    return rf, diag


def _rate_fields_struct(rates_mode: str, n: int, dtype):
    cls = (rays_mod.NoneqRateFields if rates_mode == "quadrature_noneq"
           else rays_mod.RateFields)
    k = len(dataclasses.fields(cls))
    return cls(*([0] * k))


def trace_point_sources_ml_dist(ml_state, geom, sources: SourceBatch,
                                tables, mesh: Mesh,
                                dust_approximation: int = NO_DUST,
                                max_pixel_level: int = MAX_PIXEL_LEVEL,
                                dtype=jnp.float32,
                                rates_mode: str = "auto"):
    """Distributed analog of core.rays_multilevel.trace_point_sources_ml:
    sources sharded over the mesh, all L levels' fields all-gathered per
    shard (packed in-worker), per-level deposit RateFields reduce-scattered
    back onto the grid decomposition (same protocol as the uniform/two-level
    tracers above).

    Returns (tuple of L RateFields, each flat deposits scattered to
    (n_l, n_l, n_l) grid sharding, RayDiagnostics sharded over sources)."""
    from ..core import rays_multilevel
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    from .mesh import _grid_spec
    grid_entries = _grid_spec(mesh)
    n_shards = int(np.prod(mesh.devices.shape))
    L = ml_state.n_levels
    n = geom.nx
    nF = n * 2 ** (L - 1)

    padded, n_real = pad_sources(sources, n_shards)
    s_local = padded.n_sources // n_shards

    init_state = rays_mod._spawn_phase(padded, 1, dtype)
    init_state = dataclasses.replace(
        init_state,
        cell=jnp.clip((init_state.pos * nF).astype(jnp.int32), 0, nF - 1))

    fields3 = {}
    for ell, st in enumerate(ml_state.levels):
        for name, v in (("HI", st.HI), ("HeI", st.HeI), ("HeII", st.HeII),
                        ("nH", st.nh), ("abun2", st.abun2)):
            fields3[f"{name}{ell}"] = v.astype(dtype)
    for ell, r in enumerate(ml_state.refined):
        fields3[f"ref{ell}"] = jnp.asarray(r, bool)
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}

    field_spec = P(*grid_entries)
    src_axis = (mesh.axis_names[0] if len(mesh.axis_names) == 1
                else tuple(mesh.axis_names))
    ray_spec = jax.tree_util.tree_map(lambda _: P(src_axis), init_state)
    sharded_dims = [(d, name) for d, name in enumerate(grid_entries)
                    if name is not None]

    def worker(fields3, init_state, tables_dev):
        def gather(v):
            for d, name in sharded_dims:
                v = jax.lax.all_gather(v, name, axis=d, tiled=True)
            return v

        fg = {k: gather(v) for k, v in fields3.items()}
        full = {"leaf_level": rays_multilevel.leaf_level_volume(
            [fg[f"ref{ell}"] for ell in range(L - 1)], n, L)}
        full["lv_all"] = jnp.concatenate([
            rays_mod._pack_fields(
                fg[f"HI{ell}"].reshape(-1), fg[f"HeI{ell}"].reshape(-1),
                fg[f"HeII{ell}"].reshape(-1), fg[f"nH{ell}"].reshape(-1),
                fg[f"abun2{ell}"].reshape(-1))
            for ell in range(L)], axis=0)
        rfs, diag = rays_multilevel._trace_all_phases_ml(
            full, init_state, tables_dev, geom=geom, n_levels=L,
            n_sources=s_local, dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode)

        def scatter(x, m):
            x = x.reshape(m, m, m)
            for d, name in sharded_dims:
                x = jax.lax.psum_scatter(x, name, scatter_dimension=d,
                                         tiled=True)
            return x

        rfs = tuple(
            jax.tree_util.tree_map(
                lambda x, m=n * 2 ** ell: scatter(x, m), rf)
            for ell, rf in enumerate(rfs))
        return rfs, diag

    key = ("ml", geom, mesh, L, padded.n_sources, dust_approximation,
           max_pixel_level, jnp.dtype(dtype).name, rates_mode,
           frozenset(tables_dev))
    fn = _DIST_TRACER_CACHE.get(key)
    if fn is None:
        rf_struct = _rate_fields_struct(rates_mode, n, dtype)
        out_specs = (
            tuple(jax.tree_util.tree_map(lambda _: field_spec, rf_struct)
                  for _ in range(L)),
            jax.tree_util.tree_map(lambda _: P(src_axis),
                                   RayDiagnostics.zeros(1, dtype)),
        )
        mapped = jax.shard_map(
            worker, mesh=mesh,
            in_specs=({k: field_spec for k in fields3}, ray_spec,
                      {k: P() for k in tables_dev}),
            out_specs=out_specs, check_vma=False)
        fn = _DIST_TRACER_CACHE[key] = jax.jit(mapped)
    rfs, diag = fn(fields3, init_state, tables_dev)
    if n_real != padded.n_sources:
        diag = jax.tree_util.tree_map(lambda x: x[:n_real], diag)
    return rfs, diag


def trace_point_sources_sparse_dist(sp_state, geom, sources: SourceBatch,
                                    tables, mesh: Mesh,
                                    dust_approximation: int = NO_DUST,
                                    max_pixel_level: int = MAX_PIXEL_LEVEL,
                                    dtype=jnp.float32,
                                    rates_mode: str = "auto",
                                    host_phases: bool = False,
                                    chunk_steps: int = 512):
    """Distributed analog of rays_multilevel.trace_point_sources_sparse:
    sources sharded over the mesh, the block-sparse field/addressing
    arrays replicated (the O(leaves) production state is small — 0.18 GB
    at 128^3 + 3 levels — so replication is the right trade against
    per-segment remote gathers), per-level deposit RateFields psum-reduced
    to replicated arrays, diagnostics sharded over sources.

    host_phases=True marches each phase as repeated `chunk_steps`-step
    shard_mapped dispatches with one cross-shard alive count fetched
    between chunks — the bounded-dispatch form (the distributed analog of
    _trace_all_phases_ml_host).

    Returns (tuple of per-level RateFields — level 0 flat (n^3,), refined
    levels block-flat (nb*be^3,) — and RayDiagnostics)."""
    from ..core import rays_multilevel as rml
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    n_shards = int(np.prod(mesh.devices.shape))
    L = sp_state.n_levels
    n = geom.nx
    nF = n * 2 ** (L - 1)

    padded, n_real = pad_sources(sources, n_shards)
    s_local = padded.n_sources // n_shards

    init_state = rays_mod._spawn_phase(padded, 1, dtype)
    init_state = dataclasses.replace(
        init_state,
        cell=jnp.clip((init_state.pos * nF).astype(jnp.int32), 0, nF - 1))

    # level-concatenated packed fields + sparse addressing (the same
    # layout trace_point_sources_sparse builds)
    st0 = sp_state.base
    packed = [rays_mod._pack_fields(
        st0.HI.reshape(-1).astype(dtype), st0.HeI.reshape(-1).astype(dtype),
        st0.HeII.reshape(-1).astype(dtype), st0.nh.reshape(-1).astype(dtype),
        st0.abun2.reshape(-1).astype(dtype))]
    fields = {}
    for ell in range(1, L):
        lv = sp_state.levels[ell - 1]
        f = lv.fields
        packed.append(rays_mod._pack_fields(
            f.HI.reshape(-1).astype(dtype), f.HeI.reshape(-1).astype(dtype),
            f.HeII.reshape(-1).astype(dtype), f.nh.reshape(-1).astype(dtype),
            f.abun2.reshape(-1).astype(dtype)))
        fields[f"slot{ell}"] = lv.slot
        fields[f"cover{ell}"] = lv.cover.reshape(-1)
    fields["lv_all"] = jnp.concatenate(packed, axis=0)
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}

    axes = tuple(mesh.axis_names)
    src_axis = axes[0] if len(axes) == 1 else axes
    ray_spec = jax.tree_util.tree_map(lambda _: P(src_axis), init_state)

    if host_phases:
        rfs, diag = _trace_sparse_host_dist(
            fields, init_state, tables_dev, mesh, geom=geom, L=L,
            s_local=s_local, n_shards=n_shards,
            dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode, chunk_steps=chunk_steps)
        if n_real != padded.n_sources:
            diag = jax.tree_util.tree_map(lambda x: x[:n_real], diag)
        return rfs, diag

    def worker(fields, init_state, tables_dev):
        rfs, diag = rml._trace_all_phases_ml(
            fields, init_state, tables_dev, geom=geom, n_levels=L,
            n_sources=s_local, dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode)
        rfs = tuple(
            jax.tree_util.tree_map(lambda x: jax.lax.psum(x, axes), rf)
            for rf in rfs)
        return rfs, diag

    key = ("sparse", geom, mesh, L, padded.n_sources, dust_approximation,
           max_pixel_level, jnp.dtype(dtype).name, rates_mode,
           frozenset(tables_dev))
    fn = _DIST_TRACER_CACHE.get(key)
    if fn is None:
        rf_struct = _rate_fields_struct(rates_mode, n, dtype)
        out_specs = (
            tuple(jax.tree_util.tree_map(lambda _: P(), rf_struct)
                  for _ in range(L)),
            jax.tree_util.tree_map(lambda _: P(src_axis),
                                   RayDiagnostics.zeros(1, dtype)),
        )
        mapped = jax.shard_map(
            worker, mesh=mesh,
            in_specs=({k: P() for k in fields}, ray_spec,
                      {k: P() for k in tables_dev}),
            out_specs=out_specs, check_vma=False)
        fn = _DIST_TRACER_CACHE[key] = jax.jit(mapped)
    rfs, diag = fn(fields, init_state, tables_dev)
    if n_real != padded.n_sources:
        diag = jax.tree_util.tree_map(lambda x: x[:n_real], diag)
    return rfs, diag


def _trace_sparse_host_dist(fields, init_state, tables_dev, mesh: Mesh, *,
                            geom, L, s_local, n_shards, dust_approximation,
                            max_pixel_level, dtype, rates_mode,
                            chunk_steps):
    """Host-driven distributed phase loop: every phase marches as repeated
    shard_mapped `chunk_steps`-step dispatches (sources sharded, fields
    replicated, per-shard deposit accumulators carried on a sharded
    leading axis) with ONE cross-shard alive count fetched between chunks.
    Numerically identical to the jittable worker: the per-chunk
    accumulators are additive and re-entry with dead rays is a no-op."""
    import numpy as _np

    from ..constants import (KPC, OUTPUT_RADII_KPC, SIGMA24_AT_NU1,
                             SIGMA25_AT_NU3, SIGMA26_AT_NU2,
                             SIGMA_DUST_AT_NU1, rmax_table)
    from ..core import rays_multilevel as rml
    n = geom.nx
    nF = n * 2 ** (L - 1)
    rel_kill = 0.0 if jnp.dtype(dtype).itemsize >= 8 else 1.0e-10
    rmax = rmax_table()
    axes = tuple(mesh.axis_names)
    src_axis = axes[0] if len(axes) == 1 else axes

    sizes = rml._level_sizes(fields, n, L)
    rf_cls, n_ch = ((rays_mod.NoneqRateFields, 11)
                    if rates_mode == "quadrature_noneq"
                    else (rays_mod.RateFields, 6))
    # per-shard partial deposit accumulators: leading (n_shards,) axis
    # sharded over sources; summed over shards only at the very end
    rfs = rf_cls(*[jnp.zeros((n_shards, sum(sizes)), dtype)
                   for _ in range(n_ch)])
    diag = RayDiagnostics.zeros(n_shards * s_local, dtype)
    if rates_mode == "quadrature_noneq":
        ctx_arrays = (jnp.asarray(tables_dev["quad_A"], dtype),
                      jnp.asarray(tables_dev["quad_W"], dtype),
                      jnp.asarray(tables_dev["quad_W27"], dtype))
    elif rates_mode == "quadrature":
        ctx_arrays = (jnp.asarray(tables_dev["quad_A"], dtype),
                      jnp.asarray(tables_dev["quad_W"], dtype))
    else:
        ctx_arrays = rays_mod._pack_tables(tables_dev["reaction_log"],
                                           tables_dev["energy_log"])
    sig_ratio = jnp.stack([
        jnp.asarray(tables_dev["output_sigma24"], dtype) / SIGMA24_AT_NU1,
        jnp.asarray(tables_dev["output_sigma26"], dtype) / SIGMA26_AT_NU2,
        jnp.asarray(tables_dev["output_sigma25"], dtype) / SIGMA25_AT_NU3,
        jnp.asarray(tables_dev["output_sigma_dust"], dtype)
        / SIGMA_DUST_AT_NU1])
    state = init_state
    spec_of = lambda tree: jax.tree_util.tree_map(lambda _: P(src_axis),
                                                  tree)
    rep_of = lambda tree: jax.tree_util.tree_map(lambda _: P(), tree)

    def get_runner(level, last, r_stop):
        key = ("sparse-host-dist", mesh, geom, L, n_shards, s_local,
               dust_approximation, level, last, r_stop, chunk_steps,
               jnp.dtype(dtype).name, rates_mode, rel_kill)
        fn = _DIST_TRACER_CACHE.get(key)
        if fn is None:
            def run_local(state, fields, ctx_arrays, diag, rfs):
                rays_per_source = 12 * 4 ** (level - 1)
                src_of_ray = jnp.repeat(
                    jnp.arange(s_local, dtype=jnp.int32), rays_per_source)
                rfs_l = jax.tree_util.tree_map(lambda x: x[0], rfs)
                rate_ctx = (rates_mode, ctx_arrays)
                state, diag, rfs_l = rml._march_phase_ml(
                    state, fields, geom, L, rate_ctx, diag, rfs_l,
                    r_stop, last, dust_approximation, chunk_steps,
                    src_of_ray, rel_kill=rel_kill)
                cnt = jax.lax.psum(
                    jnp.sum(state.alive.astype(jnp.int32)), axes)
                return (state, diag,
                        jax.tree_util.tree_map(lambda x: x[None], rfs_l),
                        cnt)

            mapped = jax.shard_map(
                run_local, mesh=mesh,
                in_specs=(spec_of(state), rep_of(fields),
                          rep_of(ctx_arrays), spec_of(diag), spec_of(rfs)),
                out_specs=(spec_of(state), spec_of(diag), spec_of(rfs),
                           P()),
                check_vma=False)
            fn = _DIST_TRACER_CACHE[key] = jax.jit(mapped)
        return fn

    def get_flush(level, last):
        key = ("sparse-host-dist-flush", mesh, geom, L, n_shards, s_local,
               level, last, jnp.dtype(dtype).name)
        fn = _DIST_TRACER_CACHE.get(key)
        if fn is None:
            def flush_local(state, diag, sig_ratio):
                rays_per_source = 12 * 4 ** (level - 1)
                src_of_ray = jnp.repeat(
                    jnp.arange(s_local, dtype=jnp.int32), rays_per_source)
                spec_tau = jnp.dot(state.cross_depth, sig_ratio,
                                   precision=_HIGHEST)
                contrib = jnp.where(
                    state.crossed[:, None],
                    state.ndot[:, None] * jnp.exp(-spec_tau), 0.0)
                diag = dataclasses.replace(
                    diag, ndot_spectrum=diag.ndot_spectrum
                    .at[src_of_ray].add(contrib))
                state = dataclasses.replace(
                    state, crossed=jnp.zeros_like(state.crossed))
                if not last:
                    state, in_box, was_split = rays_mod._split_rays(
                        state, level, n, dtype, cell_grid=nF)
                    lost = was_split & ~in_box
                    out_radii = jnp.asarray(
                        _np.array(OUTPUT_RADII_KPC) * KPC, dtype)
                    r2 = state.radius * geom.cell_size
                    beyond = out_radii[None, :] > r2[:, None]
                    src4 = jnp.repeat(src_of_ray, 4)
                    diag = dataclasses.replace(
                        diag, ndot_boundary=diag.ndot_boundary
                        .at[src4].add(jnp.where(beyond & lost[:, None],
                                                state.ndot[:, None], 0.0)))
                return state, diag

            mapped = jax.shard_map(
                flush_local, mesh=mesh,
                in_specs=(spec_of(state), spec_of(diag), P()),
                out_specs=(spec_of(state), spec_of(diag)),
                check_vma=False)
            fn = _DIST_TRACER_CACHE[key] = jax.jit(mapped)
        return fn

    for level in range(1, max_pixel_level + 1):
        last = level == max_pixel_level
        r_stop = float(rmax[level - 1])
        max_steps = (int(12 * nF + 64) if last
                     else int(6 * 2 ** (L - 1) * (r_stop + 2) + 32))
        runner = get_runner(level, last, r_stop)
        steps = 0
        while steps < max_steps:
            state, diag, rfs, cnt = runner(state, fields, ctx_arrays,
                                           diag, rfs)
            steps += chunk_steps
            if int(cnt) == 0:       # also syncs: one dispatch in flight
                break
        state, diag = get_flush(level, last)(state, diag, sig_ratio)

    total = jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=0), rfs)
    return rml._split_rfs(total, sizes), diag


def trace_point_sources_amr_dist(amr_state, geom, sources: SourceBatch,
                                 tables, mesh: Mesh,
                                 dust_approximation: int = NO_DUST,
                                 max_pixel_level: int = MAX_PIXEL_LEVEL,
                                 dtype=jnp.float32,
                                 rates_mode: str = "auto"):
    """Distributed analog of core.rays_amr.trace_point_sources_amr:
    sources sharded over the mesh, base+fine fields all-gathered per shard,
    both deposit RateFields reduce-scattered back onto the grid
    decomposition (same protocol as trace_point_sources_dist above).

    Returns (RateFields base (n,n,n), RateFields fine (2n,2n,2n),
    RayDiagnostics sharded over sources)."""
    from ..core import rays_amr
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    from .mesh import _grid_spec
    grid_entries = _grid_spec(mesh)
    n_shards = int(np.prod(mesh.devices.shape))
    n, n2 = geom.nx, 2 * geom.nx

    padded, n_real = pad_sources(sources, n_shards)
    s_local = padded.n_sources // n_shards

    init_state = rays_mod._spawn_phase(padded, 1, dtype)
    init_state = dataclasses.replace(
        init_state,
        cell=jnp.clip((init_state.pos * n2).astype(jnp.int32), 0, n2 - 1))

    b, f = amr_state.base, amr_state.fine
    fields3 = {
        "HI": b.HI.astype(dtype), "HeI": b.HeI.astype(dtype),
        "HeII": b.HeII.astype(dtype), "nH": b.nh.astype(dtype),
        "abun2": b.abun2.astype(dtype),
        "HI_f": f.HI.astype(dtype), "HeI_f": f.HeI.astype(dtype),
        "HeII_f": f.HeII.astype(dtype), "nH_f": f.nh.astype(dtype),
        "abun2_f": f.abun2.astype(dtype),
        "refined": amr_state.refined,
    }
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}

    field_spec = P(*grid_entries)
    src_axis = (mesh.axis_names[0] if len(mesh.axis_names) == 1
                else tuple(mesh.axis_names))
    ray_spec = jax.tree_util.tree_map(lambda _: P(src_axis), init_state)
    sharded_dims = [(d, name) for d, name in enumerate(grid_entries)
                    if name is not None]

    def worker(fields3, init_state, tables_dev):
        def gather(v):
            for d, name in sharded_dims:
                v = jax.lax.all_gather(v, name, axis=d, tiled=True)
            return v.reshape(-1)

        full = {k: gather(v) for k, v in fields3.items()}
        rfb, rff, diag = rays_amr._trace_all_phases_amr(
            full, init_state, tables_dev, geom=geom, n_sources=s_local,
            dust_approximation=dust_approximation,
            max_pixel_level=max_pixel_level, dtype=dtype,
            rates_mode=rates_mode)

        def scatter(x, m):
            x = x.reshape(m, m, m)
            for d, name in sharded_dims:
                x = jax.lax.psum_scatter(x, name, scatter_dimension=d,
                                         tiled=True)
            return x

        rfb = jax.tree_util.tree_map(lambda x: scatter(x, n), rfb)
        rff = jax.tree_util.tree_map(lambda x: scatter(x, n2), rff)
        return rfb, rff, diag

    key = ("amr", geom, mesh, padded.n_sources, dust_approximation,
           max_pixel_level, jnp.dtype(dtype).name, rates_mode,
           frozenset(tables_dev))
    fn = _DIST_TRACER_CACHE.get(key)
    if fn is None:
        rf_struct = _rate_fields_struct(rates_mode, n, dtype)
        out_specs = (
            jax.tree_util.tree_map(lambda _: field_spec, rf_struct),
            jax.tree_util.tree_map(lambda _: field_spec, rf_struct),
            jax.tree_util.tree_map(lambda _: P(src_axis),
                                   RayDiagnostics.zeros(1, dtype)),
        )
        mapped = jax.shard_map(
            worker, mesh=mesh,
            in_specs=({k: field_spec for k in fields3}, ray_spec,
                      {k: P() for k in tables_dev}),
            out_specs=out_specs, check_vma=False)
        fn = _DIST_TRACER_CACHE[key] = jax.jit(mapped)
    rfb, rff, diag = fn(fields3, init_state, tables_dev)
    if n_real != padded.n_sources:
        diag = jax.tree_util.tree_map(lambda x: x[:n_real], diag)
    return rfb, rff, diag
