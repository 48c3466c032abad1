"""Two-level AMR point-source ray tracer.

Extends the lockstep phased tracer (core.rays) to nested grids: every ray
tracks its containing FINE cell index; the cell's refinement state selects
the local resolution for face crossings, optical depths, and deposits.

Reference semantics preserved (equiSources.f90:2412-2595, 3120-3385):

* segment geometry at the local cell size (drawSegment operates in
  current-cell units);
* the split criterion radius*2^level + len < rmax(pixelLevel) — rays inside
  refined regions split at HALF the base-unit radius, keeping the ray
  density matched to the local cell size (:2491);
* rate deposits into the leaf cell actually traversed (fine under refined
  parents, base elsewhere);
* face hand-off across refinement boundaries by exact face-index
  arithmetic (the dense analog of findXY/YZ/XZNeighbour + zoom*,
  :2647-2960).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    COMPLETE_SUBLIMATION,
    KPC,
    MAX_PIXEL_LEVEL,
    NO_DUST,
    N_RADIUS,
    OUTPUT_RADII_KPC,
    SIGMA24_AT_NU1,
    SIGMA25_AT_NU3,
    SIGMA26_AT_NU2,
    SIGMA_DUST_AT_NU1,
    rmax_table,
)
from .rays import (
    _HIGHEST,
    RateFields,
    RayDiagnostics,
    SourceBatch,
    _RayState,
    _deposit_quadrature,
    default_tau_kill,
    _interp_flat,
    _pack_fields,
    _pack_tables,
    _spawn_phase,
    _split_rays,
)

# dtype-aware kill threshold (core.rays.default_tau_kill): 100 in f64
# for reference parity, 30 in f32 where e^-30 is below accumulation
# resolution — keeps every tracer consistent (ADVICE r3)


def _march_phase_amr(state: _RayState, fields, geom, rate_ctx,
                     diag: RayDiagnostics, rfb: RateFields, rff: RateFields,
                     r_stop: float, last_phase: bool,
                     dust_approximation: int, max_steps: int, src_of_ray,
                     rel_kill: float = 0.0):
    """March one phase on a two-level grid.

    state.cell holds FINE (2n-grid) indices; fields holds packed per-level
    field arrays 'base' (n^3, 5) / 'fine' ((2n)^3, 5) [HI, HeI, HeII, nH,
    abun2] plus 'refined' (n^3,).  rate_ctx: ("table", table_flat) or
    ("quadrature", (quad_A, quad_W)).  Same gather/scatter tuning as
    core.rays._march_phase.
    """
    n = geom.nx
    n2 = 2 * n
    cell_size = geom.cell_size          # base cell [cm]
    dtype = state.ndot.dtype
    tau_kill = default_tau_kill(dtype)
    out_radii = jnp.asarray(np.array(OUTPUT_RADII_KPC) * KPC, dtype)
    R = state.pos.shape[0]
    rem_acc0 = jnp.zeros((R, out_radii.shape[0]), dtype)
    bnd_acc0 = jnp.zeros((R, out_radii.shape[0]), dtype)
    rates_mode = rate_ctx[0]
    # spectrum-exhaustion kill (see core.rays._march_phase)
    use_rem_kill = rates_mode.startswith("quadrature") and rel_kill > 0.0
    if use_rem_kill:
        wsum = jnp.max(jnp.sum(jnp.abs(rate_ctx[1][1]), axis=2), axis=0)
        rem_floor = rel_kill * jnp.sum(wsum)

    def flat_base(cb):
        return (cb[:, 0] * n + cb[:, 1]) * n + cb[:, 2]

    def flat_fine(cf):
        return (cf[:, 0] * n2 + cf[:, 1]) * n2 + cf[:, 2]

    def step(carry):
        state, rem_acc, bnd_acc, rfb, rff, it = carry
        d = state.direction
        d_safe = jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)

        cf = state.cell                          # fine index (R,3)
        cb = cf >> 1                             # base index
        lvl1 = fields["refined"][flat_base(cb)]  # bool: in a refined parent

        dpos = (d_safe > 0.0).astype(cf.dtype)
        # exit faces in fine-grid units: fine faces where refined, the
        # parent's faces (even fine indices) elsewhere
        f_bound = jnp.where(lvl1[:, None], cf + dpos, 2 * (cb + dpos))
        t_ax = (f_bound / n2 - state.pos) / d_safe
        # f32 position round-off can overshoot a face, making the
        # next crossing distance slightly negative; the exact value
        # is 0 (drawSegment's geometry is nonnegative), and leaving
        # it negative walks pos backward while the cell index
        # advances, compounding the desync until tau diverges
        t_min = jnp.maximum(jnp.min(t_ax, axis=1), 0.0)
        exit_axis = jnp.argmin(t_ax, axis=1)
        seg_cells = t_min * n                    # base-cell units

        # split criterion at the LOCAL level (:2491): effective stop radius
        # halves inside refined cells
        r_stop_local = jnp.where(lvl1, r_stop / 2.0, r_stop).astype(dtype)
        radius_new = state.radius + seg_cells
        if last_phase:
            will_split = jnp.zeros_like(state.alive)
            cut = jnp.zeros_like(state.alive)
        else:
            will_split = radius_new >= r_stop_local
            cut = will_split
            seg_cells = jnp.where(cut,
                                  jnp.maximum(r_stop_local - state.radius, 0.0),
                                  seg_cells)
            radius_new = state.radius + seg_cells
            t_min = seg_cells / n

        active = state.alive
        plen = seg_cells * cell_size

        ib = flat_base(cb)
        if_ = flat_fine(cf)
        fv = jnp.where(lvl1[:, None], fields["fine"][if_], fields["base"][ib])
        hi, hei, heii, nh, ab2 = (fv[:, 0], fv[:, 1], fv[:, 2], fv[:, 3],
                                  fv[:, 4])

        tau1 = plen * hi * SIGMA24_AT_NU1
        tau2 = plen * hei * SIGMA26_AT_NU2
        tau3 = plen * heii * SIGMA25_AT_NU3
        if dust_approximation == NO_DUST:
            taud = jnp.zeros_like(tau1)
        elif dust_approximation == COMPLETE_SUBLIMATION:
            taud = plen * hi * SIGMA_DUST_AT_NU1 * ab2 / 0.2
        else:
            taud = plen * nh * SIGMA_DUST_AT_NU1 * ab2 / 0.2
        tau = jnp.stack([tau1, tau2, tau3, taud], axis=1)
        tau = jnp.where(active[:, None], jnp.maximum(tau, 0.0), 0.0)
        # re-read the masked components: dead rays carry frozen (possibly
        # out-of-box) state whose raw segment values can be huge or
        # NEGATIVE (t_min < 0), and a negative tau overflows exp() to inf
        # in the deposit math, which w=0 then turns into scattered NaNs
        tau1, tau2, tau3, taud = tau[:, 0], tau[:, 1], tau[:, 2], tau[:, 3]
        plen = jnp.where(active, plen, 0.0)

        # escape-fraction bookkeeping (equiSources.f90:3198-3226)
        r1 = state.radius * cell_size
        r2 = radius_new * cell_size
        in_seg = ((out_radii[None, :] >= r1[:, None])
                  & (out_radii[None, :] <= r2[:, None]) & active[:, None])
        ratio = jnp.where(in_seg,
                          (out_radii[None, :] - r1[:, None])
                          / jnp.maximum((r2 - r1)[:, None], 1e-30), 0.0)
        esc = state.ndot[:, None] * jnp.exp(
            -(ratio * (tau1 + taud)[:, None]
              + (state.depth[:, 0] + state.depth[:, 3])[:, None]))
        rem_acc = rem_acc + jnp.where(in_seg, esc, 0.0)
        crossing = in_seg[:, -1] & ~state.crossed
        cross_depth = jnp.where(crossing[:, None],
                                state.depth + ratio[:, -1:] * tau,
                                state.cross_depth)
        crossed = state.crossed | crossing

        # rate deposits into the traversed leaf (:3243-3260)
        w = jnp.where(active, state.ndot, 0.0)
        d0 = state.depth
        if rates_mode == "table":
            # the 4 attenuation states interpolate in one batched call
            depths4 = jnp.concatenate([
                d0, d0.at[:, 0].add(tau1), d0.at[:, 1].add(tau2),
                d0.at[:, 2].add(tau3)], axis=0)
            tidx4 = jnp.concatenate([state.table_idx] * 4)
            v = _interp_flat(rate_ctx[1], tidx4, depths4,
                             dust_approximation != NO_DUST)
            v_in, v_a1, v_a2, v_a3 = jnp.split(v, 4, axis=0)
            dep_unit = (
                v_in[:, 0] - v_a1[:, 0],   # krate24
                v_in[:, 2] - v_a3[:, 2],   # krate25
                v_in[:, 1] - v_a2[:, 1],   # krate26
                v_in[:, 3] - v_a1[:, 3],   # crate24
                v_in[:, 5] - v_a3[:, 5],   # crate25
                v_in[:, 4] - v_a2[:, 4],   # crate26
            )
            deposit = tuple(w * d for d in dep_unit)
        else:
            quad_A, quad_W = rate_ctx[1]
            dtau = jnp.stack([tau1, tau2, tau3], axis=1)
            dq = _deposit_quadrature(d0, dtau, quad_A, quad_W,
                                     state.table_idx, w,
                                     wsum=wsum if use_rem_kill else None)
            deposit, rem = dq if use_rem_kill else (dq, None)

        # deposit into the traversed leaf's level: 6 scalar scatter-adds
        # per level, zero-weighted on the other level
        on_fine = lvl1.astype(w.dtype)
        rfb = RateFields(*(getattr(rfb, f.name)
                           .at[ib].add(v * (1.0 - on_fine))
                           for f, v in zip(dataclasses.fields(rfb), deposit)))
        rff = RateFields(*(getattr(rff, f.name).at[if_].add(v * on_fine)
                           for f, v in zip(dataclasses.fields(rff), deposit)))

        # advance: snap the crossing coordinate onto the (fine-unit) face,
        # step the fine index by exact face arithmetic
        depth_new = state.depth + tau
        pos_new = state.pos + t_min[:, None] * d
        face_f = jnp.take_along_axis(f_bound, exit_axis[:, None], axis=1)[:, 0]
        on_axis = jnp.arange(3)[None, :] == exit_axis[:, None]
        pos_new = jnp.where(on_axis & ~cut[:, None],
                            (face_f / n2)[:, None], pos_new)
        pos_dir = d_safe > 0
        new_axis_idx = jnp.where(
            jnp.take_along_axis(pos_dir, exit_axis[:, None], axis=1)[:, 0],
            face_f, face_f - 1).astype(cf.dtype)
        # non-crossing axes: relocalize from position (handles coarse->fine
        # entry where the fine sub-cell must be picked).  Nudge downwind by
        # ~1e-6 of a fine cell so a position sitting exactly on a face
        # resolves to the cell the ray is entering — otherwise a ray born on
        # a face flip-flops between neighbors on zero-length segments.
        # direction-aware relocalization: a position exactly on a face
        # belongs to the cell the ray is ENTERING.  The tolerance must
        # exceed the position ulp at the grid scale (f32: ulp(pos*n2)
        # reaches 2^-13 cells at 1024^3 effective resolution) — a
        # sub-ulp nudge lets corner hits desync pos/cell into a
        # zero-step period-2 limit cycle: the non-crossing axis
        # relocalizes to the wrong side of its face each step while the
        # crossing axis undoes it, freezing the ray alive forever (the
        # round-5 production zombie rays that ran the final phase to its
        # 12k-step cap for 6 lanes).  f64 keeps the legacy fine
        # tolerance (parity mode).
        tol = 2.0 ** -10 if pos_new.dtype.itemsize < 8 else 1.0e-6
        cf_from_pos = jnp.clip(
            (pos_new * n2 + jnp.sign(d_safe) * tol).astype(cf.dtype),
            0, n2 - 1)
        cell_new = jnp.where(on_axis, new_axis_idx[:, None], cf_from_pos)
        cell_new = jnp.where(cut[:, None], state.cell, cell_new)

        out_of_box = jnp.any((cell_new < 0) | (cell_new >= n2), axis=1) & ~cut
        # kill on the THREE ionization depths only (equiSources.f90:3241)
        killed_tau = jnp.min(depth_new[:, :3], axis=1) > tau_kill
        if use_rem_kill:
            killed_tau = killed_tau | (rem < rem_floor)

        hit_boundary = active & out_of_box
        beyond = out_radii[None, :] > r2[:, None]
        bnd_acc = bnd_acc + jnp.where(beyond & hit_boundary[:, None],
                                      state.ndot[:, None], 0.0)

        alive_new = active & ~out_of_box & ~killed_tau & ~will_split
        split_new = state.split | (active & will_split & ~killed_tau)

        state = dataclasses.replace(
            state, pos=jnp.where(active[:, None], pos_new, state.pos),
            cell=jnp.where(active[:, None], cell_new, state.cell),
            radius=jnp.where(active, radius_new, state.radius),
            depth=jnp.where(active[:, None], depth_new, state.depth),
            alive=alive_new, split=split_new,
            crossed=crossed, cross_depth=cross_depth)
        return state, rem_acc, bnd_acc, rfb, rff, it + 1

    def cond(carry):
        state, _, _, _, _, it = carry
        return jnp.any(state.alive) & (it < max_steps)

    state, rem_acc, bnd_acc, rfb, rff, _ = jax.lax.while_loop(
        cond, step, (state, rem_acc0, bnd_acc0, rfb, rff, jnp.int32(0)))
    diag = dataclasses.replace(
        diag,
        ndot_remaining=diag.ndot_remaining.at[src_of_ray].add(rem_acc),
        ndot_boundary=diag.ndot_boundary.at[src_of_ray].add(bnd_acc))
    return state, diag, rfb, rff


def _trace_all_phases_amr(fields, init_state, tables, geom, n_sources,
                          dust_approximation, max_pixel_level, dtype,
                          rates_mode: str = "table",
                          rel_kill: float | None = None):
    n = geom.nx
    if rel_kill is None:
        rel_kill = 0.0 if jnp.dtype(dtype).itemsize >= 8 else 1.0e-10
    n2 = 2 * n
    rmax = rmax_table()
    diag = RayDiagnostics.zeros(n_sources, dtype)
    rfb = RateFields(*[jnp.zeros(n ** 3, dtype) for _ in range(6)])
    rff = RateFields(*[jnp.zeros(n2 ** 3, dtype) for _ in range(6)])
    fields_pk = {
        "base": _pack_fields(fields["HI"], fields["HeI"], fields["HeII"],
                             fields["nH"], fields["abun2"]),
        "fine": _pack_fields(fields["HI_f"], fields["HeI_f"],
                             fields["HeII_f"], fields["nH_f"],
                             fields["abun2_f"]),
        "refined": fields["refined"],
    }
    if rates_mode == "quadrature":
        rate_ctx = ("quadrature", (jnp.asarray(tables["quad_A"], dtype),
                                   jnp.asarray(tables["quad_W"], dtype)))
    else:
        rate_ctx = ("table", _pack_tables(tables["reaction_log"],
                                          tables["energy_log"]))
    state = init_state

    sig_ratio = jnp.stack([
        jnp.asarray(tables["output_sigma24"], dtype) / SIGMA24_AT_NU1,
        jnp.asarray(tables["output_sigma26"], dtype) / SIGMA26_AT_NU2,
        jnp.asarray(tables["output_sigma25"], dtype) / SIGMA25_AT_NU3,
        jnp.asarray(tables["output_sigma_dust"], dtype) / SIGMA_DUST_AT_NU1,
    ])

    for level in range(1, max_pixel_level + 1):
        last = level == max_pixel_level
        r_stop = rmax[level - 1]
        max_steps = int(12 * n + 64) if last else int(6 * (r_stop + 2) + 32)
        rays_per_source = 12 * 4 ** (level - 1)
        src_of_ray = jnp.repeat(jnp.arange(n_sources, dtype=jnp.int32),
                                rays_per_source)
        state, diag, rfb, rff = _march_phase_amr(
            state, fields_pk, geom, rate_ctx, diag, rfb, rff,
            r_stop, last, dust_approximation, max_steps, src_of_ray,
            rel_kill=rel_kill)

        spec_tau = jnp.dot(state.cross_depth, sig_ratio,
                           precision=_HIGHEST)
        contrib = jnp.where(state.crossed[:, None],
                            state.ndot[:, None] * jnp.exp(-spec_tau), 0.0)
        diag = dataclasses.replace(
            diag, ndot_spectrum=diag.ndot_spectrum.at[src_of_ray].add(contrib))
        state = dataclasses.replace(state, crossed=jnp.zeros_like(state.crossed))

        if not last:
            state, in_box, was_split = _split_rays(state, level, n, dtype, cell_grid=n2)
            lost = was_split & ~in_box
            out_radii = jnp.asarray(np.array(OUTPUT_RADII_KPC) * KPC, dtype)
            r2 = state.radius * geom.cell_size
            beyond = out_radii[None, :] > r2[:, None]
            src4 = jnp.repeat(src_of_ray, 4)
            diag = dataclasses.replace(
                diag, ndot_boundary=diag.ndot_boundary
                .at[src4].add(jnp.where(beyond & lost[:, None],
                                        state.ndot[:, None], 0.0)))

    return rfb, rff, diag


_TRACER_CACHE: dict = {}


def trace_point_sources_amr(amr_state, geom, sources: SourceBatch, tables,
                            dust_approximation: int = NO_DUST,
                            max_pixel_level: int = MAX_PIXEL_LEVEL,
                            dtype=jnp.float64, rates_mode: str = "auto"):
    """Trace sources through a two-level AMRState.

    Returns (RateFields base, RateFields fine, RayDiagnostics).
    rates_mode: see core.rays.trace_point_sources.
    """
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    n = geom.nx
    n2 = 2 * n
    b, f = amr_state.base, amr_state.fine
    fields = {
        "HI": b.HI.reshape(-1).astype(dtype),
        "HeI": b.HeI.reshape(-1).astype(dtype),
        "HeII": b.HeII.reshape(-1).astype(dtype),
        "nH": b.nh.reshape(-1).astype(dtype),
        "abun2": b.abun2.reshape(-1).astype(dtype),
        "HI_f": f.HI.reshape(-1).astype(dtype),
        "HeI_f": f.HeI.reshape(-1).astype(dtype),
        "HeII_f": f.HeII.reshape(-1).astype(dtype),
        "nH_f": f.nh.reshape(-1).astype(dtype),
        "abun2_f": f.abun2.reshape(-1).astype(dtype),
        "refined": amr_state.refined.reshape(-1),
    }
    state = _spawn_phase(sources, 1, dtype)
    state = dataclasses.replace(
        state, cell=jnp.clip((state.pos * n2).astype(jnp.int32), 0, n2 - 1))
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}
    key = (geom, sources.n_sources, dust_approximation, max_pixel_level,
           jnp.dtype(dtype).name, rates_mode)
    if key not in _TRACER_CACHE:
        _TRACER_CACHE[key] = jax.jit(
            partial(_trace_all_phases_amr, geom=geom,
                    n_sources=sources.n_sources,
                    dust_approximation=dust_approximation,
                    max_pixel_level=max_pixel_level, dtype=dtype,
                    rates_mode=rates_mode))
    return _TRACER_CACHE[key](fields, state, tables_dev)
