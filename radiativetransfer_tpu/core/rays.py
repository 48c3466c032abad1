"""Point-source long-ray tracer.

The reference traces rays recursively, one source at a time, splitting each
ray 1->4 when the HEALPix inter-ray spacing exceeds a cell size
(startNewLongRay/drawSegment, /root/reference/equiSources.f90:2412-2595,
3120-3385).  The split radii rmax(l) depend only on the pixel level
(equiSources.f90:304-309), so on a uniform grid the recursion flattens into
LEVEL-SYNCHRONOUS PHASES:

  phase l = 1..maxPixelLevel: all rays of all sources at pixel level l march
  in lockstep from radius rmax(l-1) to rmax(l) (phase 1 starts at 0; the
  final phase marches until absorption tau>100 or the box boundary).  At a
  phase boundary every surviving ray spawns its 4 NESTED child pixels with
  ndot/4 and a lateral position adjustment (equiSources.f90:3303-3378).

Each march step is fully vectorized over the ray batch: distance-to-face
(min over 3 axes), optical-depth accumulation for the 4 channels
(HI/HeI/HeII/dust), 4-D table lookups for the photoionization/heating
deposits, and scatter-add of the per-cell rates.  Escape fractions at the 7
output radii and the emergent spectrum are accumulated on the fly
(equiSources.f90:3198-3233).
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
    MH,
    NENERGY,
    NO_DUST,
    NO_SUBLIMATION,
    N_RADIUS,
    OUTPUT_RADII_KPC,
    PSI,
    SIGMA24_AT_NU1,
    SIGMA25_AT_NU3,
    SIGMA26_AT_NU2,
    SIGMA_DUST_AT_NU1,
    rmax_table,
)
from ..geometry import healpix

# f32 products would otherwise be allowed to run in TF32 on the GPU, which
# keeps ~3 digits of optical depths that reach tau_kill
_HIGHEST = jax.lax.Precision.HIGHEST

_TAU_KILL = 100.0  # early ray termination (equiSources.f90:3241)
# f32 default: beyond tau=30 every band's transmission e^-tau < 1e-13 is
# below float32 resolution of any accumulated rate, so the reference's
# conservative 100 (a float64-era bound) triples the marching distance of
# rays in neutral gas for deposits that round to zero.  Measured: the
# f64 rate fields at kill=30 vs kill=100 agree to ~e^-30 relative
# (tests/test_rays.py::test_tau_kill_f32_equivalence).
_TAU_KILL_F32 = 30.0


def default_tau_kill(dtype) -> float:
    return _TAU_KILL if jnp.dtype(dtype).itemsize >= 8 else _TAU_KILL_F32


def _default_unroll() -> int:
    """March steps per while body: >1 amortizes the per-iteration cost of
    the device while-loop (its condition and the fixed cost of each
    scatter-add) but multiplies trace/compile time, so CPU (tests,
    oracles) keeps single-step bodies."""
    return 1 if jax.devices()[0].platform == "cpu" else 4


@dataclasses.dataclass(frozen=True)
class SourceBatch:
    """Sources prepared for tracing (host NumPy; static per iteration)."""
    position: np.ndarray    # (S, 3) box units [0,1)
    weight: np.ndarray      # (S,) merged particle multiplicity
    table_idx: np.ndarray   # (S,) index into the stacked SED tables

    @property
    def n_sources(self) -> int:
        return self.position.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RayDiagnostics:
    """Per-source escape-fraction and emergent-spectrum accumulators
    (localDefinitions, equiSources.f90:6-15; the reference resets these per
    source in its serial loop, :1266-1270)."""
    ndot_remaining: jax.Array   # (S, nradius)
    ndot_boundary: jax.Array    # (S, nradius)
    ndot_spectrum: jax.Array    # (S, nenergy)

    @classmethod
    def zeros(cls, n_sources: int, dtype=jnp.float32) -> "RayDiagnostics":
        return cls(ndot_remaining=jnp.zeros((n_sources, N_RADIUS), dtype),
                   ndot_boundary=jnp.zeros((n_sources, N_RADIUS), dtype),
                   ndot_spectrum=jnp.zeros((n_sources, NENERGY), dtype))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class _RayState:
    pos: jax.Array        # (R, 3) box units
    direction: jax.Array  # (R, 3)
    cell: jax.Array       # (R, 3) int32
    radius: jax.Array     # (R,) base-cell units
    ndot: jax.Array       # (R,)
    depth: jax.Array      # (R, 4) tau at the 4 thresholds
    alive: jax.Array      # (R,) bool: still marching this phase
    split: jax.Array      # (R,) bool: survived to the split radius
    table_idx: jax.Array  # (R,) int32
    # outer-radius crossing record for the emergent spectrum
    crossed: jax.Array    # (R,) bool
    cross_depth: jax.Array  # (R, 4)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RateFields:
    """Per-cell photo deposit accumulators, flattened (n^3,)."""
    krate24: jax.Array
    krate25: jax.Array
    krate26: jax.Array
    crate24: jax.Array
    crate25: jax.Array
    crate26: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NoneqRateFields(RateFields):
    """RateFields plus the secondary photo channels of the non-equilibrium
    network (quadrature mode only): PER-PARTICLE rates [1/s] for
    k27 (H- detachment), k28/k30 (H2+), k29 (H2 ionization),
    k31 (Lyman-Werner) — see tables.stellar.quadrature_noneq_weights."""
    krate27: jax.Array
    krate28: jax.Array
    krate29: jax.Array
    krate30: jax.Array
    krate31: jax.Array


def _base_directions(n_rays_per_source: int, level: int) -> np.ndarray:
    nside = 2 ** (level - 1)
    phi, theta = healpix.pix2ang_nest(nside, np.arange(n_rays_per_source))
    return healpix.direction_vectors(phi, theta)


def _pack_tables(reaction_log, energy_log):
    """Pack the per-bucket 4-D log tables (B,3,n1,n2,n3,n4) x2 into one
    flattened (B*n1*n2*n3*n4, 6) array whose 6 channels
    [reaction band 1..3, energy band 1..3] are contiguous per tau corner —
    the whole per-corner payload becomes ONE single-axis gather row."""
    r = jnp.moveaxis(reaction_log, 1, -1)
    e = jnp.moveaxis(energy_log, 1, -1)
    return jnp.concatenate([r, e], axis=-1).reshape(-1, 6)


def _pack_fields(*cols):
    """Stack flattened grid fields into (ncells, k) so all per-cell scalars
    come back in one gather row."""
    return jnp.stack([c.reshape(-1) for c in cols], axis=1)


_ACTIVE_FIELDS = {1: (0, 3), 2: (0, 3, 2, 5), 3: (0, 1, 2, 3, 4, 5)}


def _march_phase(state: _RayState, fields_pk, geom, rate_ctx,
                 diag: RayDiagnostics, rf: RateFields, r_stop: float,
                 last_phase: bool, dust_approximation: int, max_steps: int,
                 src_of_ray, n_bands: int = 3, tau_kill: float = _TAU_KILL,
                 unroll: int = 1, rel_kill: float = 0.0):
    """March all rays of one phase until they die or reach r_stop.

    fields_pk: packed (n^3, 5) array [HI, HeI, HeII, nH, abun2].
    rate_ctx: ("table", table_flat) or ("quadrature", (quad_A, quad_W)).

    Per-step structure (the tracer is random-access bound, not FLOP
    bound; scripts/roofline_tracer.py): per-cell scalars come back in one
    row gather; in table mode the 4 attenuation states (entry + 3
    advanced channels) interpolate in ONE batched row-gather call rather
    than per-channel scalar gathers; the escape-fraction/boundary
    diagnostics accumulate in per-ray carry buffers reduced to
    per-source totals once per phase.

    unroll: march steps per while-loop body.  Each while iteration and
    each scatter-add call carry a fixed cost regardless of size;
    unrolling U steps per body and concatenating the U deposit batches
    into ONE scatter-add per channel amortizes both (the deposit sums
    are order-insensitive up to f32 rounding).

    rel_kill (quadrature modes only): kill a ray when its remaining
    depositable weight over the WHOLE surviving spectrum, rem = e0 @ wsum
    with e0 = exp(-depth @ A), drops below rel_kill of its undepleted
    value.  The reference's kill min(tau1,tau2,tau3) > 100
    (equiSources.f90:3241) never fires when one threshold species is
    absent (e.g. HeII ~ 0 keeps tau3 ~ 0) even though every frequency of
    the ray's spectrum is extinct through the sigma(nu) tails of the
    OTHER species — such rays march to the box wall depositing exact
    zeros.  rem tracks the true attenuated spectrum, so rel_kill = 1e-10
    terminates rays whose remaining deposits are below f32 resolution of
    their own scale.  0 disables (reference parity semantics).
    """
    n = geom.nx
    cell_size = geom.cell_size
    dtype = state.ndot.dtype
    out_radii = jnp.asarray(np.array(OUTPUT_RADII_KPC) * KPC, dtype)
    R = state.pos.shape[0]
    rem_acc0 = jnp.zeros((R, out_radii.shape[0]), dtype)
    bnd_acc0 = jnp.zeros((R, out_radii.shape[0]), dtype)

    rates_mode = rate_ctx[0]
    use_rem_kill = rates_mode.startswith("quadrature") and rel_kill > 0.0
    if use_rem_kill:
        # spectral weight envelope: the largest |W| any bucket/channel
        # assigns to each frequency; rem = e0 @ wsum bounds every
        # channel's remaining deposit for every bucket
        quad_A = rate_ctx[1][0]
        wsum = jnp.max(jnp.sum(jnp.abs(rate_ctx[1][1]), axis=2), axis=0)
        if len(rate_ctx[1]) > 2:
            # quadrature_noneq also deposits the k27..k31 channels from
            # quad_W27, whose spectral support can exceed quad_W's — the
            # kill envelope must bound those deposits too
            wsum = jnp.maximum(wsum, jnp.max(
                jnp.sum(jnp.abs(rate_ctx[1][2]), axis=2), axis=0))
        rem_floor = rel_kill * jnp.sum(wsum)

    def flat_idx(cell):
        return (cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2]

    def substep(state, rem_acc, bnd_acc):
        d = state.direction
        d_safe = jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
        # distance to the exit face along each axis (drawSegment,
        # equiSources.f90:2444-2475), in box units
        bound = (state.cell + (d_safe > 0.0)) / n
        t_ax = (bound - state.pos) / d_safe
        # f32 position round-off can overshoot a face, making the
        # next crossing distance slightly negative; the exact value
        # is 0 (drawSegment's geometry is nonnegative), and leaving
        # it negative walks pos backward while the cell index
        # advances, compounding the desync until tau diverges
        t_min = jnp.maximum(jnp.min(t_ax, axis=1), 0.0)
        exit_axis = jnp.argmin(t_ax, axis=1)
        seg_cells = t_min * n            # length in base-cell units

        # split-radius cut (equiSources.f90:2491-2592)
        radius_new = state.radius + seg_cells
        if last_phase:
            will_split = jnp.zeros_like(state.alive)
            cut = jnp.zeros_like(state.alive)
        else:
            will_split = radius_new >= r_stop
            cut = will_split
            seg_cells = jnp.where(cut, jnp.maximum(r_stop - state.radius, 0.0),
                                  seg_cells)
            radius_new = state.radius + seg_cells
            t_min = seg_cells / n

        active = state.alive
        plen = seg_cells * cell_size      # physical segment length [cm]

        # dead rays carry frozen (possibly out-of-box) cells: clip so the
        # gather contract is explicitly in-bounds (their values are masked
        # by `active` below; checkify-clean, SURVEY 5.2)
        idx = jnp.clip(flat_idx(state.cell), 0, n * n * n - 1)
        fv = fields_pk[idx]               # (R, 5): HI, HeI, HeII, nH, abun2
        hi, hei, heii = fv[:, 0], fv[:, 1], fv[:, 2]
        # threshold optical depths (equiSources.f90:3180-3196)
        tau1 = plen * hi * SIGMA24_AT_NU1
        tau2 = plen * hei * SIGMA26_AT_NU2
        tau3 = plen * heii * SIGMA25_AT_NU3
        if dust_approximation == NO_DUST:
            taud = jnp.zeros_like(tau1)
        elif dust_approximation == COMPLETE_SUBLIMATION:
            taud = plen * hi * SIGMA_DUST_AT_NU1 * fv[:, 4] / 0.2
        else:  # NO_SUBLIMATION
            taud = plen * fv[:, 3] * SIGMA_DUST_AT_NU1 * fv[:, 4] / 0.2
        tau = jnp.stack([tau1, tau2, tau3, taud], axis=1)
        tau = jnp.where(active[:, None], jnp.maximum(tau, 0.0), 0.0)
        # re-read the masked components: dead rays carry frozen (possibly
        # out-of-box) state whose raw segment values can be huge or
        # NEGATIVE (t_min < 0), and a negative tau overflows exp() to inf
        # in the deposit math, which w=0 then turns into scattered NaNs
        tau1, tau2, tau3, taud = tau[:, 0], tau[:, 1], tau[:, 2], tau[:, 3]
        plen = jnp.where(active, plen, 0.0)

        # ---- escape-fraction bookkeeping (equiSources.f90:3198-3226) ----
        r1 = state.radius * cell_size
        r2 = radius_new * cell_size
        in_seg = (out_radii[None, :] >= r1[:, None]) & (out_radii[None, :] <= r2[:, None])
        in_seg = in_seg & active[:, None]
        ratio = jnp.where(in_seg,
                          (out_radii[None, :] - r1[:, None])
                          / jnp.maximum((r2 - r1)[:, None], 1e-30), 0.0)
        esc = state.ndot[:, None] * jnp.exp(
            -(ratio * (tau1 + taud)[:, None] + (state.depth[:, 0] + state.depth[:, 3])[:, None]))
        rem_acc = rem_acc + jnp.where(in_seg, esc, 0.0)
        # outermost-radius crossing record for the emergent spectrum
        crossing = in_seg[:, -1] & ~state.crossed
        cross_depth = jnp.where(
            crossing[:, None],
            state.depth + ratio[:, -1:] * tau, state.cross_depth)
        crossed = state.crossed | crossing

        # ---- rate deposits (equiSources.f90:3243-3260) ----
        # the krate/crate increments are entry-minus-exit rate differences
        # per channel, where "exit" advances only that channel's tau
        w = jnp.where(active, state.ndot, 0.0)
        d0 = state.depth
        if rates_mode == "table":
            # entry + 3 advanced states interpolate in one batched call
            depths4 = jnp.concatenate([
                d0, d0.at[:, 0].add(tau1), d0.at[:, 1].add(tau2),
                d0.at[:, 2].add(tau3)], axis=0)
            tidx4 = jnp.concatenate([state.table_idx] * 4)
            v = _interp_flat(rate_ctx[1], tidx4, depths4,
                             dust_approximation != NO_DUST)
            v_in, v_a1, v_a2, v_a3 = jnp.split(v, 4, axis=0)
            deposit = (
                w * (v_in[:, 0] - v_a1[:, 0]),   # krate24
                w * (v_in[:, 2] - v_a3[:, 2]),   # krate25
                w * (v_in[:, 1] - v_a2[:, 1]),   # krate26
                w * (v_in[:, 3] - v_a1[:, 3]),   # crate24
                w * (v_in[:, 5] - v_a3[:, 5]),   # crate25
                w * (v_in[:, 4] - v_a2[:, 4]),   # crate26
            )
        else:
            quad_A, quad_W = rate_ctx[1][:2]
            dtau = jnp.stack([tau1, tau2, tau3], axis=1)
            dq = _deposit_quadrature(d0, dtau, quad_A, quad_W,
                                     state.table_idx, w, n_bands,
                                     wsum=wsum if use_rem_kill else None)
            deposit, rem = dq if use_rem_kill else (dq, None)
            if rates_mode == "quadrature_noneq":
                deposit = deposit + _deposit_noneq(
                    d0, quad_A, rate_ctx[1][2], state.table_idx, w, plen)

        # ---- advance ----
        depth_new = state.depth + tau
        pos_new = state.pos + t_min[:, None] * d
        step_dir = jnp.where(d_safe > 0, 1, -1).astype(state.cell.dtype)
        hop = jax.nn.one_hot(exit_axis, 3, dtype=state.cell.dtype) * step_dir
        cell_new = jnp.where(cut[:, None], state.cell, state.cell + hop)
        # snap the crossing coordinate onto the face to avoid drift
        face = jnp.take_along_axis(bound, exit_axis[:, None], axis=1)[:, 0]
        pos_new = jnp.where((jnp.arange(3)[None, :] == exit_axis[:, None]) & ~cut[:, None],
                            face[:, None], pos_new)

        out_of_box = jnp.any((cell_new < 0) | (cell_new >= n), axis=1) & ~cut
        # kill on the THREE ionization depths only (equiSources.f90:3241);
        # the dust depth stays 0 with dust off and must not veto the kill
        killed_tau = jnp.min(depth_new[:, :3], axis=1) > tau_kill
        if use_rem_kill:
            # spectrum-exhaustion kill: the entry-depth remaining weight
            # already sits below the floor (see docstring)
            killed_tau = killed_tau | (rem < rem_floor)

        # boundary accounting (equiSources.f90:3228-3233)
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
        return state, rem_acc, bnd_acc, idx, deposit

    # only the statically-active band channels issue a scatter (H-only
    # runs cut the deposit scatters 3x via n_bands=1)
    active_ch = _ACTIVE_FIELDS[n_bands]
    if rates_mode == "quadrature_noneq":
        active_ch = active_ch + (6, 7, 8, 9, 10)

    def body(carry):
        state, rem_acc, bnd_acc, rf, it = carry
        idxs, deps = [], []
        for _ in range(unroll):
            state, rem_acc, bnd_acc, idx, dep = substep(state, rem_acc,
                                                        bnd_acc)
            idxs.append(idx)
            deps.append(dep)
        cat_idx = jnp.concatenate(idxs) if unroll > 1 else idxs[0]
        new_fields = []
        for fi, f in enumerate(dataclasses.fields(rf)):
            buf = getattr(rf, f.name)
            if fi in active_ch:
                v = (jnp.concatenate([d[fi] for d in deps])
                     if unroll > 1 else deps[0][fi])
                buf = buf.at[cat_idx].add(v)
            new_fields.append(buf)
        rf = type(rf)(*new_fields)
        return state, rem_acc, bnd_acc, rf, it + unroll

    def cond(carry):
        state, _, _, _, it = carry
        return jnp.any(state.alive) & (it < max_steps)

    state, rem_acc, bnd_acc, rf, _ = jax.lax.while_loop(
        cond, body, (state, rem_acc0, bnd_acc0, rf, jnp.int32(0)))
    diag = dataclasses.replace(
        diag,
        ndot_remaining=diag.ndot_remaining.at[src_of_ray].add(rem_acc),
        ndot_boundary=diag.ndot_boundary.at[src_of_ray].add(bnd_acc))
    return state, diag, rf


def _deposit_quadrature(d0, dtau, quad_A, quad_W, table_idx, w, n_bands=3,
                        wsum=None):
    """Deposit diffs by direct spectral quadrature (no table gathers).

    rate_c(tau) = sum_f W[b, f, c] exp(-tau . A[:, f])  exactly as the 4-D
    tables integrate it (stellarBetaTable.f90:217-285), so
      entry - exit  =  sum_f W e0_f (1 - exp(-dtau_j A[j, f])).

    The attenuation slopes A are bucket-INDEPENDENT (pure cross-section
    ratios), so the expensive exp fields are computed once; per-bucket SED
    weights enter only through cheap (R,F)@(F,) matmuls, selected per ray
    by mask.  d0: (R, 4); dtau: (R, 3); quad_A: (4, F); quad_W: (B, F, 6);
    w: (R,) ray weights.  Returns the 6 deposit arrays in RateFields order
    [krate24, krate25, krate26, crate24, crate25, crate26].

    wsum: optional (F,) spectral weight envelope; when given, also returns
    rem = e0 @ wsum, the ray's remaining depositable weight over its whole
    surviving spectrum (used for the f32 precision kill — see
    _march_phase).
    """
    e0 = jnp.exp(-jnp.dot(d0, quad_A, precision=_HIGHEST))   # (R, F)
    B = quad_W.shape[0]
    zero = jnp.zeros_like(w)
    out = {j: (zero, zero) for j in range(3)}
    for j in range(n_bands):
        fj = -jnp.expm1(-dtau[:, j:j + 1] * quad_A[j][None, :])
        g = e0 * fj                                  # (R, F)
        num = heat = 0.0
        for b in range(B):
            num_b = jnp.dot(g, quad_W[b, :, j], precision=_HIGHEST)
            heat_b = jnp.dot(g, quad_W[b, :, j + 3], precision=_HIGHEST)
            if B == 1:
                num, heat = num_b, heat_b
            else:
                sel = table_idx == b
                num = num + jnp.where(sel, num_b, 0.0)
                heat = heat + jnp.where(sel, heat_b, 0.0)
        out[j] = (w * num, w * heat)
    deposit = (out[0][0], out[2][0], out[1][0],
               out[0][1], out[2][1], out[1][1])
    if wsum is not None:
        return deposit, jnp.dot(e0, wsum, precision=_HIGHEST)
    return deposit


def _deposit_noneq(d0, quad_A, quad_W27, table_idx, w, plen):
    """Secondary-channel per-particle photo rates k27..k31 [1/s] for one
    segment: Gamma_c = ndot * plen/V * sum_f W27[f, c] exp(-tau . A[:, f])
    (tables.stellar.quadrature_noneq_weights; the 1/V is folded into W27
    at StellarContext.build).  Returns the 5 deposit arrays in
    NoneqRateFields order [k27, k28, k29, k30, k31]."""
    e0 = jnp.exp(-jnp.dot(d0, quad_A, precision=_HIGHEST))   # (R, F)
    B = quad_W27.shape[0]
    scale = w * plen
    out = []
    for c in range(5):
        v = 0.0
        for b in range(B):
            vb = jnp.dot(e0, quad_W27[b, :, c], precision=_HIGHEST)
            v = vb if B == 1 else v + jnp.where(table_idx == b, vb, 0.0)
        out.append(scale * v)
    return tuple(out)


def _interp_flat(table_flat, table_idx, depths, dust_on):
    """Quad-linear log-space interpolation over the packed SED tables
    (getRatesHydrogenHelium, equiSources.f90:4157-4311).

    table_flat: (B*n1*n2*n3*n4, 6) from _pack_tables; table_idx: (R,);
    depths: (R, 4).  Returns (R, 6) [number bands 1..3, heat bands 1..3].

    Each of the 16 tau corners is ONE single-axis gather of a contiguous
    6-value row: a 5-axis advanced-indexing form lowers to a general
    scatter-gather, and separate reaction/energy tables would double the
    gather count.
    """
    from ..constants import (MAX_OPTICAL_DEPTH1, MAX_OPTICAL_DEPTH2,
                             MAX_OPTICAL_DEPTH3, MAX_OPTICAL_DEPTH_DUST,
                             NDEPTH1, NDEPTH2, NDEPTH3, NDEPTH_DUST)
    t1, t2, t3, td = depths[:, 0], depths[:, 1], depths[:, 2], depths[:, 3]
    oor = ((t1 > MAX_OPTICAL_DEPTH1) | (t2 > MAX_OPTICAL_DEPTH2)
           | (t3 > MAX_OPTICAL_DEPTH3) | (td > MAX_OPTICAL_DEPTH_DUST))

    def idx_coef(tau, ndepth, maxdepth):
        pos = jnp.clip(tau, 0.0, maxdepth) / maxdepth * ndepth
        i = jnp.clip(pos.astype(jnp.int32), 0, ndepth - 1)
        return i, pos - i

    i1, c1 = idx_coef(t1, NDEPTH1, MAX_OPTICAL_DEPTH1)
    i2, c2 = idx_coef(t2, NDEPTH2, MAX_OPTICAL_DEPTH2)
    i3, c3 = idx_coef(t3, NDEPTH3, MAX_OPTICAL_DEPTH3)
    if dust_on:
        i4, c4 = idx_coef(td, NDEPTH_DUST, MAX_OPTICAL_DEPTH_DUST)
        d4_range = (0, 1)
    else:
        # dust off: c4 == 0 identically, so the d4 = 1 corners carry zero
        # weight — skip them and halve the gather count
        i4, c4 = jnp.zeros_like(i1), jnp.zeros_like(c1)
        d4_range = (0,)

    n1, n2_, n3, n4 = NDEPTH1 + 1, NDEPTH2 + 1, NDEPTH3 + 1, NDEPTH_DUST + 1
    base_flat = table_idx * (n1 * n2_ * n3 * n4)

    acc = 0.0
    for d1 in (0, 1):
        w1 = c1 if d1 else (1.0 - c1)
        for d2 in (0, 1):
            w2 = c2 if d2 else (1.0 - c2)
            for d3 in (0, 1):
                w3 = c3 if d3 else (1.0 - c3)
                for d4 in d4_range:
                    w = w1 * w2 * w3
                    if dust_on:
                        w = w * (c4 if d4 else (1.0 - c4))
                    f = (((i1 + d1) * n2_ + (i2 + d2)) * n3
                         + (i3 + d3)) * n4 + (i4 + d4) + base_flat
                    acc = acc + w[:, None] * table_flat[f]
    live = jnp.where(oor, 0.0, 1.0)[:, None]
    return jnp.exp(acc) * live


def _interp_bucketed(reaction_log, energy_log, table_idx, depths, dust_on):
    """Back-compat wrapper: (number, heat) each (R, 3) from the separate
    per-bucket tables (used by the AMR tracer's tests/pathways)."""
    v = _interp_flat(_pack_tables(reaction_log, energy_log), table_idx,
                     depths, dust_on)
    return v[:, :3], v[:, 3:]


def _spawn_phase(sources: SourceBatch, level: int, dtype) -> _RayState:
    """Initial rays of phase 1: 12 base HEALPix rays per source
    (equiSources.f90:1308-1329)."""
    S = sources.n_sources
    dirs = _base_directions(12, 1)
    pos = np.repeat(sources.position, 12, axis=0)
    direction = np.tile(dirs, (S, 1))
    ndot = np.repeat(sources.weight, 12) / 12.0
    tidx = np.repeat(sources.table_idx, 12)
    R = S * 12
    return _RayState(
        pos=jnp.asarray(pos, dtype),
        direction=jnp.asarray(direction, dtype),
        cell=jnp.zeros((R, 3), jnp.int32),  # set by caller from pos
        radius=jnp.zeros(R, dtype),
        ndot=jnp.asarray(ndot, dtype),
        depth=jnp.zeros((R, 4), dtype),
        alive=jnp.ones(R, bool),
        split=jnp.zeros(R, bool),
        table_idx=jnp.asarray(tidx, jnp.int32),
        crossed=jnp.zeros(R, bool),
        cross_depth=jnp.zeros((R, 4), dtype))


def _split_rays(state: _RayState, level: int, n: int, dtype,
                cell_grid: int | None = None) -> _RayState:
    """Spawn the 4 NESTED children of every ray marked for splitting
    (equiSources.f90:3294-3378).  Shapes are static: every parent slot
    produces 4 child slots; dead parents produce dead children.

    n is the BASE grid size (the radius unit, :3325); cell_grid is the
    resolution at which state.cell indices live (2n for the AMR tracer).
    """
    cell_grid = cell_grid or n
    R = state.pos.shape[0]
    nside_child = 2 ** level          # children live at pixel level level+1
    # parent pixel p (0-based) at level `level` is implicit in ray order:
    # rays are laid out [source-major, pixel-minor] and children preserve it.
    parent_pix = np.tile(np.arange(12 * 4 ** (level - 1)),
                         R // (12 * 4 ** (level - 1)))
    child_pix = (4 * parent_pix[:, None] + np.arange(4)[None, :]).reshape(-1)
    phi, theta = healpix.pix2ang_nest(nside_child, child_pix)
    child_dirs = jnp.asarray(healpix.direction_vectors(phi, theta), dtype)

    rep = lambda a: jnp.repeat(a, 4, axis=0)
    parent_dir = rep(state.direction)
    radius = rep(state.radius)
    # lateral repositioning: keep the child ray through the correct point of
    # the splitting sphere (equiSources.f90:3325-3332)
    pos = rep(state.pos) + (radius / n)[:, None] * (child_dirs - parent_dir)
    in_box = jnp.all((pos >= 0.0) & (pos <= 1.0), axis=1)
    cell = jnp.clip((pos * cell_grid).astype(jnp.int32), 0, cell_grid - 1)

    return _RayState(
        pos=pos, direction=child_dirs, cell=cell, radius=radius,
        ndot=rep(state.ndot) / 4.0,
        depth=rep(state.depth),
        alive=rep(state.split) & in_box,
        split=jnp.zeros(pos.shape[0], bool),
        table_idx=rep(state.table_idx),
        crossed=rep(state.crossed),
        cross_depth=rep(state.cross_depth)), in_box, rep(state.split)


def _trace_all_phases(fields, init_state: _RayState, tables, geom,
                      n_sources: int, dust_approximation: int,
                      max_pixel_level: int, dtype, rates_mode: str = "table",
                      n_bands: int = 3, tau_kill: float | None = None,
                      unroll: int | None = None,
                      rel_kill: float | None = None,
                      skip_last_phase: bool = False):
    """All phases of the trace; pure function of arrays, jitted via
    _get_tracer (the phase loop unrolls at trace time).

    skip_last_phase: stop after splitting into the final phase's rays and
    additionally return (state, fields_pk) — the host-driven compacting
    tracer (trace_point_sources_compact) runs the last phase itself."""
    n = geom.nx
    rmax = rmax_table()
    if unroll is None:
        unroll = _default_unroll()
    if tau_kill is None:
        tau_kill = default_tau_kill(dtype)
    if rel_kill is None:
        # f32: terminate rays whose whole remaining spectrum deposits
        # below 1e-10 of their undepleted scale; f64 keeps the exact
        # reference semantics for the parity oracles
        rel_kill = 0.0 if jnp.dtype(dtype).itemsize >= 8 else 1.0e-10
    diag = RayDiagnostics.zeros(n_sources, dtype)
    fields_pk = _pack_fields(fields["HI"], fields["HeI"], fields["HeII"],
                             fields["nH"], fields["abun2"])
    if rates_mode == "quadrature_noneq":
        rf = NoneqRateFields(*[jnp.zeros(n * n * n, dtype)
                               for _ in range(11)])
        rate_ctx = ("quadrature_noneq",
                    (jnp.asarray(tables["quad_A"], dtype),
                     jnp.asarray(tables["quad_W"], dtype),
                     jnp.asarray(tables["quad_W27"], dtype)))
    elif rates_mode == "quadrature":
        rf = RateFields(*[jnp.zeros(n * n * n, dtype) for _ in range(6)])
        rate_ctx = ("quadrature", (jnp.asarray(tables["quad_A"], dtype),
                                   jnp.asarray(tables["quad_W"], dtype)))
    else:
        rf = RateFields(*[jnp.zeros(n * n * n, dtype) for _ in range(6)])
        rate_ctx = ("table", _pack_tables(tables["reaction_log"],
                                          tables["energy_log"]))
    state = init_state

    sig_ratio = jnp.stack([
        jnp.asarray(tables["output_sigma24"], dtype) / SIGMA24_AT_NU1,
        jnp.asarray(tables["output_sigma26"], dtype) / SIGMA26_AT_NU2,
        jnp.asarray(tables["output_sigma25"], dtype) / SIGMA25_AT_NU3,
        jnp.asarray(tables["output_sigma_dust"], dtype) / SIGMA_DUST_AT_NU1,
    ])  # (4, nenergy)

    top = max_pixel_level if skip_last_phase else max_pixel_level + 1
    for level in range(1, top):
        last = level == max_pixel_level
        r_stop = rmax[level - 1]
        max_steps = int(6 * n + 64) if last else int(3 * (r_stop + 2) + 16)
        rays_per_source = 12 * 4 ** (level - 1)
        src_of_ray = jnp.repeat(jnp.arange(n_sources, dtype=jnp.int32),
                                rays_per_source)
        state, diag, rf = _march_phase(
            state, fields_pk, geom, rate_ctx, diag, rf, r_stop, last,
            dust_approximation, max_steps, src_of_ray, n_bands,
            tau_kill=tau_kill, unroll=max(1, min(unroll, max_steps)),
            rel_kill=rel_kill)

        # emergent spectrum from this phase's outer-radius crossings
        # (equiSources.f90:3206-3223)
        spec_tau = jnp.dot(state.cross_depth, sig_ratio,
                           precision=_HIGHEST)      # (R, nenergy)
        contrib = jnp.where(state.crossed[:, None],
                            state.ndot[:, None] * jnp.exp(-spec_tau), 0.0)
        diag = dataclasses.replace(
            diag, ndot_spectrum=diag.ndot_spectrum.at[src_of_ray].add(contrib))
        # only count each crossing once
        state = dataclasses.replace(state, crossed=jnp.zeros_like(state.crossed))

        if not last:
            state, in_box, was_split = _split_rays(state, level, n, dtype)
            # children spawned outside the box are boundary losses
            lost = was_split & ~in_box
            out_radii = jnp.asarray(np.array(OUTPUT_RADII_KPC) * KPC, dtype)
            r2 = state.radius * geom.cell_size
            beyond = out_radii[None, :] > r2[:, None]
            src4 = jnp.repeat(src_of_ray, 4)
            diag = dataclasses.replace(
                diag, ndot_boundary=diag.ndot_boundary
                .at[src4].add(jnp.where(beyond & lost[:, None],
                                        state.ndot[:, None], 0.0)))

    if skip_last_phase:
        # host-driven final phase (trace_point_sources_compact): hand back
        # the split-ready last-phase rays and the packed fields
        return rf, diag, state, fields_pk
    return rf, diag


_TRACER_CACHE: dict = {}


def _get_tracer(geom, n_sources: int, dust_approximation: int,
                max_pixel_level: int, dtype, rates_mode: str, n_bands: int,
                tau_kill: float | None = None, unroll: int | None = None,
                rel_kill: float | None = None):
    """Compiled tracer, cached on the static configuration so repeated
    iterations reuse the executable."""
    key = (geom, n_sources, dust_approximation, max_pixel_level,
           jnp.dtype(dtype).name, rates_mode, n_bands, tau_kill, unroll,
           rel_kill)
    if key not in _TRACER_CACHE:
        _TRACER_CACHE[key] = jax.jit(
            partial(_trace_all_phases, geom=geom, n_sources=n_sources,
                    dust_approximation=dust_approximation,
                    max_pixel_level=max_pixel_level, dtype=dtype,
                    rates_mode=rates_mode, n_bands=n_bands,
                    tau_kill=tau_kill, unroll=unroll, rel_kill=rel_kill))
    return _TRACER_CACHE[key]


def trace_point_sources(state_fields, geom, sources: SourceBatch, tables,
                        dust_approximation: int = NO_DUST,
                        max_pixel_level: int = MAX_PIXEL_LEVEL,
                        dtype=jnp.float64, rates_mode: str = "auto",
                        n_bands: int = 3, tau_kill: float | None = None,
                        unroll: int | None = None,
                        rel_kill: float | None = None):
    """Trace all sources; returns (RateFields on the grid, RayDiagnostics).

    state_fields: FieldState (dense (n,n,n) fields).
    tables: dict with 'reaction_log'/'energy_log' (B,3,11^4 shapes) and
            'output_sigma24/25/26/dust' + 'output_freq' (nenergy,);
            optionally 'quad_A' (4,F) / 'quad_W' (B,F,6) from
            tables.stellar.quadrature_arrays.

    rates_mode: 'table' interpolates the reference's 4-D attenuation
    tables (getRatesHydrogenHelium parity, zero outside tau in [0,10]^4);
    'quadrature' evaluates the same spectral sum directly (exact, no
    interpolation error, valid at any tau — two matmuls instead of 32
    gathers per segment); 'auto' picks quadrature
    when quad_A/quad_W are present; 'quadrature_noneq' additionally
    deposits the secondary photo channels k27..k31 (requires 'quad_W27'
    in tables; returns NoneqRateFields) for the non-equilibrium
    chemistry mode.

    n_bands (quadrature mode): number of frequency bands whose rate
    channels are deposited (1 = H-only runs, e.g. the Stromgren
    configuration — cuts the deposit scatters from 6 to 2).

    tau_kill: early-termination optical depth (None = dtype default:
    100 in f64 as the reference, 30 in f32 where e^-30 is already below
    float accumulation resolution).  unroll: march steps per while-loop
    body (amortizes per-iteration dispatch and scatter fixed costs).
    """
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    n = geom.nx
    fields = {
        "HI": state_fields.HI.reshape(-1).astype(dtype),
        "HeI": state_fields.HeI.reshape(-1).astype(dtype),
        "HeII": state_fields.HeII.reshape(-1).astype(dtype),
        "nH": state_fields.nh.reshape(-1).astype(dtype),
        "abun2": state_fields.abun2.reshape(-1).astype(dtype),
    }
    state = _spawn_phase(sources, 1, dtype)
    state = dataclasses.replace(
        state, cell=jnp.clip((state.pos * n).astype(jnp.int32), 0, n - 1))
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}
    tracer = _get_tracer(geom, sources.n_sources, dust_approximation,
                         max_pixel_level, dtype, rates_mode, n_bands,
                         tau_kill, unroll, rel_kill)
    return tracer(fields, state, tables_dev)


def escape_fractions(diag: RayDiagnostics, weights: np.ndarray) -> np.ndarray:
    """Per-source fraction(iradius) = remaining/(ndot1 - boundary)
    (equiSources.f90:1342-1348).  weights: (S,) merged multiplicities
    (= ndot1 per source).  Returns (S, nradius)."""
    nb = np.asarray(diag.ndot_boundary)
    nr = np.asarray(diag.ndot_remaining)
    w = np.asarray(weights, np.float64)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        frac = np.where(nb < w, nr / np.where(nb < w, w - nb, 1.0), 0.0)
    return frac


def cosmic_spectrum(diag: RayDiagnostics, weights: np.ndarray,
                    n_stars_specific_age: int) -> np.ndarray:
    """Emergent spectrum averaged over sources
    (equiSources.f90:1350-1366): sum_s w_s * spectrum_s/(w_s - boundary_s)
    divided by nStarsSpecificAge."""
    w = np.asarray(weights, np.float64)[:, None]
    nb = np.asarray(diag.ndot_boundary)[:, -1:]
    spec = np.asarray(diag.ndot_spectrum)
    denom = np.where(nb < w, w - nb, np.inf)
    return (w * spec / denom).sum(axis=0) / max(n_stars_specific_age, 1)


# ---------------------------------------------------------------------------
# Host-driven compacting tracer
# ---------------------------------------------------------------------------

_CHUNK_CACHE: dict = {}
_COMPACT_CACHE: dict = {}


def _bucket_size(count: int, floor: int = 1024) -> int:
    return 1 << max(count - 1, floor - 1).bit_length()


def _get_chunk_runner(key, geom, last: bool, r_stop: float, chunk: int,
                      dust_approximation: int, n_bands: int,
                      rates_mode: str, tau_kill: float, rel_kill: float,
                      dtype):
    """Jitted final-phase chunk: `chunk` march steps (one unrolled while
    body), per-chunk emergent-spectrum flush, alive count."""
    if key in _CHUNK_CACHE:
        return _CHUNK_CACHE[key]

    def run(fields_pk, state, diag, rf, src_of_ray, ctx_arrays, sig_ratio):
        rate_ctx = (rates_mode, ctx_arrays)
        state, diag, rf = _march_phase(
            state, fields_pk, geom, rate_ctx, diag, rf, r_stop, last,
            dust_approximation, chunk, src_of_ray, n_bands,
            tau_kill=tau_kill, unroll=chunk, rel_kill=rel_kill)
        # emergent-spectrum flush: identical to the per-phase flush of
        # _trace_all_phases, just at chunk granularity (each ray crosses
        # the outer radius at most once, so early flushing is exact)
        spec_tau = jnp.dot(state.cross_depth, sig_ratio,
                           precision=_HIGHEST)
        contrib = jnp.where(state.crossed[:, None],
                            state.ndot[:, None] * jnp.exp(-spec_tau), 0.0)
        diag = dataclasses.replace(
            diag,
            ndot_spectrum=diag.ndot_spectrum.at[src_of_ray].add(contrib))
        state = dataclasses.replace(state,
                                    crossed=jnp.zeros_like(state.crossed))
        return state, diag, rf, jnp.sum(state.alive.astype(jnp.int32))

    _CHUNK_CACHE[key] = jax.jit(run)
    return _CHUNK_CACHE[key]


def _get_compactor(r_to: int):
    """Jitted dead-lane compactor: stable-sort alive rays to the front and
    truncate to r_to slots.  Valid only in the FINAL phase (no later
    splits, so the [source-major, pixel-minor] layout _split_rays assumes
    is no longer needed) and only after the dropped rays' diagnostics are
    flushed (the chunk runner flushes every chunk)."""
    if r_to in _COMPACT_CACHE:
        return _COMPACT_CACHE[r_to]

    def compact(state, src_of_ray):
        order = jnp.argsort(~state.alive, stable=True)[:r_to]
        take = lambda x: x[order]
        return jax.tree_util.tree_map(take, state), src_of_ray[order]

    _COMPACT_CACHE[r_to] = jax.jit(compact)
    return _COMPACT_CACHE[r_to]


def trace_point_sources_compact(state_fields, geom, sources: SourceBatch,
                                tables,
                                dust_approximation: int = NO_DUST,
                                max_pixel_level: int = MAX_PIXEL_LEVEL,
                                dtype=jnp.float32, rates_mode: str = "auto",
                                n_bands: int = 3,
                                tau_kill: float | None = None,
                                rel_kill: float | None = None,
                                chunk: int = 16):
    """trace_point_sources with HOST-DRIVEN final-phase compaction.

    The final pixel level is 75-98% of the trace and its per-step cost is
    per-lockstep-LANE (scatter/gather rows; scripts/roofline_tracer.py),
    paid at full R even as rays die.  Here the final phase runs as jitted
    `chunk`-step calls from the host; between chunks the alive count is
    read back (one chunk LATE, so the host round trip overlaps the next
    chunk's execution) and the ray buffers are compacted to the
    next power-of-two bucket.  Alive counts are monotone within a phase,
    so a one-chunk-stale bound is always safe.

    Must be called EAGERLY (host control flow); the jittable
    trace_point_sources is unchanged for traced contexts.  Deposits land
    in a different scatter order, so fields match trace_point_sources to
    float-rounding (exact semantics otherwise; see
    tests/test_rays.py::TestCompactTracer).
    """
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    if tau_kill is None:
        tau_kill = default_tau_kill(dtype)
    if rel_kill is None:
        rel_kill = 0.0 if jnp.dtype(dtype).itemsize >= 8 else 1.0e-10
    n = geom.nx
    fields = {
        "HI": state_fields.HI.reshape(-1).astype(dtype),
        "HeI": state_fields.HeI.reshape(-1).astype(dtype),
        "HeII": state_fields.HeII.reshape(-1).astype(dtype),
        "nH": state_fields.nh.reshape(-1).astype(dtype),
        "abun2": state_fields.abun2.reshape(-1).astype(dtype),
    }
    state = _spawn_phase(sources, 1, dtype)
    state = dataclasses.replace(
        state, cell=jnp.clip((state.pos * n).astype(jnp.int32), 0, n - 1))
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}

    # phases 1..L-1 (cheap, must keep split layout): one jitted prefix
    key = ("prefix", geom, sources.n_sources, dust_approximation,
           max_pixel_level, jnp.dtype(dtype).name, rates_mode, n_bands,
           tau_kill, rel_kill)
    if key not in _TRACER_CACHE:
        _TRACER_CACHE[key] = jax.jit(
            partial(_trace_all_phases, geom=geom,
                    n_sources=sources.n_sources,
                    dust_approximation=dust_approximation,
                    max_pixel_level=max_pixel_level, dtype=dtype,
                    rates_mode=rates_mode, n_bands=n_bands,
                    tau_kill=tau_kill, rel_kill=rel_kill,
                    skip_last_phase=True))
    rf, diag, state, fields_pk = _TRACER_CACHE[key](fields, state,
                                                    tables_dev)

    if rates_mode == "quadrature_noneq":
        ctx_arrays = (jnp.asarray(tables_dev["quad_A"], dtype),
                      jnp.asarray(tables_dev["quad_W"], dtype),
                      jnp.asarray(tables_dev["quad_W27"], dtype))
    elif rates_mode == "quadrature":
        ctx_arrays = (jnp.asarray(tables_dev["quad_A"], dtype),
                      jnp.asarray(tables_dev["quad_W"], dtype))
    else:
        ctx_arrays = _pack_tables(tables_dev["reaction_log"],
                                  tables_dev["energy_log"])
    sig_ratio = jnp.stack([
        jnp.asarray(tables_dev["output_sigma24"], dtype) / SIGMA24_AT_NU1,
        jnp.asarray(tables_dev["output_sigma26"], dtype) / SIGMA26_AT_NU2,
        jnp.asarray(tables_dev["output_sigma25"], dtype) / SIGMA25_AT_NU3,
        jnp.asarray(tables_dev["output_sigma_dust"], dtype)
        / SIGMA_DUST_AT_NU1,
    ])

    rays_last = 12 * 4 ** (max_pixel_level - 1)
    src_of_ray = jnp.repeat(
        jnp.arange(sources.n_sources, dtype=jnp.int32), rays_last)
    r_stop = float(rmax_table()[max_pixel_level - 1])
    max_steps = int(6 * n + 64)
    bucket = state.pos.shape[0]

    steps = 0
    pending = None
    while steps < max_steps:
        runner = _get_chunk_runner(
            ("chunk", geom, bucket, chunk, dust_approximation, n_bands,
             rates_mode, tau_kill, rel_kill, r_stop, max_pixel_level,
             jnp.dtype(dtype).name),
            geom, True, r_stop, chunk,
            dust_approximation, n_bands, rates_mode, tau_kill, rel_kill,
            dtype)
        state, diag, rf, cnt = runner(fields_pk, state, diag, rf,
                                      src_of_ray, ctx_arrays, sig_ratio)
        steps += chunk
        if pending is not None:
            c = int(pending)          # chunk-late count; overlaps `runner`
            if c == 0:
                break
            nb = _bucket_size(c)
            if nb < bucket:
                state, src_of_ray = _get_compactor(nb)(state, src_of_ray)
                bucket = nb
        pending = cnt
    return rf, diag
