"""Block-sparse L-level diffuse sweep.

Same transport math as core.sweep_multilevel (the shared
_slab_gauss_seidel), but refined-level VOLUMES never materialize: per base
slab the scan body GATHERS each level's dense cross-section planes from
block storage (slot-map lookup + flat gather) and SCATTERS the slab's
leaf-masked Jmean back into per-level block accumulators carried through
the scan.  Memory is therefore

  O(n^3)  base level  +  O(leaves) blocks  +  O(finest cross-section) planes

instead of O((n 2^L)^3) dense volumes — the property that lets a production
128^3 + depth-4 grid fit one chip's HBM, matching the reference octree's
memory-per-leaf scaling (/root/reference/definitionsModule.f90:163-180).
Compute per slab stays dense over each level's cross-section (static-shape
full planes; wasted lanes where a level has no coverage are masked), and
slabs with no refined coverage skip the fine-level transport entirely via
lax.cond on a per-slab coverage bit.

Parity with the dense multilevel sweep is exact on covered cells: gathered
planes equal the dense planes wherever cover is set, and everything the
transport reads through uncovered positions is already mask-selected by
_slab_gauss_seidel (the same invariant the dense path relies on; absent
tiles gather the all-zero padding block, so no NaNs propagate).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import octants
from .amr_sparse import SparseMLState
from .sweep import _shift_j, _shift_k
from .sweep_amr import _prolong_plane, _segment_outputs
from .sweep_multilevel import (MLSweepPlan, MLZoneBatch,
                               _slab_gauss_seidel)


def _slab_slots(slot_rot, X, be: int, nb: int):
    """(slot plane (T,T), in-block x offset) for level slab X.

    slot_rot: (T,T,T) int32 rotated tile->slot; X traced int32 in
    [0, T*be).  Absent tiles route to the padding block (slot nb-1, all
    zeros)."""
    tx = X // be
    ox = X % be
    sp = jax.lax.dynamic_index_in_dim(slot_rot, tx, 0, keepdims=False)
    return jnp.where(sp < 0, nb - 1, sp), ox                # (T, T), scalar


def _gather_plane(blocks, sp, ox):
    """Dense level cross-section (..., n_l, n_l) from block storage.

    blocks: (..., nb, be, be, be); sp: (T, T) slot plane; ox: in-block x.
    Gathers whole (be, be) block sub-planes — T^2 rows instead of n_l^2
    element rows: gathers cost per row, so fat rows move the same bytes
    in far fewer rows."""
    be = blocks.shape[-1]
    T = sp.shape[0]
    g = blocks[..., sp, ox, :, :]           # (..., T, T, be, be)
    g = jnp.moveaxis(g, -2, -3)             # (..., T, be, T, be)
    return g.reshape(g.shape[:-4] + (T * be, T * be))


def _scatter_plane_add(blocks, sp, ox, plane):
    """Scatter-add a dense (..., n_l, n_l) plane into block storage (the
    inverse of _gather_plane; T^2 fat rows).  Duplicate slots only occur
    for absent tiles (all routed to the padding block) whose updates are
    zero (cover-masked), so the accumulation is exact."""
    be = blocks.shape[-1]
    T = sp.shape[0]
    p = plane.reshape(plane.shape[:-2] + (T, be, T, be))
    p = jnp.moveaxis(p, -3, -2)             # (..., T, T, be, be)
    return blocks.at[..., sp, ox, :, :].add(p)


def sweep_zone_sparse(k0_rot, refined0_rot, lv_rots, params, uvb, cell_size,
                      weight, n_coupling_iters: int = 4, window=None):
    """Sweep one zone over a block-sparse L-level grid.

    k0_rot: (n, 3, n, n) rotated base opacity; refined0_rot: (n, n, n);
    lv_rots[l-1] (levels 1..L-1): dict with
      kappa (3, nb, be, be, be), cover/refined (nb, be, be, be) — all
      block data rotated within-block (octants.rotate_blocks_to_sweep) —
      and slot (T, T, T) rotated tile map;
    params[l]: (D, n*2^l) template-chain arrays.
    window: None, or (W static int, (n, 2) int32 PER-SLAB base-cell
    starts, multiples of be) — run the coupled fine-level stack only on
    each slab's W x W refinement window
    (_sweep_zone_sparse_windowed; exact-parity clustered-refinement
    optimization, the deep sweep's dominant cost driver).
    Returns (j0_rot (n, 3, n, n), [(3, nb, be, be, be) J blocks per
    refined level], all in the rotated frame / rotated block layout).
    """
    if window is not None and len(lv_rots) > 0:
        return _sweep_zone_sparse_windowed(
            k0_rot, refined0_rot, lv_rots, params, uvb, cell_size, weight,
            n_coupling_iters, window)
    L = 1 + len(lv_rots)
    n = k0_rot.shape[0]
    ny = nz = n
    dtype = k0_rot.dtype
    D = params[0]["len_xy"].shape[0]
    uvb = jnp.asarray(uvb, dtype)

    def bcast(shape):
        return jnp.broadcast_to(uvb[None, :, None, None], shape).astype(dtype)

    uvb_cell = [bcast((D, 3, ny * 2 ** l, nz * 2 ** l)) for l in range(L)]
    uvb_j = [bcast((D, 3, 1, nz * 2 ** l)) for l in range(L)]
    uvb_k = [bcast((D, 3, ny * 2 ** l, 1)) for l in range(L)]

    nbs = [lv["cover"].shape[0] for lv in lv_rots]
    bes = [lv["cover"].shape[-1] for lv in lv_rots]

    # per-slab "needs fine transport" bit: a slab touches refined levels if
    # it has refined cells itself OR the previous slab does (its carry fine
    # tops feed this slab's level-0 xy inputs through refined-below)
    any_ref = jnp.any(refined0_rot, axis=(1, 2))            # (n,)
    cov_x = any_ref | jnp.concatenate([any_ref[:1] & False, any_ref[:-1]])

    xs = {"i": jnp.arange(n), "k0": k0_rot[:, None],
          "r0": refined0_rot[:, None], "has_fine": cov_x}
    for l in range(L):
        m = 2 ** l
        for key, v in params[l].items():
            xs[f"p{l}_{key}"] = jnp.asarray(v).reshape(D, n, m).swapaxes(0, 1)

    def gather_levels(i):
        """Materialize per-level plane stacks for base slab i (whole-tile
        fat-row gathers: T^2 rows per plane, not n_l^2)."""
        out = []
        for ell in range(1, L):
            m = 2 ** ell
            kap, cov, ref = [], [], []
            for s in range(m):
                sp, ox = _slab_slots(lv_rots[ell - 1]["slot"], i * m + s,
                                     bes[ell - 1], nbs[ell - 1])
                kap.append(_gather_plane(lv_rots[ell - 1]["kappa"], sp, ox))
                cov.append(_gather_plane(lv_rots[ell - 1]["cover"], sp, ox))
                ref.append(_gather_plane(lv_rots[ell - 1]["refined"], sp,
                                         ox))
            out.append({"kappa": jnp.stack(kap), "cover": jnp.stack(cov),
                        "refined": jnp.stack(ref)})
        return out

    def body(carry, x):
        planes_carry, j_flats = carry
        i = x["i"]

        def params_of(l):
            return {key[len(f"p{l}_"):]: x[key] for key in x
                    if key.startswith(f"p{l}_")}

        x0 = dict({"kappa": x["k0"],
                   "cover": jnp.ones((1, ny, nz), bool),
                   "refined": x["r0"]}, **params_of(0))

        def j_of(est_ls, cov_ls, ref_ls):
            leaf = cov_ls & ~ref_ls
            return weight * jnp.sum(
                jnp.where(leaf[None, None], est_ls["j_slab"], 0.0), axis=0)

        def full(_):
            fine = gather_levels(i)
            xl = [x0]
            for ell in range(1, L):
                entry = dict(fine[ell - 1])
                if ell == L - 1:
                    entry["refined"] = jnp.zeros_like(entry["cover"])
                entry.update(params_of(ell))
                xl.append(entry)

            est, cov, ref = _slab_gauss_seidel(
                planes_carry, xl, L, ny, nz, D, uvb_j, uvb_k, cell_size,
                n_coupling_iters, dtype)

            j0 = j_of(est[0][0], cov[0][0], ref[0][0])

            # refined-level J: scatter into the block accumulators
            # (whole-tile fat rows)
            new_flats = []
            for ell in range(1, L):
                m = 2 ** ell
                jf = j_flats[ell - 1]
                for s in range(m):
                    js = j_of(est[ell][s], cov[ell][s], ref[ell][s])
                    sp, ox = _slab_slots(lv_rots[ell - 1]["slot"],
                                         i * m + s, bes[ell - 1],
                                         nbs[ell - 1])
                    jf = _scatter_plane_add(jf, sp, ox, js)
                new_flats.append(jf)

            carry_next = []
            for l in range(L):
                last = 2 ** l - 1
                carry_next.append((est[l][last]["top"], cov[l][last],
                                   ref[l][last]))
            return tuple(carry_next), tuple(new_flats), j0

        def skip(_):
            # no refined coverage anywhere in this slab: level-0 transport
            # only (one pass — level 0 has no coupling partners).  The
            # fabricated fine carries are never selected downstream because
            # their cover-below planes are all False (the same mask the
            # dense path relies on); J accumulators pass through untouched.
            est, cov, ref = _slab_gauss_seidel(
                planes_carry[:1], [x0], 1, ny, nz, D, uvb_j[:1], uvb_k[:1],
                cell_size, 1, dtype)
            j0 = j_of(est[0][0], cov[0][0], ref[0][0])
            carry_next = [(est[0][0]["top"], cov[0][0], ref[0][0])]
            t = est[0][0]["top"]
            for l in range(1, L):
                t = _prolong_plane(t)
                nyl, nzl = ny * 2 ** l, nz * 2 ** l
                carry_next.append((t, jnp.zeros((nyl, nzl), bool),
                                   jnp.zeros((nyl, nzl), bool)))
            return tuple(carry_next), j_flats, j0

        if L == 1:
            carry_next, new_flats, j0 = skip(None)
        else:
            carry_next, new_flats, j0 = jax.lax.cond(
                x["has_fine"], full, skip, None)
        return (carry_next, new_flats), j0

    carry0_planes = tuple(
        (uvb_cell[l],
         jnp.ones((ny * 2 ** l, nz * 2 ** l), bool),
         jnp.zeros((ny * 2 ** l, nz * 2 ** l), bool))
        for l in range(L))
    j_flats0 = tuple(
        jnp.zeros((3, nbs[l], bes[l], bes[l], bes[l]), dtype)
        for l in range(L - 1))
    (_, j_flats), j0 = jax.lax.scan(body, (carry0_planes, j_flats0), xs)
    return j0, list(j_flats)


def _sweep_zone_sparse_windowed(k0_rot, refined0_rot, lv_rots, params, uvb,
                                cell_size, weight, n_coupling_iters,
                                window):
    """sweep_zone_sparse with the coupled fine-level stack confined to a
    static W x W cross-section window (base cells) containing all
    refinement — the clustered-refinement shape of real cosmological
    grids, where the full-plane Gauss-Seidel stack wastes most of its
    area on empty fine levels (the finest-level planes dominate the
    per-pass work).

    EXACT parity with the unwindowed sweep by construction:

    * P1 — a plain (uncoupled) level-0 full-plane pass.  Shifts are
      one-directional in the rotated frame, so P1 is exact upwind of the
      window; its chained intermediates provide the window's upwind-edge
      boundary pad lines (per segment, through _slab_gauss_seidel's
      tuple-pad form).
    * the windowed L-level Gauss-Seidel stack — identical math on
      cropped planes (window aligned to block granularity, so all
      parent/child factor-2 relations hold).
    * P2 — the plain level-0 full-plane pass re-evaluated with the
      window's coupled intermediates merged into its side inputs: cells
      downwind of the window see the fine-coupled radiation, the
      reference's coarse-reads-fine contract
      (transportRoutinesModule.f90:455-558).  Merged outputs keep
      windowed values inside, P2 values outside.

    window = (W static int, (n, 2) int32 PER-SLAB base-cell starts,
    multiples of the block edge, clamped to [0, n - W]).  Between slabs
    the window may move (disjoint clumps each pay only their own
    cross-section); the fine-level carry planes translate from the
    previous slab's window position into the current one through a
    zero-filled global frame — cells outside the previous window have
    cover-below False by the coverage invariant (window_i covers
    ref(slab i-1) too), so zero fill is exact.
    """
    W, w0 = window
    w0 = jnp.asarray(w0, jnp.int32)       # (n, 2) per-slab starts
    z0 = jnp.asarray(0, jnp.int32)        # dynamic_slice wants one dtype
    L = 1 + len(lv_rots)
    n = k0_rot.shape[0]
    ny = nz = n
    dtype = k0_rot.dtype
    D = params[0]["len_xy"].shape[0]
    uvb = jnp.asarray(uvb, dtype)

    def bcast(shape):
        return jnp.broadcast_to(uvb[None, :, None, None],
                                shape).astype(dtype)

    uvb_j_full = bcast((D, 3, 1, nz))
    uvb_k_full = bcast((D, 3, ny, 1))
    uvb_cell0 = bcast((D, 3, ny, nz))
    uvb_cell_w = [bcast((D, 3, W * 2 ** l, W * 2 ** l)) for l in range(L)]
    uvb_j_w = [bcast((D, 3, 1, W * 2 ** l)) for l in range(L)]
    uvb_k_w = [bcast((D, 3, W * 2 ** l, 1)) for l in range(L)]

    nbs = [lv["cover"].shape[0] for lv in lv_rots]
    bes = [lv["cover"].shape[-1] for lv in lv_rots]

    any_ref = jnp.any(refined0_rot, axis=(1, 2))
    cov_x = any_ref | jnp.concatenate([any_ref[:1] & False, any_ref[:-1]])

    xs = {"i": jnp.arange(n), "k0": k0_rot[:, None],
          "r0": refined0_rot[:, None], "has_fine": cov_x,
          "wy0": w0[:, 0], "wz0": w0[:, 1]}
    for l in range(L):
        m = 2 ** l
        for key, v in params[l].items():
            xs[f"p{l}_{key}"] = jnp.asarray(v).reshape(D, n, m).swapaxes(0,
                                                                         1)

    ds = jax.lax.dynamic_slice
    dus = jax.lax.dynamic_update_slice

    def translate_fine(planes_fine, prev, cur):
        """Move window-frame fine carries from the previous slab's
        window position to the current one (zero fill outside — exact by
        the coverage invariant, see docstring).  Identity when the
        window did not move."""
        out = []
        for off, (top, cb, rb) in enumerate(planes_fine):
            m = 2 ** (off + 1)
            nl = n * m
            py, pz = prev[0] * m, prev[1] * m
            cy, cz = cur[0] * m, cur[1] * m
            gt = dus(jnp.zeros((D, 3, nl, nl), top.dtype), top,
                     (z0, z0, py, pz))
            gc = dus(jnp.zeros((nl, nl), bool), cb, (py, pz))
            gr = dus(jnp.zeros((nl, nl), bool), rb, (py, pz))
            out.append((ds(gt, (z0, z0, cy, cz), (D, 3, W * m, W * m)),
                        ds(gc, (cy, cz), (W * m, W * m)),
                        ds(gr, (cy, cz), (W * m, W * m))))
        return tuple(out)

    def win_slots(ell, i, s, wy0, wz0):
        """Window tile slice of level-ell slab slots: WT^2 tiles instead
        of T^2 (window starts are block-edge multiples, so tile indices
        divide exactly)."""
        WT = W * 2 ** ell // bes[ell - 1]
        wty = wy0 * 2 ** ell // bes[ell - 1]
        wtz = wz0 * 2 ** ell // bes[ell - 1]
        sp, ox = _slab_slots(lv_rots[ell - 1]["slot"], i * 2 ** ell + s,
                             bes[ell - 1], nbs[ell - 1])
        return ds(sp, (wty, wtz), (WT, WT)), ox

    def gather_levels_win(i, wy0, wz0):
        out = []
        for ell in range(1, L):
            kap, cov, ref = [], [], []
            for s in range(2 ** ell):
                sp, ox = win_slots(ell, i, s, wy0, wz0)
                kap.append(_gather_plane(lv_rots[ell - 1]["kappa"], sp,
                                         ox))
                cov.append(_gather_plane(lv_rots[ell - 1]["cover"], sp,
                                         ox))
                ref.append(_gather_plane(lv_rots[ell - 1]["refined"], sp,
                                         ox))
            out.append({"kappa": jnp.stack(kap), "cover": jnp.stack(cov),
                        "refined": jnp.stack(ref)})
        return out

    def body(carry, x):
        planes_carry, j_flats, cstart = carry
        i = x["i"]
        wy0, wz0 = x["wy0"], x["wz0"]
        cur = jnp.stack([wy0, wz0])
        # re-register the fine carries onto this slab's window position
        planes_carry = (planes_carry[:1]
                        + translate_fine(planes_carry[1:], cstart, cur))

        def params_of(l):
            return {key[len(f"p{l}_"):]: x[key] for key in x
                    if key.startswith(f"p{l}_")}

        p0 = params_of(0)
        x0_full = dict({"kappa": x["k0"],
                        "cover": jnp.ones((1, ny, nz), bool),
                        "refined": x["r0"]}, **p0)

        def j_of(est_ls, cov_ls, ref_ls):
            leaf = cov_ls & ~ref_ls
            return weight * jnp.sum(
                jnp.where(leaf[None, None], est_ls["j_slab"], 0.0),
                axis=0)

        # P1 (see docstring): plain level-0 pass, intermediates kept
        est_p1, cov_p1, ref_p1 = _slab_gauss_seidel(
            planes_carry[:1], [x0_full], 1, ny, nz, D, [uvb_j_full],
            [uvb_k_full], cell_size, 1, dtype, level0_segs=True)

        def full(_):
            k0_w = ds(x["k0"], (z0, z0, wy0, wz0), (1, 3, W, W))
            r0_w = ds(x["r0"], (z0, wy0, wz0), (1, W, W))
            x0_w = dict({"kappa": k0_w,
                         "cover": jnp.ones((1, W, W), bool),
                         "refined": r0_w}, **p0)
            fine = gather_levels_win(i, wy0, wz0)
            xl = [x0_w]
            for ell in range(1, L):
                entry = dict(fine[ell - 1])
                if ell == L - 1:
                    entry["refined"] = jnp.zeros_like(entry["cover"])
                entry.update(params_of(ell))
                xl.append(entry)

            t0, cb0, rb0 = planes_carry[0]
            carry_w = ((ds(t0, (z0, z0, wy0, wz0), (D, 3, W, W)),
                        ds(cb0, (wy0, wz0), (W, W)),
                        ds(rb0, (wy0, wz0), (W, W))),) \
                + tuple(planes_carry[1:])

            def pad_j(segplane):
                cat = jnp.concatenate([uvb_j_full, segplane], axis=-2)
                return ds(cat, (z0, z0, wy0, wz0), (D, 3, 1, W))

            def pad_k(segplane):
                cat = jnp.concatenate([uvb_k_full, segplane], axis=-1)
                return ds(cat, (z0, z0, wy0, wz0), (D, 3, W, 1))

            s1, s2 = est_p1[0][0]["seg1"], est_p1[0][0]["seg2"]
            uvb_j_lvls = [(pad_j(s1), pad_j(s2))] + uvb_j_w[1:]
            uvb_k_lvls = [(pad_k(s1), pad_k(s2))] + uvb_k_w[1:]

            est, cov, ref = _slab_gauss_seidel(
                carry_w, xl, L, W, W, D, uvb_j_lvls, uvb_k_lvls,
                cell_size, n_coupling_iters, dtype, level0_segs=True)

            # P2 (see docstring): full-plane level-0 with window-merged
            # side inputs
            ws1, ws2 = est[0][0]["seg1"], est[0][0]["seg2"]

            def side_j2(xp, seg):
                xm = dus(xp, (ws1, ws2)[seg], (z0, z0, wy0, wz0))
                return _shift_j(xm, uvb_j_full)

            def side_k2(xp, seg):
                xm = dus(xp, (ws1, ws2)[seg], (z0, z0, wy0, wz0))
                return _shift_k(xm, uvb_k_full)

            sp0 = {}
            for key in ("len_xy", "len_xz", "len_yz", "x0", "y0",
                        "xz_x0", "xz_z0", "yz_y0", "yz_z0"):
                sp0[key] = x0_full[key][:, 0].astype(dtype)
            for key in ("chain2", "chain3", "n_active",
                        "top_xy", "top_xz", "top_yz"):
                sp0[key] = x0_full[key][:, 0]
            est_p2 = _segment_outputs(t0, x["k0"][0][None], sp0,
                                      cell_size, side_j2, side_k2)

            leaf0 = ~x["r0"][0]
            j0_full = weight * jnp.sum(
                jnp.where(leaf0[None, None], est_p2["j_slab"], 0.0),
                axis=0)
            j0_win = j_of(est[0][0], cov[0][0], ref[0][0])
            j0 = dus(j0_full, j0_win, (z0, wy0, wz0))
            top0 = dus(est_p2["top"], est[0][0]["top"], (z0, z0, wy0, wz0))

            new_flats = []
            for ell in range(1, L):
                jf = j_flats[ell - 1]
                for s in range(2 ** ell):
                    js = j_of(est[ell][s], cov[ell][s], ref[ell][s])
                    sp, ox = win_slots(ell, i, s, wy0, wz0)
                    jf = _scatter_plane_add(jf, sp, ox, js)
                new_flats.append(jf)

            carry_next = [(top0, jnp.ones((ny, nz), bool), x["r0"][0])]
            for l in range(1, L):
                last = 2 ** l - 1
                carry_next.append((est[l][last]["top"], cov[l][last],
                                   ref[l][last]))
            return tuple(carry_next), tuple(new_flats), j0

        def skip(_):
            j0 = j_of(est_p1[0][0], cov_p1[0][0], ref_p1[0][0])
            carry_next = [(est_p1[0][0]["top"], cov_p1[0][0],
                           ref_p1[0][0])]
            t = ds(est_p1[0][0]["top"], (z0, z0, wy0, wz0), (D, 3, W, W))
            for l in range(1, L):
                t = _prolong_plane(t)
                Wl = W * 2 ** l
                carry_next.append((t, jnp.zeros((Wl, Wl), bool),
                                   jnp.zeros((Wl, Wl), bool)))
            return tuple(carry_next), j_flats, j0

        carry_next, new_flats, j0 = jax.lax.cond(x["has_fine"], full,
                                                 skip, None)
        return (carry_next, new_flats, cur), j0

    carry0 = ((uvb_cell0, jnp.ones((ny, nz), bool),
               jnp.zeros((ny, nz), bool)),) + tuple(
        (uvb_cell_w[l], jnp.ones((W * 2 ** l,) * 2, bool),
         jnp.zeros((W * 2 ** l,) * 2, bool))
        for l in range(1, L))
    j_flats0 = tuple(
        jnp.zeros((3, nbs[l], bes[l], bes[l], bes[l]), dtype)
        for l in range(L - 1))
    (_, j_flats, _), j0 = jax.lax.scan(body, (carry0, j_flats0, w0[0]),
                                       xs)
    return j0, list(j_flats)


def diffuse_sweep_sparse(k0, lv_kappas, state: SparseMLState,
                         plan: MLSweepPlan, uvb, cell_size,
                         n_coupling_iters: int = 4,
                         max_dirs_per_launch: int = 4,
                         eager_zones: bool = False,
                         window="auto"):
    """Full block-sparse L-level sweep.

    k0: (3, n, n, n) base opacity; lv_kappas[l-1]: (3, nb, be, be, be)
    block opacity for level l.  Returns (J0 (3, n, n, n),
    [J blocks (3, nb, be, be, be) per refined level]) — leaf cells only;
    propagate with amr_sparse.sync_restriction_sparse.

    Zone batching mirrors the dense path: equal-direction-count zones run
    through one lax.scan whose body rotates via lax.switch over the 24
    octant transforms (slot volumes with rotate_to_sweep, block data with
    rotate_blocks_to_sweep).

    eager_zones: dispatch one jitted call per direction chunk instead of
    one scan over all chunks, waiting for each before the next, so one
    compiled chunk body serves the whole sweep and each dispatch stays
    bounded (SparseMLModel.make_step's split_compile turns this on
    together with per-piece compiles).

    window: "auto" computes the static refinement window for the
    clustered-refinement fast path (compute_window; falls back to the
    full-plane stack when refinement spans the grid); None disables it;
    or pass a precomputed (W, {izone: starts}).
    """
    L = state.n_levels
    k0_l = jnp.moveaxis(k0, 0, -1)                          # (n,n,n,3)

    j0_acc = jnp.zeros_like(k0_l)
    jb_acc = [jnp.zeros_like(k) for k in lv_kappas]

    if isinstance(window, str) and window == "auto":
        # trace-time fallback: the window is a host-side static — callers
        # jitting this pass a precomputed window (SparseMLModel resolves
        # it from the concrete state before tracing)
        window = (None if isinstance(state.refined0, jax.core.Tracer)
                  else compute_window(state))
    win_w = window[0] if window is not None else None

    groups = build_chunks(plan, max_dirs_per_launch)
    body = functools.partial(_chunk_body, L=L, weight=plan.weight,
                             n_coupling_iters=n_coupling_iters,
                             window_w=win_w)
    ctx = build_ctx(k0, lv_kappas, state)

    def starts_of(z):
        if window is None:
            return jnp.zeros(2, jnp.int32)
        return jnp.asarray(window[1][z.izone], jnp.int32)

    if eager_zones:
        one = _get_eager_runner(L, plan.weight, n_coupling_iters, win_w)
        for zones in groups.values():
            for z in zones:
                j0_acc, jb_acc = one(
                    (j0_acc, tuple(jb_acc)),
                    (jnp.asarray(z.izone - 1, jnp.int32),
                     tuple({key: jnp.asarray(v)
                            for key, v in z.params[l].items()}
                           for l in range(L)),
                     starts_of(z)),
                    ctx, uvb, cell_size)
                jb_acc = list(jb_acc)
                # one dispatch in flight at a time
                jax.block_until_ready(j0_acc)
    else:
        for zones in groups.values():
            izones = jnp.asarray([z.izone - 1 for z in zones], jnp.int32)
            stacked = tuple(
                {key: jnp.asarray(np.stack([z.params[l][key]
                                            for z in zones]))
                 for key in zones[0].params[l]}
                for l in range(L))
            starts = jnp.stack([starts_of(z) for z in zones])
            (j0_acc, jb_acc), _ = jax.lax.scan(
                lambda carry, x: (body(carry, x, ctx, uvb, cell_size),
                                  None),
                (j0_acc, tuple(jb_acc)), (izones, stacked, starts))
            jb_acc = list(jb_acc)

    return jnp.moveaxis(j0_acc, -1, 0), list(jb_acc)


def compute_window(state: SparseMLState, margin: int = 2):
    """Static refinement window for the windowed sparse sweep, PER SLAB:
    for every octant rotation and every rotated slab, the smallest
    be-aligned W x W cross-section containing the refinement of that slab
    AND its upwind neighbor (the carry feeds forward, so window_i must
    cover ref(slab i-1) too), or None when refinement spans most of the
    grid (the unwindowed path is then cheaper).

    Per-slab starts let spatially separated clumps each pay only their
    OWN cross-section: W is the largest single-slab box, not the global
    bounding box of all clumps (disjoint-in-x clumps make the per-slab
    area several times smaller — the production geometry).

    Returns (W, {izone: (n, 2) int32 starts}) — W static; starts
    tile-aligned so block tiles divide exactly, with >= `margin`
    uncovered base cells around the coverage, forward/backward-filled
    through refinement-free slabs (their value is irrelevant — the skip
    branch runs — but a stable value minimizes carry translation)."""
    r0 = np.asarray(jax.device_get(state.refined0)).astype(bool)
    if not r0.any() or state.n_levels < 2:
        return None
    be = state.be
    half = be // 2
    n = state.n
    from ..geometry.octants import rotate_to_sweep

    def slab_boxes(rot):
        """Per-slab tile-aligned (lo_y, hi_y, lo_z, hi_z) of
        rot[i] | rot[i-1]; empty slabs -> (0, 0, 0, 0)."""
        u = rot.copy()
        u[1:] |= rot[:-1]
        out = []
        for axis in (1, 2):
            anyx = u.any(axis=2 if axis == 1 else 1)        # (n, n)
            has = anyx.any(axis=1)
            lo = np.where(has, anyx.argmax(axis=1), 0)
            hi = np.where(has, n - anyx[:, ::-1].argmax(axis=1), 0)
            lo = lo // half * half
            hi = -(-hi // half) * half
            out += [lo, hi]
        return out[0], out[1], out[2], out[3], u.any(axis=(1, 2))

    zone_rots = {iz: rotate_to_sweep(r0, iz) for iz in range(1, 25)}
    ext = 0
    for rot in zone_rots.values():
        lo_y, hi_y, lo_z, hi_z, has = slab_boxes(rot)
        if has.any():
            ext = max(ext, int((hi_y - lo_y)[has].max()),
                      int((hi_z - lo_z)[has].max()))
    W = ext + 2 * margin + be
    W = min(n, -(-W // be) * be)
    if W >= n:
        return None

    starts = {}
    for iz, rot in zone_rots.items():
        lo_y, hi_y, lo_z, hi_z, has = slab_boxes(rot)
        st = np.zeros((n, 2), np.int32)
        for col, (lo, hi) in enumerate(((lo_y, hi_y), (lo_z, hi_z))):
            s = (lo - margin) // be * be
            s = np.clip(s, 0, n - W)
            assert bool(np.all((s[has] <= lo[has])
                               & (s[has] + W >= hi[has])))
            # forward/backward fill through refinement-free slabs
            idxs = np.where(has, np.arange(n), -1)
            idxs = np.maximum.accumulate(idxs)
            first = int(np.argmax(has))
            idxs = np.where(idxs < 0, first, idxs)
            st[:, col] = s[idxs]
        starts[iz] = st
    return W, starts


def build_chunks(plan: MLSweepPlan, max_dirs_per_launch: int
                 ) -> dict[int, list]:
    """Chunk each zone's direction batch to bound the Gauss-Seidel
    estimate planes' footprint (4 keys x sum(2^l) sub-slabs x D x 3 bands
    at the finest cross-section — the deep-grid memory driver); chunks of
    the same size (the dict key) share one compiled scan body."""
    groups: dict[int, list] = {}
    for zone in plan.zones:
        for s0 in range(0, zone.ndir, max_dirs_per_launch):
            s1 = min(s0 + max_dirs_per_launch, zone.ndir)
            chunk = MLZoneBatch(
                izone=zone.izone, ndir=s1 - s0,
                params=tuple({k: v[s0:s1] for k, v in p.items()}
                             for p in zone.params))
            groups.setdefault(chunk.ndir, []).append(chunk)
    return groups


def build_ctx(k0, lv_kappas, state: SparseMLState):
    """The replicated sweep context (_chunk_body/_chunk_contrib's `ctx`):
    (base opacity (n,n,n,3), refined0, per-level
    (kappa, cover, refined, slot) block arrays)."""
    L = state.n_levels
    lv_arrays = []
    for ell in range(1, L):
        lv = state.levels[ell - 1]
        lv_arrays.append((
            lv_kappas[ell - 1], lv.cover,
            (lv.refined if ell < L - 1 else jnp.zeros_like(lv.cover)),
            lv.slot))
    return (jnp.moveaxis(k0, 0, -1), jnp.asarray(state.refined0, bool),
            tuple(lv_arrays))


def _chunk_body(carry, x, ctx, uvb, cell_size, *, L, weight,
                n_coupling_iters, window_w=None):
    """One direction chunk: rotate in, sweep, rotate out, accumulate."""
    j0u, jbu = _chunk_contrib(x, ctx, uvb, cell_size, L=L, weight=weight,
                              n_coupling_iters=n_coupling_iters,
                              window_w=window_w)
    j0_a, jb_a = carry
    return j0_a + j0u, tuple(a + b for a, b in zip(jb_a, jbu))


def _chunk_contrib(x, ctx, uvb, cell_size, *, L, weight,
                   n_coupling_iters, window_w=None):
    """One direction chunk's Jmean contribution: rotate in (lax.switch
    over the 24 octant transforms), sweep, rotate out.  Returns
    (j0 (n,n,n,3), tuple of per-level (3, nb, be, be, be) J blocks) —
    the additive unit both the sequential scan (_chunk_body) and the
    zone-parallel distributed schedule (parallel.sweep_dist) accumulate."""
    k0_l, refined0, lv_arrays = ctx
    lv_data = [{"kappa": a, "cover": c, "refined": r, "slot": s}
               for (a, c, r, s) in lv_arrays]

    def rot_in(iz):
        def f(_):
            k0r = jnp.moveaxis(octants.rotate_to_sweep(k0_l, iz), -1, 1)
            r0r = octants.rotate_to_sweep(refined0, iz)
            lvr = tuple(
                {"kappa": octants.rotate_blocks_to_sweep(d["kappa"], iz),
                 "cover": octants.rotate_blocks_to_sweep(d["cover"], iz),
                 "refined": octants.rotate_blocks_to_sweep(d["refined"],
                                                           iz),
                 "slot": octants.rotate_to_sweep(d["slot"], iz)}
                for d in lv_data)
            return k0r, r0r, lvr
        return f

    def rot_out(iz):
        def f(js):
            j0, jbs = js
            j0u = octants.rotate_from_sweep(jnp.moveaxis(j0, 1, -1), iz)
            jbu = tuple(octants.rotate_blocks_from_sweep(j, iz)
                        for j in jbs)
            return j0u, jbu
        return f

    if window_w is not None:
        iz, pars, w0 = x
        window = (window_w, w0)
    else:
        iz, pars = x[0], x[1]
        window = None
    k0r, r0r, lvr = jax.lax.switch(iz, [rot_in(z) for z in range(1, 25)],
                                   None)
    j0r, jfl = sweep_zone_sparse(k0r, r0r, list(lvr), pars, uvb, cell_size,
                                 weight, n_coupling_iters, window=window)
    jbs = tuple(jf.reshape((3,) + lv_data[e]["cover"].shape)
                for e, jf in enumerate(jfl))
    return jax.lax.switch(iz, [rot_out(z) for z in range(1, 25)],
                          (j0r, jbs))


_EAGER_RUNNER_CACHE: dict = {}


def _get_eager_runner(L: int, weight: float, n_coupling_iters: int,
                      window_w=None):
    """Persistent jitted per-chunk runner (cached so production loops
    reuse the compiled executable across iterations; jit itself caches
    per array-shape signature)."""
    key = (L, float(weight), n_coupling_iters, window_w)
    fn = _EAGER_RUNNER_CACHE.get(key)
    if fn is None:
        fn = jax.jit(functools.partial(_chunk_body, L=L, weight=weight,
                                       n_coupling_iters=n_coupling_iters,
                                       window_w=window_w))
        _EAGER_RUNNER_CACHE[key] = fn
    return fn
