"""Slow, direct NumPy ports of the reference algorithms, used as test oracles.

These deliberately follow the Fortran control flow cell-by-cell (including
the xyTop/xzTop/yzTop tag dispatch) rather than the vectorized chain
formulation of the production sweep, so agreement between the two validates
the chain reasoning, not just the arithmetic.
"""

from __future__ import annotations

import numpy as np

from radiativetransfer_tpu.geometry import healpix, octants, patterns
from radiativetransfer_tpu.geometry.patterns import TAG_XY, TAG_XZ, TAG_YZ

_TAU_EPS = 1.0e-10


def _segment(i_in, kappa, length, cell_size):
    """Attenuation + log-mean for one segment, one cell, 3 bands.

    Mirrors the inline code at equiSources.f90:1611-1643.
    """
    dpath = cell_size * length
    tau = kappa * dpath
    a = np.exp(-tau)
    i_out = i_in * a
    # computeCellIntensity: (Iin-Iout)/log(Iin/Iout) if Iout<Iin else mean
    lm = np.where(i_out < i_in,
                  (i_in - i_out) / np.log(np.where(i_out < i_in, i_in / i_out, 2.0)),
                  0.5 * (i_in + i_out))
    return i_out, lm


def serial_sweep(kappa: np.ndarray, n_angular_level: int, uvb: np.ndarray,
                 cell_size: float, directions: list[int] | None = None) -> np.ndarray:
    """Serial port of the base-grid diffuse sweep (equiSources.f90:1372-1808).

    Args:
      kappa: (3, nx, ny, nz) band opacities [1/cm].
      uvb: (3,) boundary intensities.
      directions: optional subset of direction indices (default: all).
    Returns:
      (3, nx, ny, nz) accumulated Jmean.
    """
    nb, nx, ny, nz = kappa.shape
    ndir = 12 * 4 ** (n_angular_level - 1)
    weight = 1.0 / ndir
    phi_all, theta_all = healpix.sweep_directions(n_angular_level)
    if directions is None:
        directions = range(ndir)

    jmean = np.zeros_like(kappa)

    for iray in directions:
        d = octants.fold_direction(phi_all[iray], theta_all[iray])
        shape = octants.transfer_shape(nx, ny, nz, d.izone)
        nxt, nyt, nzt = shape

        # per-slab templates
        tmpl = []
        x0, y0 = 0.5, 0.5
        for _ in range(nxt):
            t = patterns.set_pattern(x0, y0, d.phi, d.theta)
            tmpl.append(t)
            x0, y0 = t.next_x0, t.next_y0

        # per-cell per-segment outputs in sweep coordinates
        i_xy = np.zeros((nxt, nyt, nzt, nb))
        i_xz = np.zeros((nxt, nyt, nzt, nb))
        i_yz = np.zeros((nxt, nyt, nzt, nb))

        def seg_out(tag, i, j, k):
            if tag == TAG_XY:
                return i_xy[i, j, k]
            if tag == TAG_XZ:
                return i_xz[i, j, k]
            if tag == TAG_YZ:
                return i_yz[i, j, k]
            raise AssertionError("inactive tag dereferenced")

        j_rot = np.zeros((nxt, nyt, nzt, nb))

        for i in range(nxt):
            t = tmpl[i]
            for j in range(nyt):
                for k in range(nzt):
                    ic, jc, kc = octants.rotate_indices(i + 1, j + 1, k + 1,
                                                        nx, ny, nz, d.izone)
                    kap = kappa[:, ic - 1, jc - 1, kc - 1]
                    jacc = np.zeros(nb)
                    imean = 0

                    # xy ray: upwind (i-1, j, k), select by its xyTop tag
                    if i == 0:
                        i_in = uvb.copy()
                    else:
                        i_in = seg_out(tmpl[i - 1].top_xy, i - 1, j, k)
                    i_out, lm = _segment(i_in, kap, t.len_xy, cell_size)
                    i_xy[i, j, k] = i_out
                    jacc += lm
                    imean += 1

                    # xz ray: upwind (i, j-1, k), select by xzTop
                    if t.len_xz > 0.0:
                        if j == 0:
                            i_in = uvb.copy()
                        else:
                            i_in = seg_out(t.top_xz, i, j - 1, k)
                        i_out, lm = _segment(i_in, kap, t.len_xz, cell_size)
                        i_xz[i, j, k] = i_out
                        jacc += lm
                        imean += 1

                    # yz ray: upwind (i, j, k-1), select by yzTop
                    if t.len_yz > 0.0:
                        if k == 0:
                            i_in = uvb.copy()
                        else:
                            i_in = seg_out(t.top_yz, i, j, k - 1)
                        i_out, lm = _segment(i_in, kap, t.len_yz, cell_size)
                        i_yz[i, j, k] = i_out
                        jacc += lm
                        imean += 1

                    j_rot[i, j, k] += jacc / imean * weight

        jmean += np.moveaxis(octants.rotate_from_sweep(j_rot, d.izone), -1, 0)

    return jmean


def solve_rate_equations_serial(nh, nhe, tgas, krate24, krate25, krate26,
                                k_tables, tol=1e-10, max_iter=200):
    """Scalar port of the ionization-equilibrium bisection
    (solveRateEquations, equiSources.f90:3590-3633).

    All inputs scalars; k_tables is a callable T -> (k1..k6).
    Returns (HI, HeI, HeII, de).
    """
    k1, k2, k3, k4, k5, k6 = k_tables(tgas)

    def species(de):
        HII = nh / (1.0 + k2 * de / (k1 * de + krate24))
        R = (k3 * de + krate26) / (k4 * de)
        HeI = (de - HII - 2.0 * nhe) / (R - 2.0 - 2.0 * R)
        res = (k3 * HeI * de + k6 * (nhe - HeI - HeI * R) * de + krate26 * HeI
               - HeI * R * (k4 * de + k5 * de + krate25))
        return HII, R, HeI, res

    de1, de2 = 1.0e-30, nh + 2.0 * nhe
    _, _, _, res1 = species(de1)
    _, _, _, res2 = species(de2)
    # bisect to machine precision (the reference's initial-equilibrium variant
    # iterates to the exact HeI fixpoint, equiSources.f90:3791)
    for _ in range(200):
        de = 0.5 * (de1 + de2)
        if de == de1 or de == de2:
            break
        _, _, hei, res = species(de)
        if (res > 0 and res1 < 0) or (res < 0 and res1 > 0):
            de2, res2 = de, res
        else:
            de1, res1 = de, res

    HII, R, HeI, _ = species(de)
    HeII = HeI * R
    HeIII = nhe - HeI - HeII
    HII = nh / (1.0 + k2 * de / (k1 * de + krate24))
    HI = k2 * HII * de / (k1 * de + krate24)
    return HI, HeI, HeII, de


def serial_sweep_two_level(kappa_c: np.ndarray, kappa_f: np.ndarray,
                           refined: np.ndarray, n_angular_level: int,
                           uvb: np.ndarray, cell_size: float,
                           directions=None):
    """Serial two-level sweep oracle.

    Direct port of the reference's recursive refined transport order
    (equiSources.f90:1572-1796 + transportRoutinesModule.f90:560-963):
    coarse cells in rotated (i,j,k) order; refined cells recurse into their
    2x2x2 children in rotated sub-order; cross-level reads follow the
    getXY/XZ/YZNeighbour footpoint descent and the xyTop/xzTop/yzTop tag
    dispatch, with the case(0) averaging fallback.

    Returns (Jmean_base, Jmean_fine) like diffuse_sweep_amr.
    """
    from radiativetransfer_tpu.core.sweep_amr import _build_chain, _child_start
    from radiativetransfer_tpu.geometry.patterns import (TAG_NONE, TAG_XY,
                                                         TAG_XZ, TAG_YZ)

    nb, n, ny, nz = kappa_c.shape
    ndir = 12 * 4 ** (n_angular_level - 1)
    weight = 1.0 / ndir
    phi_all, theta_all = healpix.sweep_directions(n_angular_level)
    if directions is None:
        directions = range(ndir)

    jc = np.zeros_like(kappa_c)
    jf = np.zeros_like(kappa_f)

    for iray in directions:
        d = octants.fold_direction(phi_all[iray], theta_all[iray])
        tc = _build_chain(d.phi, d.theta, n)
        tf = _build_chain(d.phi, d.theta, 2 * n, *_child_start(0.5, 0.5))
        kc_rot = np.moveaxis(octants.rotate_to_sweep(
            np.moveaxis(kappa_c, 0, -1), d.izone), -1, 0)
        kf_rot = np.moveaxis(octants.rotate_to_sweep(
            np.moveaxis(kappa_f, 0, -1), d.izone), -1, 0)
        r_rot = octants.rotate_to_sweep(refined, d.izone)

        # per-cell per-segment outputs: [level][seg][cell] -> (3,)
        out_c = {s: np.zeros((n, n, n, nb)) for s in ("xy", "xz", "yz")}
        out_f = {s: np.zeros((2 * n, 2 * n, 2 * n, nb)) for s in ("xy", "xz", "yz")}
        jrot_c = np.zeros((n, n, n, nb))
        jrot_f = np.zeros((2 * n, 2 * n, 2 * n, nb))

        def tag_out(level, tmpl, idx):
            """Face-exit value by tag with the case(0) averaging fallback."""
            out = out_c if level == 0 else out_f

            def sel(tag):
                if tag == TAG_XY:
                    return out["xy"][idx]
                if tag == TAG_XZ:
                    return out["xz"][idx]
                if tag == TAG_YZ:
                    return out["yz"][idx]
                side = out["xz"][idx] if tmpl.len_xz > 0 else (
                    out["yz"][idx] if tmpl.len_yz > 0 else out["xy"][idx])
                return 0.5 * (out["xy"][idx] + side)
            return sel

        def transport_cell(level, idx, tmpl, kap, csize):
            i, j, k = idx
            nmax = n if level == 0 else 2 * n
            jacc = np.zeros(nb)
            nact = 0

            def upwind(axis, face_footpoints):
                """Face-input for the segment entering through `axis`
                (0: bottom/xy, 1: j-/xz, 2: k-/yz)."""
                up = [i, j, k]
                up[axis] -= 1
                if up[axis] < 0:
                    return uvb.copy()
                if level == 0:
                    up_refined = r_rot[up[0], up[1], up[2]]
                    if not up_refined:
                        t_up = tc[up[0]]
                        tag = (t_up.top_xy, t_up.top_xz, t_up.top_yz)[axis]
                        return tag_out(0, t_up, tuple(up))(tag)
                    # descend into the fine children by MY footpoint
                    fx, fy = face_footpoints
                    if axis == 0:      # xy: (x0,y0); top sub-slab, children
                        fi = 2 * up[0] + 1
                        fj = 2 * up[1] + (1 if fy >= 0.5 else 0)
                        fk = 2 * up[2] + (1 if fx >= 0.5 else 0)
                    elif axis == 1:    # xz: (x0,z0); face-adjacent j child
                        x0, z0 = face_footpoints
                        fi = 2 * up[0] + (1 if z0 >= 0.5 else 0)
                        fj = 2 * up[1] + 1
                        fk = 2 * up[2] + (1 if x0 >= 0.5 else 0)
                    else:              # yz: (y0,z0)
                        y0, z0 = face_footpoints
                        fi = 2 * up[0] + (1 if z0 >= 0.5 else 0)
                        fj = 2 * up[1] + (1 if y0 >= 0.5 else 0)
                        fk = 2 * up[2] + 1
                    t_up = tf[fi]
                    tag = (t_up.top_xy, t_up.top_xz, t_up.top_yz)[axis]
                    return tag_out(1, t_up, (fi, fj, fk))(tag)
                # fine level: the upwind neighbor is fine iff its parent is
                # refined; otherwise copy the coarse neighbor's exit
                pu = [u // 2 for u in up]
                if r_rot[pu[0], pu[1], pu[2]]:
                    t_up = tf[up[0]]
                    tag = (t_up.top_xy, t_up.top_xz, t_up.top_yz)[axis]
                    return tag_out(1, t_up, tuple(up))(tag)
                t_up = tc[pu[0]]
                tag = (t_up.top_xy, t_up.top_xz, t_up.top_yz)[axis]
                return tag_out(0, t_up, tuple(pu))(tag)

            out = out_c if level == 0 else out_f
            # xy segment
            i_in = upwind(0, (tmpl.x0, tmpl.y0))
            i_outv, lm = _segment(i_in, kap, tmpl.len_xy, csize)
            out["xy"][i, j, k] = i_outv
            jacc += lm
            nact += 1
            if tmpl.len_xz > 0:
                i_in = upwind(1, (tmpl.xz_x0, tmpl.xz_z0))
                i_outv, lm = _segment(i_in, kap, tmpl.len_xz, csize)
                out["xz"][i, j, k] = i_outv
                jacc += lm
                nact += 1
            if tmpl.len_yz > 0:
                i_in = upwind(2, (tmpl.yz_y0, tmpl.yz_z0))
                i_outv, lm = _segment(i_in, kap, tmpl.len_yz, csize)
                out["yz"][i, j, k] = i_outv
                jacc += lm
                nact += 1
            (jrot_c if level == 0 else jrot_f)[i, j, k] += jacc / nact * weight

        for i in range(n):
            for j in range(n):
                for k in range(n):
                    if r_rot[i, j, k]:
                        for di in range(2):
                            for dj in range(2):
                                for dk in range(2):
                                    fi, fj, fk = 2 * i + di, 2 * j + dj, 2 * k + dk
                                    transport_cell(
                                        1, (fi, fj, fk), tf[fi],
                                        kf_rot[:, fi, fj, fk], cell_size / 2)
                    else:
                        transport_cell(0, (i, j, k), tc[i],
                                       kc_rot[:, i, j, k], cell_size)

        jc += np.moveaxis(octants.rotate_from_sweep(jrot_c, d.izone), -1, 0)
        jf += np.moveaxis(octants.rotate_from_sweep(jrot_f, d.izone), -1, 0)

    return jc, jf


def serial_sweep_multilevel(kappas: list, refined: list,
                            n_angular_level: int, uvb: np.ndarray,
                            cell_size: float, directions=None):
    """Serial L-level sweep oracle.

    Generalizes serial_sweep_two_level to arbitrary nesting depth: the
    reference's recursive transport (transportRoutinesModule.f90:560-963)
    visits cells depth-first in rotated order; upwind reads ascend to the
    leaf containing the neighbor (findNeighbours walk) or descend into its
    children by the consuming ray's face footpoint (getXY/XZ/YZNeighbour
    descent, :455-558), to ANY depth.

    kappas: list of (3, n*2^l, ...) per level; refined: list of L-1 bool
    volumes.  Returns a list of per-level Jmean arrays (zero on non-leaves).
    """
    from radiativetransfer_tpu.core.sweep_amr import _build_chain, _child_start
    from radiativetransfer_tpu.geometry.patterns import TAG_XY, TAG_XZ, TAG_YZ

    L = len(kappas)
    nb, n = kappas[0].shape[0], kappas[0].shape[1]
    ndir = 12 * 4 ** (n_angular_level - 1)
    weight = 1.0 / ndir
    phi_all, theta_all = healpix.sweep_directions(n_angular_level)
    if directions is None:
        directions = range(ndir)

    jms = [np.zeros_like(k) for k in kappas]

    for iray in directions:
        d = octants.fold_direction(phi_all[iray], theta_all[iray])
        # per-level template chains: the same ray family sampled at each
        # resolution (setRaysRefined child transform applied per level)
        tms, start = [], (0.5, 0.5)
        for ell in range(L):
            tms.append(_build_chain(d.phi, d.theta, n * 2 ** ell, *start))
            start = _child_start(*start)
        k_rots = [np.moveaxis(octants.rotate_to_sweep(
            np.moveaxis(k, 0, -1), d.izone), -1, 0) for k in kappas]
        r_rots = [octants.rotate_to_sweep(np.asarray(r, bool), d.izone)
                  for r in refined]
        cover = [np.ones((n, n, n), bool)]
        for r in r_rots:
            cover.append(np.repeat(np.repeat(np.repeat(
                r & cover[-1], 2, 0), 2, 1), 2, 2))

        outs = [{s: np.zeros(k.shape[1:] + (nb,), k.dtype)
                 for s in ("xy", "xz", "yz")} for k in k_rots]
        jrots = [np.zeros(k.shape[1:] + (nb,), k.dtype) for k in k_rots]

        def tag_sel(level, tmpl, idx, tag):
            out = outs[level]
            if tag == TAG_XY:
                return out["xy"][idx]
            if tag == TAG_XZ:
                return out["xz"][idx]
            if tag == TAG_YZ:
                return out["yz"][idx]
            side = out["xz"][idx] if tmpl.len_xz > 0 else (
                out["yz"][idx] if tmpl.len_yz > 0 else out["xy"][idx])
            return 0.5 * (out["xy"][idx] + side)

        def upwind(level, idx, axis, fps):
            """Face input for the segment of cell `idx` (level `level`)
            entering through `axis` with face footpoint fractions `fps`
            ((slab?,j?,k?) fractions as in the two-level oracle)."""
            up = list(idx)
            up[axis] -= 1
            if up[axis] < 0:
                return uvb.copy()
            lvl, a = level, up
            # ascend to the covering ancestor (findNeighbours walk up)
            while not cover[lvl][tuple(a)]:
                a = [u // 2 for u in a]
                lvl -= 1
            # descend into refined neighbors by the face footpoint (zoom*)
            fa, fb = fps
            while lvl < L - 1 and cover[lvl][tuple(a)] \
                    and r_rots[lvl][tuple(a)]:
                if lvl < level:
                    # still above my level: the child containing MY
                    # neighbor cell, by its binary address
                    sh = level - lvl - 1
                    bits = [(u >> sh) & 1 for u in up]
                else:
                    if axis == 0:      # xy face: (x0 -> k, y0 -> j), i = 1
                        bits = [1, 1 if fb >= 0.5 else 0,
                                1 if fa >= 0.5 else 0]
                    elif axis == 1:    # xz face: (x0 -> k, z0 -> i), j = 1
                        bits = [1 if fb >= 0.5 else 0, 1,
                                1 if fa >= 0.5 else 0]
                    else:              # yz face: (y0 -> j, z0 -> i), k = 1
                        bits = [1 if fb >= 0.5 else 0,
                                1 if fa >= 0.5 else 0, 1]
                    fa = 2 * fa - (1.0 if fa >= 0.5 else 0.0)
                    fb = 2 * fb - (1.0 if fb >= 0.5 else 0.0)
                a = [2 * u + b for u, b in zip(a, bits)]
                lvl += 1
            t_up = tms[lvl][a[0]]
            tag = (t_up.top_xy, t_up.top_xz, t_up.top_yz)[axis]
            return tag_sel(lvl, t_up, tuple(a), tag)

        def transport_cell(level, idx):
            i = idx[0]
            tmpl = tms[level][i]
            kap = k_rots[level][(slice(None),) + idx]
            csize = cell_size / 2 ** level
            jacc = np.zeros(nb)
            nact = 0
            i_in = upwind(level, idx, 0, (tmpl.x0, tmpl.y0))
            i_outv, lm = _segment(i_in, kap, tmpl.len_xy, csize)
            outs[level]["xy"][idx] = i_outv
            jacc += lm
            nact += 1
            if tmpl.len_xz > 0:
                i_in = upwind(level, idx, 1, (tmpl.xz_x0, tmpl.xz_z0))
                i_outv, lm = _segment(i_in, kap, tmpl.len_xz, csize)
                outs[level]["xz"][idx] = i_outv
                jacc += lm
                nact += 1
            if tmpl.len_yz > 0:
                i_in = upwind(level, idx, 2, (tmpl.yz_y0, tmpl.yz_z0))
                i_outv, lm = _segment(i_in, kap, tmpl.len_yz, csize)
                outs[level]["yz"][idx] = i_outv
                jacc += lm
                nact += 1
            jrots[level][idx] += jacc / nact * weight

        def visit(level, idx):
            if level < L - 1 and r_rots[level][idx]:
                for di in range(2):
                    for dj in range(2):
                        for dk in range(2):
                            visit(level + 1, (2 * idx[0] + di,
                                              2 * idx[1] + dj,
                                              2 * idx[2] + dk))
            else:
                transport_cell(level, idx)

        for i in range(n):
            for j in range(n):
                for k in range(n):
                    visit(0, (i, j, k))

        for ell in range(L):
            jms[ell] += np.moveaxis(
                octants.rotate_from_sweep(jrots[ell], d.izone), -1, 0)

    return jms


# ---------------------------------------------------------------------------
# Point-source tracer oracle (startNewLongRay, equiSources.f90:3120-3385)
# ---------------------------------------------------------------------------


def quadrature_deposit_serial(depth, tau, quad_A, quad_W_b):
    """One segment's six rate deposits per unit ndot, float64: the
    spectral sum W e0_f (1 - exp(-tau_j A[j, f])) with e0 = exp(-depth . A)
    (stellarBetaTable.f90:217-285).  depth (4,), tau (3,), quad_A (4, F),
    quad_W_b (F, 6) of the ray's SED bucket.  Returns {RateFields name:
    value}; band j = 0, 1, 2 is HI, HeI, HeII."""
    e0 = np.exp(-(depth @ quad_A))                     # (F,)
    out = {}
    for j, (kname, cname) in enumerate(
            (("krate24", "crate24"), ("krate26", "crate26"),
             ("krate25", "crate25"))):
        g = e0 * -np.expm1(-tau[j] * quad_A[j])
        out[kname] = g @ quad_W_b[:, j]
        out[cname] = g @ quad_W_b[:, j + 3]
    return out


def serial_trace(fields, n, cell_size, sources_pos, sources_ndot,
                 quad_A, quad_W, sig_ratio, out_radii_cm,
                 max_pixel_level, table_idx=None):
    """Per-ray depth-first port of the reference's point-source solve on a
    uniform grid, with direct spectral-quadrature deposits.

    Follows startNewLongRay / drawSegment (equiSources.f90:2412-2595,
    3120-3385) ray by ray: march cell faces, cut at the split radii
    rmax(level) (:304-309), split 1->4 NESTED children with the lateral
    reposition (:3325-3332), accumulate escape fractions at the output
    radii and the emergent spectrum at the outermost one (:3198-3226), and
    boundary losses (:3228-3233, :3336-3344).

    Two documented deviations from the Fortran, matching the production
    tracer: (a) the tau kill uses min over the THREE ionization depths —
    the reference includes the dust depth in the min (:3241), which with
    dust off is identically zero so its kill never fires; (b) an
    out-of-box split child does not abort its remaining siblings — the
    reference's `strategy = boundary` inside the child loop (:3338-3344)
    silently drops the siblings, a photon-losing bug.

    fields: dict HI/HeI/HeII dense (n,n,n) [cm^-3].  cell_size [cm].
    sources_pos (S,3) box units; sources_ndot (S,); quad_A (4,F);
    quad_W (B,F,6) volumetric weights; sig_ratio (4, nenergy);
    out_radii_cm (nr,).  Returns (rates dict in RateFields order,
    ndot_remaining (S,nr), ndot_boundary (S,nr), ndot_spectrum (S,ne)).
    """
    from radiativetransfer_tpu.constants import (SIGMA24_AT_NU1,
                                                 SIGMA25_AT_NU3,
                                                 SIGMA26_AT_NU2, rmax_table)

    HI, HeI, HeII = fields["HI"], fields["HeI"], fields["HeII"]
    rmax = rmax_table()
    S = len(sources_ndot)
    nr = len(out_radii_cm)
    ne = sig_ratio.shape[1]
    if table_idx is None:
        table_idx = np.zeros(S, np.int64)
    rates = {k: np.zeros((n, n, n))
             for k in ("krate24", "krate25", "krate26",
                       "crate24", "crate25", "crate26")}
    ndot_remaining = np.zeros((S, nr))
    ndot_boundary = np.zeros((S, nr))
    ndot_spectrum = np.zeros((S, ne))

    def deposit(cell, depth, tau, ndot, b):
        for name, v in quadrature_deposit_serial(depth, tau, quad_A,
                                                 quad_W[b]).items():
            rates[name][cell] += ndot * v

    def march(src, pos, direction, level, radius, ndot, depth, ipix):
        """One ray from its spawn to death or split; returns children."""
        b = table_idx[src]
        pos = pos.copy()
        depth = depth.copy()
        cell = np.clip((pos * n).astype(np.int64), 0, n - 1)
        last = level == max_pixel_level
        r_stop = rmax[level - 1]
        while True:
            d_safe = np.where(np.abs(direction) < 1e-12,
                              np.where(direction < 0, -1e-12, 1e-12),
                              direction)
            bound = (cell + (d_safe > 0.0)) / n
            t_ax = (bound - pos) / d_safe
            ax = int(np.argmin(t_ax))
            t_min = t_ax[ax]
            seg_cells = t_min * n
            radius_new = radius + seg_cells
            cut = (not last) and radius_new >= r_stop
            if cut:
                seg_cells = max(r_stop - radius, 0.0)
                radius_new = radius + seg_cells
                t_min = seg_cells / n
            plen = seg_cells * cell_size
            c = tuple(cell)
            tau = np.array([plen * HI[c] * SIGMA24_AT_NU1,
                            plen * HeI[c] * SIGMA26_AT_NU2,
                            plen * HeII[c] * SIGMA25_AT_NU3,
                            0.0])
            # escape radii (equiSources.f90:3198-3226)
            r1, r2 = radius * cell_size, radius_new * cell_size
            for ir, orad in enumerate(out_radii_cm):
                if r1 <= orad <= r2:
                    ratio = (orad - r1) / max(r2 - r1, 1e-30)
                    ndot_remaining[src, ir] += ndot * np.exp(
                        -(ratio * (tau[0] + tau[3]) + depth[0] + depth[3]))
                    if ir == nr - 1:
                        spec_tau = (depth + ratio * tau) @ sig_ratio
                        ndot_spectrum[src] += ndot * np.exp(-spec_tau)
            deposit(c, depth, tau, ndot, b)
            depth = depth + tau
            pos = pos + t_min * direction
            if cut:
                radius = radius_new
                # a kill on the cut segment overrides the split (the
                # reference reassigns strategy=boundary at :3241 after
                # drawSegment set split)
                if np.min(depth[:3]) > 100.0:
                    return []
                # split: 4 NESTED children (equiSources.f90:3303-3332)
                children = []
                nside = 2 ** level
                for i4 in range(4):
                    cp = 4 * ipix + i4
                    phi, theta = healpix.pix2ang_nest(nside, np.array([cp]))
                    cdir = healpix.direction_vectors(phi, theta)[0]
                    cpos = pos + (radius / n) * (cdir - direction)
                    if np.any(cpos < 0.0) or np.any(cpos > 1.0):
                        beyond = out_radii_cm > radius * cell_size
                        ndot_boundary[src, beyond] += ndot / 4.0
                    else:
                        children.append((src, cpos, cdir, level + 1, radius,
                                         ndot / 4.0, depth, cp))
                return children
            pos[ax] = bound[ax]   # snap onto the crossed face
            cell = cell.copy()
            cell[ax] += 1 if d_safe[ax] > 0 else -1
            radius = radius_new
            # boundary is accounted even if the ray also tau-kills on this
            # step (the reference's boundary block precedes its kill, :3228)
            if np.any(cell < 0) or np.any(cell >= n):
                beyond = out_radii_cm > r2
                ndot_boundary[src, beyond] += ndot
                return []
            if np.min(depth[:3]) > 100.0:     # tau kill (:3241)
                return []

    stack = []
    base_dirs = healpix.direction_vectors(
        *healpix.pix2ang_nest(1, np.arange(12)))
    for s in range(S):
        for p in range(12):
            stack.append((s, sources_pos[s].copy(), base_dirs[p], 1, 0.0,
                          sources_ndot[s] / 12.0, np.zeros(4), p))
    while stack:
        stack.extend(march(*stack.pop()))
    return rates, ndot_remaining, ndot_boundary, ndot_spectrum
