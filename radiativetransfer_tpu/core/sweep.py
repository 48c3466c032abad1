"""The diffuse upwind sweep.

Replaces the reference's serial 192-direction cell-by-cell sweep
(/root/reference/equiSources.f90:1372-1808, transportRoutinesModule.f90:560-963)
with a vectorized slab pipeline:

* Directions are folded into 24 octant-orientation zones; per zone the
  field tensors are viewed through one transpose/flip (geometry.octants), so
  the kernel always sweeps along array axis 0.
* Within a slab every cell shares the same <=3-segment ray template
  (geometry.patterns) and the in-slab dependency chain has depth <= 2:
  the xy segment depends only on the previous slab, the second chain segment
  on an in-slab neighbor's xy output, the third on the second.  Each slab is
  therefore 3 shifted multiply-accumulate passes over the (ny, nz) plane,
  batched over all directions of the zone and the 3 frequency bands.
* A `lax.scan` walks the slabs; the carry is the top-exit intensity plane.

The mean intensity uses the reference's log-mean accumulation
  J += (Iin - Iout)/ln(Iin/Iout)
in the numerically-safe equivalent form Iin*(1-e^-tau)/tau
(computeCellIntensity, transportRoutinesModule.f90:1036-1054).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import healpix, octants, patterns
from ..geometry.patterns import SEG_NONE, SEG_XZ, SEG_YZ

# small-tau switch for the (1-e^-tau)/tau form: 1e-10 in float64 matches the
# reference branch (equiSources.f90:1618); float32 needs a much larger
# threshold because 1-exp(-tau) cancels to zero below tau ~ 1e-7 (the linear
# limit 1 - tau/2 is accurate to ~tau^2/6 < 2e-9 at the switch)
_TAU_EPS_F64 = 1.0e-10
_TAU_EPS_F32 = 1.0e-4


def _tau_eps(dtype):
    import jax.numpy as _jnp
    return _TAU_EPS_F64 if dtype == _jnp.float64 else _TAU_EPS_F32


@dataclasses.dataclass(frozen=True)
class ZoneBatch:
    """All sweep directions sharing one octant orientation."""
    izone: int
    ndir: int
    # (ndir, nslab) float arrays / int8 arrays
    len_xy: np.ndarray
    len_xz: np.ndarray
    len_yz: np.ndarray
    chain2: np.ndarray
    chain3: np.ndarray
    n_active: np.ndarray


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Precomputed geometry for a full multi-direction sweep."""
    zones: tuple[ZoneBatch, ...]
    n_directions: int
    nslab: int

    @property
    def weight(self) -> float:
        """Angular quadrature weight 1/N (equiSources.f90:1386)."""
        return 1.0 / self.n_directions


def validate_zone_tables(zone: ZoneBatch) -> None:
    """Check a zone's chain tables before they reach the sweep.

    slab_step selects shifts and lengths with jnp.where on the chain codes,
    so a malformed code or an n_active that disagrees with the chain would
    silently give wrong intensities (SURVEY.md 5.2).  Raises ValueError
    naming the first offending (direction, slab) entry."""
    c2 = np.asarray(zone.chain2)
    c3 = np.asarray(zone.chain3)
    na = np.asarray(zone.n_active)
    lens = np.stack([np.asarray(zone.len_xy), np.asarray(zone.len_xz),
                     np.asarray(zone.len_yz)])
    ok_codes = np.isin(c2, (SEG_NONE, SEG_XZ, SEG_YZ)) \
        & np.isin(c3, (SEG_NONE, SEG_XZ, SEG_YZ))
    chain_consistent = (1 + (c2 != SEG_NONE) + (c3 != SEG_NONE)) == na
    dangling = (c3 != SEG_NONE) & (c2 == SEG_NONE)
    finite = np.isfinite(lens).all(axis=0) & (lens >= 0.0).all(axis=0)
    bad = ~(ok_codes & chain_consistent & ~dangling & finite)
    if bad.any():
        i = tuple(np.argwhere(bad)[0])
        raise ValueError(
            f"zone {zone.izone}: malformed chain table at (dir, slab)={i}: "
            f"chain2={c2[i]} chain3={c3[i]} n_active={na[i]} "
            f"lens={[float(l[i]) for l in lens]}")


def build_sweep_plan(n_angular_level: int, nx: int) -> SweepPlan:
    """Fold all HEALPix directions, group by zone, build and check the slab
    templates."""
    phi, theta = healpix.sweep_directions(n_angular_level)
    folded = octants.fold_all(phi, theta)
    groups = octants.group_by_zone(folded)
    zones = []
    for izone in sorted(groups):
        ds = groups[izone]
        p = patterns.stack_patterns(
            [patterns.build_slab_patterns(d.phi, d.theta, nx) for d in ds])
        zone = ZoneBatch(
            izone=izone, ndir=len(ds),
            len_xy=p.len_xy, len_xz=p.len_xz, len_yz=p.len_yz,
            chain2=p.chain2, chain3=p.chain3, n_active=p.n_active)
        validate_zone_tables(zone)
        zones.append(zone)
    return SweepPlan(zones=tuple(zones), n_directions=len(folded), nslab=nx)


def _attenuate(i_in, tau):
    """One segment: returns (i_out, logmean_contribution).

    logmean = (Iin - Iout)/ln(Iin/Iout) = Iin*(1-e^-tau)/tau, with the
    small-tau limit Iin*(1 - tau/2) (branch at equiSources.f90:1618-1632 and
    computeCellIntensity).  1 - e^-tau comes from expm1: formed as 1 - a
    it cancels to ~6e-4 relative error in f32 just above the switch, while
    a itself stays exp(-tau), accurate where it is tiny.
    """
    a = jnp.exp(-tau)
    eps = _tau_eps(tau.dtype)
    emi = jnp.where(tau > eps,
                    -jnp.expm1(-tau) / jnp.where(tau > eps, tau, 1.0),
                    1.0 - 0.5 * tau)
    return i_in * a, i_in * emi


def _shift_j(x, boundary):
    """Upwind shift along axis -2 (the xz-segment neighbor j-1)."""
    return jnp.concatenate([boundary, x[..., :-1, :]], axis=-2)


def _shift_k(x, boundary):
    """Upwind shift along axis -1 (the yz-segment neighbor k-1)."""
    return jnp.concatenate([boundary, x[..., :, :-1]], axis=-1)


def sweep_zone(kappa_rot, zone_params, uvb, cell_size, weight, dtype=None):
    """Sweep all directions of one zone over a rotated opacity field.

    Args:
      kappa_rot: (nslab, 3, ny, nz) opacity in sweep orientation [1/cm].
      zone_params: dict of per-slab arrays, each (ndir, nslab):
        len_xy/len_xz/len_yz float, chain2/chain3/n_active int.
      uvb: (3,) boundary intensities of the three bands.
      cell_size: base-cell physical size [cm].
      weight: per-direction angular weight.
    Returns:
      j_rot: (nslab, 3, ny, nz) accumulated weighted mean intensity.
    """
    nslab, nb, ny, nz = kappa_rot.shape
    ndir = zone_params["len_xy"].shape[0]
    dtype = dtype or kappa_rot.dtype
    uvb = uvb.astype(dtype)

    uvb_cell = uvb[None, :, None, None]                       # (1,3,1,1)
    i_top0 = jnp.broadcast_to(uvb_cell, (ndir, nb, ny, nz)).astype(dtype)
    uvb_j = jnp.broadcast_to(uvb[None, :, None, None], (ndir, nb, 1, nz))
    uvb_k = jnp.broadcast_to(uvb[None, :, None, None], (ndir, nb, ny, 1))

    xs = {
        "kappa": kappa_rot,                                   # (nslab,3,ny,nz)
        "len_xy": zone_params["len_xy"].T.astype(dtype),      # (nslab,ndir)
        "len_xz": zone_params["len_xz"].T.astype(dtype),
        "len_yz": zone_params["len_yz"].T.astype(dtype),
        "chain2": zone_params["chain2"].T,
        "chain3": zone_params["chain3"].T,
        "n_active": zone_params["n_active"].T.astype(dtype),
    }

    def slab_step(i_top, x):
        kappa = x["kappa"][None]                              # (1,3,ny,nz)

        def seg_tau(length):
            # (ndir,) lengths -> (ndir,3,ny,nz) optical depth
            return kappa * (length * cell_size)[:, None, None, None]

        # --- segment 1: xy (enters the bottom face) ---
        i_in1 = i_top
        i_out1, lm1 = _attenuate(i_in1, seg_tau(x["len_xy"]))

        # --- segment 2: second chain segment (xz -> shift j, yz -> shift k) ---
        is2_xz = (x["chain2"] == SEG_XZ)[:, None, None, None]
        act2 = (x["chain2"] != 0)[:, None, None, None]
        i_in2 = jnp.where(is2_xz, _shift_j(i_out1, uvb_j), _shift_k(i_out1, uvb_k))
        len2 = jnp.where(x["chain2"] == SEG_XZ, x["len_xz"], x["len_yz"])
        i_out2, lm2 = _attenuate(i_in2, seg_tau(len2))

        # --- segment 3 ---
        is3_xz = (x["chain3"] == SEG_XZ)[:, None, None, None]
        act3 = (x["chain3"] != 0)[:, None, None, None]
        i_in3 = jnp.where(is3_xz, _shift_j(i_out2, uvb_j), _shift_k(i_out2, uvb_k))
        len3 = jnp.where(x["chain3"] == SEG_XZ, x["len_xz"], x["len_yz"])
        i_out3, lm3 = _attenuate(i_in3, seg_tau(len3))

        n_act = x["n_active"][:, None, None, None]
        j_slab = (lm1 + jnp.where(act2, lm2, 0.0) + jnp.where(act3, lm3, 0.0)) / n_act
        j_contrib = weight * jnp.sum(j_slab, axis=0)          # (3,ny,nz)

        i_top_next = jnp.where(n_act == 3, i_out3,
                               jnp.where(n_act == 2, i_out2, i_out1))
        return i_top_next, j_contrib

    _, j_rot = jax.lax.scan(slab_step, i_top0, xs)
    return j_rot


def diffuse_sweep(kappa, plan: SweepPlan, uvb, cell_size) -> jax.Array:
    """Full multi-direction sweep.

    Args:
      kappa: (3, nx, ny, nz) band opacities [1/cm].
      plan: SweepPlan from build_sweep_plan.
      uvb: (3,) boundary band intensities.
      cell_size: base-cell size [cm].
    Returns:
      Jmean: (3, nx, ny, nz) angle-averaged mean intensity per band.
    """
    uvb = jnp.asarray(uvb, kappa.dtype)
    kappa_l = jnp.moveaxis(kappa, 0, -1)  # (nx,ny,nz,3) for axis transforms
    jmean = jnp.zeros_like(kappa_l)
    for zone in plan.zones:
        krot = octants.rotate_to_sweep(kappa_l, zone.izone)   # (nxt,nyt,nzt,3)
        krot = jnp.moveaxis(krot, -1, 1)                      # (nxt,3,nyt,nzt)
        params = {
            "len_xy": jnp.asarray(zone.len_xy),
            "len_xz": jnp.asarray(zone.len_xz),
            "len_yz": jnp.asarray(zone.len_yz),
            "chain2": jnp.asarray(zone.chain2),
            "chain3": jnp.asarray(zone.chain3),
            "n_active": jnp.asarray(zone.n_active),
        }
        j_rot = sweep_zone(krot, params, uvb, cell_size, plan.weight)
        j_rot = jnp.moveaxis(j_rot, 1, -1)                    # (nxt,nyt,nzt,3)
        jmean = jmean + octants.rotate_from_sweep(j_rot, zone.izone)
    return jnp.moveaxis(jmean, -1, 0)


def make_jitted_sweep(plan: SweepPlan):
    """jit-compiled sweep closed over a fixed plan (geometry is static)."""
    return jax.jit(lambda kappa, uvb, cell_size: diffuse_sweep(kappa, plan, uvb, cell_size))
