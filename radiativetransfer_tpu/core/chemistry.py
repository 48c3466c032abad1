"""H/He ionization-equilibrium chemistry and the thermal balance diagnostic.

Vectorized re-design of the reference's per-cell solvers:

* solve_rate_equations — port of solveRateEquations
  (/root/reference/equiSources.f90:3459-3677).  The reference bisects on the
  electron density cell-by-cell with a data-dependent stopping rule; here the
  bisection runs fully vectorized over the grid with a fixed iteration count
  (the interval [1e-30, nh+2nhe] halves each step, so ~110 iterations reach
  float64 machine precision and ~40 suffice for float32).

* initial_ionization_equilibrium — the tighter-tolerance variant used during
  setup (equiSources.f90:3679-3868).

* thermal_equilibrium — the cooling-function evaluation producing the
  hydroHeating diagnostic (equiSources.f90:3870-4042).  Temperature is NOT
  evolved, exactly as in the reference.

All functions are elementwise over the grid; XLA fuses the table gathers and
the bisection loop into a single kernel.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    DLOGTEM,
    FOUR_PI,
    LOGTEM0,
    LOGTEM9,
    MH,
    MHE,
    PSI,
    SIGMA24_AT_NU1,
    SIGMA25_AT_NU3,
    SIGMA26_AT_NU2,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RateTablesDevice:
    """Device-resident temperature tables used by the solvers."""
    k16: jax.Array        # (nratec, 6): k1..k6
    cool: jax.Array       # (nratec, 13): ceHI ceHeI ceHeII ciHI ciHeI ciHeIS
    #                        ciHeII reHII reHeII1 reHeII2 reHeIII brem lineHI

    @classmethod
    def from_tables(cls, tables, dtype=jnp.float64) -> "RateTablesDevice":
        cool = np.stack([
            tables.ceHI, tables.ceHeI, tables.ceHeII, tables.ciHI,
            tables.ciHeI, tables.ciHeIS, tables.ciHeII, tables.reHII,
            tables.reHeII1, tables.reHeII2, tables.reHeIII, tables.brem,
            tables.lineHI], axis=-1)
        return cls(k16=jnp.asarray(tables.k16(), dtype),
                   cool=jnp.asarray(cool, dtype))


def _lookup(table_2d, logtem):
    """Linear log-T interpolation of all columns of a (nratec, m) table.

    Mirrors equiSources.f90:3568-3586.
    """
    logtem = jnp.clip(logtem, LOGTEM0, LOGTEM9)
    pos = (logtem - LOGTEM0) / DLOGTEM
    idx = jnp.clip(pos.astype(jnp.int32), 0, table_2d.shape[0] - 2)
    frac = (pos - idx)[..., None]
    lo = table_2d[idx]
    hi = table_2d[idx + 1]
    return lo + frac * (hi - lo)


def clamp_species(nh, nhe, HI, HeI, HeII):
    """Conservation clamps (equiSources.f90:3499-3514)."""
    HI = jnp.minimum(HI, nh)
    HeIII = nhe - HeI - HeII
    # HeIII < 0: absorb into HeII; if still negative, all neutral
    HeII = jnp.where(HeIII < 0.0, nhe - HeI, HeII)
    HeII = jnp.maximum(HeII, 0.0)
    HeI = jnp.minimum(HeI, nhe)
    return HI, HeI, HeII


def _equilibrium_species(de, nh, nhe, k, g24, g25, g26):
    """Closed-form species given electron density de.

    The HeII-balance residual drives the bisection
    (equiSources.f90:3592-3602).  Divisions are guarded against float32
    underflow of k*de products (the reference runs in float64 where the
    1e-30 lower bracket stays representable).
    """
    k1, k2, k3, k4, k5, k6 = k
    tiny = 1e-300 if de.dtype == jnp.float64 else 1e-37
    HII = nh / (1.0 + k2 * de / jnp.maximum(k1 * de + g24, tiny))
    R = (k3 * de + g26) / jnp.maximum(k4 * de, tiny)
    HeI = (de - HII - 2.0 * nhe) / (R - 2.0 - 2.0 * R)
    res = (k3 * HeI * de + k6 * (nhe - HeI - HeI * R) * de + g26 * HeI
           - HeI * R * (k4 * de + k5 * de + g25))
    return HII, R, HeI, res


def photo_rates_from_sources(krate_density, absorber_density):
    """Convert volumetric photoionization rates [1/s/cm^3] to per-particle
    rates [1/s] (equiSources.f90:3519-3543).

    The reference divides per-cell counts by cell_volume * n_absorber; the
    cell volume in CGS (~1e71 cm^3 at 100 kpc cells) overflows float32, so
    the volume division is folded into the source tables at build time
    (StellarContext.build) and only the absorber-density division remains on
    device.
    """
    rate = jnp.where(absorber_density > 0.0,
                     krate_density / jnp.where(absorber_density > 0.0,
                                               absorber_density, 1.0),
                     0.0)
    return jnp.maximum(rate, 0.0)


def diffuse_photo_rates(Jmean, ksi_matrix):
    """Photoionization rates from the three-band mean intensity
    (equiSources.f90:3546-3553).

    ksi_matrix: (3 bands, 3 species) of group ksi coefficients:
      [:,0] -> HI (ksi24), [:,1] -> HeII (ksi25), [:,2] -> HeI (ksi26).
    Returns (g24, g25, g26) arrays.
    """
    j = FOUR_PI * Jmean  # (3, ...)
    g24 = j[0] * ksi_matrix[0, 0] + j[1] * ksi_matrix[1, 0] + j[2] * ksi_matrix[2, 0]
    g25 = j[2] * ksi_matrix[2, 1]
    g26 = j[1] * ksi_matrix[1, 2] + j[2] * ksi_matrix[2, 2]
    return g24, g25, g26


def uniform_photo_rates(HI, HeI, HeII, self_shielding_threshold,
                        gamma_thin: tuple[float, float, float]):
    """Optically-thin uniform UVB with the mean-free-path self-shielding
    switch (equiSources.f90:3556-3561)."""
    mfp = 1.0 / (HI * SIGMA24_AT_NU1 + HeI * SIGMA26_AT_NU2 + HeII * SIGMA25_AT_NU3)
    thin = mfp >= self_shielding_threshold
    g24 = jnp.where(thin, gamma_thin[0], 0.0)
    g25 = jnp.where(thin, gamma_thin[1], 0.0)
    g26 = jnp.where(thin, gamma_thin[2], 0.0)
    return g24, g25, g26


def solve_equilibrium(nh, nhe, tgas, g24, g25, g26, tables: RateTablesDevice,
                      n_iter: int = 110):
    """Vectorized ionization-equilibrium solve.

    Bisection on the electron density over [1e-30, nh + 2 nhe] with the
    HeII-balance residual (equiSources.f90:3590-3633), fixed n_iter steps.

    Returns (HI, HeI, HeII, de).
    """
    logtem = jnp.log(tgas)
    kk = _lookup(tables.k16, logtem)
    k = tuple(kk[..., i] for i in range(6))

    # lower bracket: 1e-30 in float64 (equiSources.f90:3590); scaled up for
    # float32 so k*de products stay in range (the physical root is always
    # above ~1e-12 of the total charge budget)
    de_hi = nh + 2.0 * nhe
    if nh.dtype == jnp.float64:
        de_lo = jnp.full_like(nh, 1.0e-30)
    else:
        de_lo = 1.0e-12 * de_hi
    _, _, _, res_lo = _equilibrium_species(de_lo, nh, nhe, k, g24, g25, g26)

    def body(_, carry):
        de_lo, de_hi, res_lo = carry
        de = 0.5 * (de_lo + de_hi)
        _, _, _, res = _equilibrium_species(de, nh, nhe, k, g24, g25, g26)
        opposite = ((res > 0.0) & (res_lo < 0.0)) | ((res < 0.0) & (res_lo > 0.0))
        de_hi = jnp.where(opposite, de, de_hi)
        de_lo = jnp.where(opposite, de_lo, de)
        res_lo = jnp.where(opposite, res_lo, res)
        return de_lo, de_hi, res_lo

    de_lo, de_hi, _ = jax.lax.fori_loop(0, n_iter, body, (de_lo, de_hi, res_lo))
    de = 0.5 * (de_lo + de_hi)

    # back-substitution (equiSources.f90:3629-3632), clamped to conservation
    # (the reference asserts 0 <= x <= 1 and aborts; low-precision noise is
    # clamped instead)
    tiny = 1e-300 if nh.dtype == jnp.float64 else 1e-37
    HII, R, HeI, _ = _equilibrium_species(de, nh, nhe, k, g24, g25, g26)
    HeI = jnp.clip(HeI, 0.0, nhe)
    HeII = jnp.clip(HeI * R, 0.0, nhe - HeI)
    HI = jnp.clip(k[1] * HII * de / jnp.maximum(k[0] * de + g24, tiny), 0.0, nh)
    return HI, HeI, HeII, de


def solve_rate_equations(state, geom, tables: RateTablesDevice, ksi_matrix=None,
                         gamma_thin=None, self_shielding_threshold=None,
                         run_uvb_transfer: bool = False, n_iter: int = 110):
    """Full chemistry update on a FieldState; returns the new state.

    Combines the rate assembly (point-source counts -> per-particle rates;
    diffuse or uniform UVB) with the equilibrium solve, then writes back the
    clamped species (solveRateEquations, equiSources.f90:3459-3677).
    """
    import dataclasses as dc

    nh, nhe = state.nh, state.nhe
    HI, HeI, HeII = clamp_species(nh, nhe, state.HI, state.HeI, state.HeII)
    HII = nh - HI

    g24 = photo_rates_from_sources(state.krate24, HI)
    g25 = photo_rates_from_sources(state.krate25, HeII)
    g26 = photo_rates_from_sources(state.krate26, HeI)

    if run_uvb_transfer:
        d24, d25, d26 = diffuse_photo_rates(state.Jmean, ksi_matrix)
        g24, g25, g26 = g24 + d24, g25 + d25, g26 + d26
    elif gamma_thin is not None:
        u24, u25, u26 = uniform_photo_rates(HI, HeI, HeII,
                                            self_shielding_threshold, gamma_thin)
        g24, g25, g26 = g24 + u24, g25 + u25, g26 + u26

    HI, HeI, HeII, _ = solve_equilibrium(nh, nhe, state.tgas, g24, g25, g26,
                                         tables, n_iter)
    return dc.replace(state, HI=HI, HeI=HeI, HeII=HeII)


def solve_h_only_equilibrium(nh, tgas, g24, tables: RateTablesDevice):
    """Closed-form pure-hydrogen photoionization equilibrium.

    For H-only configs: balance
      HI*(k1*de + g24) = k2*HII*de  with de = HII
    expands to the quadratic
      (k1 + k2)*HII^2 + (g24 - nh*k1)*HII - nh*g24 = 0,
    solved with the numerically-stable root formula.
    """
    logtem = jnp.log(tgas)
    kk = _lookup(tables.k16, logtem)
    k1, k2 = kk[..., 0], kk[..., 1]
    # quadratic a*HII^2 + b*HII + c = 0
    a = k1 + k2
    b = g24 - nh * k1
    c = -g24 * nh
    disc = jnp.sqrt(jnp.maximum(b * b - 4.0 * a * c, 0.0))
    # numerically-stable root selection
    q = -0.5 * (b + jnp.sign(b) * disc)
    r1 = q / jnp.where(a != 0.0, a, 1.0)
    r2 = c / jnp.where(q != 0.0, q, 1.0)
    HII = jnp.where(a != 0.0,
                    jnp.where((r1 >= 0.0) & (r1 <= nh), r1, r2),
                    -c / b)
    HII = jnp.clip(HII, 0.0, nh)
    return nh - HII, HII


def thermal_equilibrium(state, heat_thin: tuple[float, float, float],
                        self_shielding_threshold: float, current_redshift: float,
                        tables: RateTablesDevice, compa: float):
    """Cooling-vs-heating balance diagnostic (thermalEquilibrium,
    equiSources.f90:3870-4042).

    heat_thin = 4*pi*(uniformQuasar*gammaX_q + uniformStellar*gammaX_s) for
    X in (HI, HeII, HeI): the optically-thin photo-heating coefficients
    [erg cm^2/s] per absorber (:3931-3933).

    Returns the new state with hydroHeating = max(0, -edot).
    """
    import dataclasses as dc

    nh, nhe = state.nh, state.nhe
    HI, HeI, HeII = clamp_species(nh, nhe, state.HI, state.HeI, state.HeII)
    HII = nh - HI
    HeIII = nhe - HeI - HeII
    de = HII + HeII + 2.0 * HeIII
    tgas = state.tgas

    mfp = 1.0 / (HI * SIGMA24_AT_NU1 + HeI * SIGMA26_AT_NU2 + HeII * SIGMA25_AT_NU3)
    thin = mfp >= self_shielding_threshold
    crate = jnp.where(thin,
                      heat_thin[0] * HI + heat_thin[1] * HeII + heat_thin[2] * HeI,
                      0.0)

    c = _lookup(tables.cool, jnp.log(tgas))
    (ceHI, ceHeI, ceHeII, ciHI, ciHeI, ciHeIS, ciHeII, reHII, reHeII1,
     reHeII2, reHeIII, brem, lineHI) = (c[..., i] for i in range(13))

    comp1 = compa * (1.0 + current_redshift) ** 4
    comp2 = 2.73 * (1.0 + current_redshift)

    edot = -(
        ceHI * HI * de
        + ceHeI * HeI * de ** 2
        + ceHeII * HeII * de
        + ciHI * HI * de
        + ciHeI * HeI * de
        + ciHeII * HeII * de
        + ciHeIS * HeII * de ** 2
        + reHII * HII * de
        + reHeII1 * HeII * de
        + reHeII2 * HeII * de
        + reHeIII * HeIII * de
        + comp1 * (tgas - comp2) * de
        + brem * (HII + HeII + 4.0 * HeIII) * de
    )
    edot = edot + crate
    return dc.replace(state, hydroHeating=jnp.maximum(-edot, 0.0))
