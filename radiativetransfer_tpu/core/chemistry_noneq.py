"""Non-equilibrium 9-species H/He/H2 chemistry with optional energy evolution.

The reference tabulates the full Enzo-lineage 9-species reaction network —
k1..k19 collisional rates, the k22 three-body H2 channel and the
density-dependent H2 collisional dissociation k13dd
(/root/reference/coll_rates.f:3-234, /root/reference/colh2diss.f:3-120,
/root/reference/calc_rates.f:3-759) — but its production path only ever
solves the H/He photoionization *equilibrium* (solveRateEquations,
/root/reference/equiSources.f90:3459-3677).  This module supplies the
non-equilibrium update the tables were built for (the north-star capability:
"non-equilibrium H/He/H2 photoionization-chemistry update"), designed
for vectorized accelerators:

* the integrator is the positivity-preserving sequential BDF1 scheme of
  Anninos et al. (1997, NewA 2, 209): each species is updated as
  ``x <- (x + dt*C) / (1 + dt*D/x)`` with creation C and destruction D
  evaluated Gauss-Seidel style, the fast species H- and H2+ held in
  algebraic equilibrium;
* sub-cycling is fully vectorized: every cell carries its own remaining
  time and per-cell timestep (10% electron-density / 10% energy change),
  advanced by a fixed-trip-count `lax.scan` — no data-dependent Python
  control flow, so the whole update jits to one fused elementwise XLA
  kernel over the grid;
* all rate coefficients come from the same 5000-bin log-T tables as the
  equilibrium path (tables/chemistry_rates.py), gathered once per substep.

Photoionization/photodissociation channels k24..k31 follow the reference's
numbering (sigma24..sigma31, /root/reference/uniformTable.f90:28-103):
24 HI, 25 HeII, 26 HeI, 27 H- photodetachment, 28 H2+ -> HI+HII,
29 H2 -> H2+ + e, 30 H2+ -> 2HII + e, 31 H2 Lyman-Werner dissociation.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import (
    DLOGTEM,
    GAMMA_ADIABATIC,
    KB,
    LOGTEM0,
    LOGTEM9,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class NoneqTablesDevice:
    """Device-resident rate/cooling tables for the 9-species network.

    kcol: (nratec, 20) collisional rates k1..k19, k22.
    k13dd: (nratec, 7) density-dependent H2 CID fit functions.
    cool: (nratec, 13) atomic cooling (same layout as
        chemistry.RateTablesDevice.cool).
    h2cool: (nratec, 2) Galli & Palla (1998) H2 cooling: low-density limit
        gpldl [erg cm^3/s per (H2 * HI)] and LTE gphdl [erg/s per H2].
    """
    kcol: jax.Array
    k13dd: jax.Array
    cool: jax.Array
    h2cool: jax.Array
    compa: float

    @classmethod
    def from_tables(cls, tables, dtype=jnp.float64) -> "NoneqTablesDevice":
        names = [f"k{i}" for i in range(1, 20)] + ["k22"]
        kcol = np.stack([tables.k[n] for n in names], axis=-1)
        cool = np.stack([
            tables.ceHI, tables.ceHeI, tables.ceHeII, tables.ciHI,
            tables.ciHeI, tables.ciHeIS, tables.ciHeII, tables.reHII,
            tables.reHeII1, tables.reHeII2, tables.reHeIII, tables.brem,
            tables.lineHI], axis=-1)
        h2cool = np.stack([tables.gpldl, tables.gphdl], axis=-1)
        # rate tables span ~1e-40..1e-8: store the log for float32 safety,
        # exponentiating after interpolation (also improves interp accuracy
        # for the steeply-varying exponential rates)
        return cls(
            kcol=jnp.asarray(np.log(np.maximum(kcol, 1e-300)), dtype),
            k13dd=jnp.asarray(tables.k13dd, dtype),
            cool=jnp.asarray(np.log(np.maximum(cool, 1e-300)), dtype),
            h2cool=jnp.asarray(np.log(np.maximum(h2cool, 1e-300)), dtype),
            compa=float(tables.compa))


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SpeciesState:
    """Number densities [cm^-3] of the 9-species network plus internal
    energy density [erg/cm^3].  All arrays share one grid shape."""
    HI: jax.Array
    HII: jax.Array
    HeI: jax.Array
    HeII: jax.Array
    HeIII: jax.Array
    de: jax.Array
    HM: jax.Array
    H2I: jax.Array      # H2 molecule number density (molecules, not nuclei)
    H2II: jax.Array
    eint: jax.Array

    @property
    def nh(self) -> jax.Array:
        """Total hydrogen nuclei [cm^-3]."""
        return self.HI + self.HII + self.HM + 2.0 * (self.H2I + self.H2II)

    @property
    def nhe(self) -> jax.Array:
        return self.HeI + self.HeII + self.HeIII

    @property
    def ntot(self) -> jax.Array:
        """Total particle number density (free electrons included)."""
        return (self.HI + self.HII + self.HeI + self.HeII + self.HeIII
                + self.de + self.HM + self.H2I + self.H2II)

    @property
    def tgas(self) -> jax.Array:
        """Temperature from the internal energy [K]."""
        return (GAMMA_ADIABATIC - 1.0) * self.eint / (KB * self.ntot)

    def charge_electrons(self) -> jax.Array:
        """Electron density implied by charge neutrality."""
        return self.HII + self.HeII + 2.0 * self.HeIII + self.H2II - self.HM


@dataclasses.dataclass(frozen=True)
class PhotoRates:
    """Per-particle photo rates [1/s] and the photoheating rate density
    [erg/cm^3/s].  Scalars or arrays broadcastable to the grid shape."""
    k24: jax.Array | float = 0.0   # HI + g -> HII + e
    k25: jax.Array | float = 0.0   # HeII + g -> HeIII + e
    k26: jax.Array | float = 0.0   # HeI + g -> HeII + e
    k27: jax.Array | float = 0.0   # H- + g -> HI + e
    k28: jax.Array | float = 0.0   # H2+ + g -> HI + HII
    k29: jax.Array | float = 0.0   # H2 + g -> H2+ + e
    k30: jax.Array | float = 0.0   # H2+ + g -> 2 HII + e
    k31: jax.Array | float = 0.0   # H2 + g -> 2 HI   (Lyman-Werner)
    heat: jax.Array | float = 0.0  # photoheating [erg/cm^3/s]


def species_from_field_state(state, f_h2: float = 0.0,
                             f_hm: float = 0.0) -> SpeciesState:
    """Initialize the 9-species state from a FieldState (H/He fields).

    f_h2 / f_hm: initial H2 / H- fractions of total hydrogen nuclei.
    Internal energy follows from state.tgas.
    """
    nh, nhe = state.nh, state.nhe
    H2I = 0.5 * f_h2 * nh
    HM = f_hm * nh
    HI = jnp.maximum(state.HI - 2.0 * H2I - HM, 0.0)
    HII = jnp.maximum(nh - HI - HM - 2.0 * H2I, 0.0)
    HeI, HeII = state.HeI, state.HeII
    HeIII = jnp.maximum(nhe - HeI - HeII, 0.0)
    z = jnp.zeros_like(nh)
    sp = SpeciesState(HI=HI, HII=HII, HeI=HeI, HeII=HeII, HeIII=HeIII,
                      de=z, HM=HM, H2I=H2I, H2II=z, eint=z)
    de = jnp.maximum(sp.charge_electrons(), 0.0)
    sp = dataclasses.replace(sp, de=de)
    eint = KB * state.tgas * sp.ntot / (GAMMA_ADIABATIC - 1.0)
    return dataclasses.replace(sp, eint=eint)


def _lookup_log(table_2d, logtem):
    """Linear interpolation of log-stored columns; returns exp of result."""
    logtem = jnp.clip(logtem, LOGTEM0, LOGTEM9)
    pos = (logtem - LOGTEM0) / DLOGTEM
    idx = jnp.clip(pos.astype(jnp.int32), 0, table_2d.shape[0] - 2)
    frac = (pos - idx)[..., None]
    lo = table_2d[idx]
    hi = table_2d[idx + 1]
    return jnp.exp(lo + frac * (hi - lo))


def _lookup_lin(table_2d, logtem):
    logtem = jnp.clip(logtem, LOGTEM0, LOGTEM9)
    pos = (logtem - LOGTEM0) / DLOGTEM
    idx = jnp.clip(pos.astype(jnp.int32), 0, table_2d.shape[0] - 2)
    frac = (pos - idx)[..., None]
    lo = table_2d[idx]
    hi = table_2d[idx + 1]
    return lo + frac * (hi - lo)


def _k13_density_dependent(k13dd_row, HI, tgas):
    """Density-dependent H2 collisional dissociation rate [cm^3/s].

    Composes the 7 tabulated fit functions exactly as the reference's
    consumer contract documents (colh2diss.f:110-113):

      log10 k13 = f1 - f2/(1 + (nH/f5)^f7) + f3 - f4/(1 + (nH/f6)^f7)

    with nH = n_HI [cm^-3].  f1/f2/f5 carry the direct collisional
    dissociation process, f3/f4/f6 the dissociative tunnelling process
    (Martin, Schwartz & Mandy 1996 fits; colh2diss.f:74-104), each as a
    high-density-limit term with a low/high-density switch at its own
    critical density.  Outside the fit's validity range (500 K < T < 1e6 K
    the tabulated functions are sentinels; colh2diss.f:57-66) the rate is
    floored to 1e-60, matching the reference's `CID = -60` convention.
    """
    f = tuple(k13dd_row[..., i] for i in range(7))
    n = jnp.maximum(HI, 1e-10)
    lognH = jnp.log10(n)
    # (n/f5)^f7 evaluated in log space for overflow safety
    x5 = jnp.clip(f[6] * (lognH - jnp.log10(jnp.maximum(f[4], 1e-30))),
                  -30.0, 30.0)
    x6 = jnp.clip(f[6] * (lognH - jnp.log10(jnp.maximum(f[5], 1e-30))),
                  -30.0, 30.0)
    logk = (f[0] - f[1] / (1.0 + 10.0 ** x5)
            + f[2] - f[3] / (1.0 + 10.0 ** x6))
    valid = (tgas > 500.0) & (tgas < 1.0e6)
    logk = jnp.where(valid, jnp.clip(logk, -60.0, 0.0), -60.0)
    return 10.0 ** logk


def _substep_rates(sp: SpeciesState, k, photo: PhotoRates, k13):
    """Creation/destruction terms for the sequential BDF1 update.

    Returns a dict of (creation, destruction) pairs per species, where the
    update is x_new = (x + dt*C) / (1 + dt*D) and D has units 1/s.
    """
    (k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11, k12, _k13t, k14, k15,
     k16, k17, k18, k19, k22) = k
    HI, HII, de = sp.HI, sp.HII, sp.de
    HeI, HeII, HeIII = sp.HeI, sp.HeII, sp.HeIII
    HM, H2I, H2II = sp.HM, sp.H2I, sp.H2II

    rates = {}
    # HI:  created by recombination and H2 destruction channels, destroyed
    # by ionization and the molecular formation chain.
    c_HI = (k2 * HII * de
            + 2.0 * k12 * H2I * de
            + k11 * H2I * HII
            + 2.0 * k13 * H2I * HI
            + k14 * HM * de
            + k15 * HM * HI
            + 2.0 * k16 * HM * HII
            + 2.0 * k18 * H2II * de
            + k19 * H2II * HM
            + photo.k27 * HM
            + photo.k28 * H2II
            + 2.0 * photo.k31 * H2I)
    d_HI = (k1 * de + k7 * de + k8 * HM + k9 * HII + k10 * H2II
            + 2.0 * k22 * HI * HI + photo.k24)
    rates["HI"] = (c_HI, d_HI)

    c_HII = (k1 * HI * de + k10 * H2II * HI + photo.k24 * HI
             + photo.k28 * H2II + 2.0 * photo.k30 * H2II)
    d_HII = k2 * de + k9 * HI + k11 * H2I + (k16 + k17) * HM
    rates["HII"] = (c_HII, d_HII)

    c_de = (k1 * HI * de + k3 * HeI * de + k5 * HeII * de
            + k8 * HM * HI + k14 * HM * de + k15 * HM * HI + k17 * HM * HII
            + photo.k24 * HI + photo.k25 * HeII + photo.k26 * HeI
            + photo.k27 * HM + photo.k29 * H2I + photo.k30 * H2II)
    d_de = (k2 * HII + k4 * HeII + k6 * HeIII + k7 * HI + k18 * H2II)
    rates["de"] = (c_de, d_de)

    c_HeI = k4 * HeII * de
    d_HeI = k3 * de + photo.k26
    rates["HeI"] = (c_HeI, d_HeI)

    c_HeII = k3 * HeI * de + k6 * HeIII * de + photo.k26 * HeI
    d_HeII = (k4 + k5) * de + photo.k25
    rates["HeII"] = (c_HeII, d_HeII)

    c_HeIII = k5 * HeII * de + photo.k25 * HeII
    d_HeIII = k6 * de
    rates["HeIII"] = (c_HeIII, d_HeIII)

    c_H2 = k8 * HM * HI + k10 * H2II * HI + k19 * H2II * HM + k22 * HI ** 3
    d_H2 = k11 * HII + k12 * de + k13 * HI + photo.k29 + photo.k31
    rates["H2I"] = (c_H2, d_H2)
    return rates


def _equilibrium_hm_h2ii(sp: SpeciesState, k, photo: PhotoRates, tiny):
    """Algebraic equilibrium for the fast species H- and H2+
    (Anninos et al. 1997 §3; lifetimes ~<1e4 s in any regime where they
    matter)."""
    (k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11, k12, _k, k14, k15,
     k16, k17, k18, k19, k22) = k
    HI, HII, de, H2I = sp.HI, sp.HII, sp.de, sp.H2I
    HM = (k7 * HI * de) / jnp.maximum(
        k8 * HI + k14 * de + k15 * HI + (k16 + k17) * HII
        + k19 * sp.H2II + photo.k27, tiny)
    H2II = (k9 * HI * HII + k11 * H2I * HII + k17 * HM * HII
            + photo.k29 * H2I) / jnp.maximum(
        k10 * HI + k18 * de + k19 * HM + photo.k28 + photo.k30, tiny)
    return HM, H2II


def _cooling_rate(sp: SpeciesState, tgas, tables: NoneqTablesDevice,
                  current_redshift: float):
    """Net radiative cooling [erg/cm^3/s] (positive = cooling): the atomic
    cooling function of thermalEquilibrium
    (/root/reference/equiSources.f90:3991-4029) plus Galli & Palla (1998)
    H2 cooling from the tabulated gpldl/gphdl fits."""
    c = _lookup_log(tables.cool, jnp.log(tgas))
    (ceHI, ceHeI, ceHeII, ciHI, ciHeI, ciHeIS, ciHeII, reHII, reHeII1,
     reHeII2, reHeIII, brem, _lineHI) = (c[..., i] for i in range(13))
    de, HI, HII = sp.de, sp.HI, sp.HII
    HeI, HeII, HeIII = sp.HeI, sp.HeII, sp.HeIII

    comp1 = tables.compa * (1.0 + current_redshift) ** 4
    comp2 = 2.73 * (1.0 + current_redshift)

    cool = (ceHI * HI * de
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
            + brem * (HII + HeII + 4.0 * HeIII) * de)

    h2 = _lookup_log(tables.h2cool, jnp.log(tgas))
    gpldl, gphdl = h2[..., 0], h2[..., 1]
    # Galli & Palla smooth low-density <-> LTE interpolation
    lam_h2 = sp.H2I * gphdl / (1.0 + gphdl / jnp.maximum(gpldl * HI, 1e-300
                               if de.dtype == jnp.float64 else 1e-37))
    return cool + lam_h2


def evolve_noneq(sp: SpeciesState, dt: float, tables: NoneqTablesDevice,
                 photo: PhotoRates | None = None,
                 n_substeps: int = 200,
                 evolve_energy: bool = True,
                 tgas_fixed: jax.Array | None = None,
                 current_redshift: float = 0.0,
                 safety: float = 0.1) -> SpeciesState:
    """Advance the 9-species network by dt [s].

    Fixed-trip-count vectorized sub-cycling: each cell consumes its own
    remaining time with per-cell steps limited to `safety` (10%) relative
    change in electron density (and internal energy, when evolved).  Cells
    that finish early take zero-length substeps — pure lanes, no control
    flow.  If n_substeps is too small for the stiffest cell the update is
    still positivity-preserving; the remaining deficit shows up as
    first-order error (pick n_substeps ~ a few hundred for cold dense gas).

    With evolve_energy=False the temperature is held at tgas_fixed (or
    sp.tgas at entry), matching the reference's fixed-T contract.
    """
    if photo is None:
        photo = PhotoRates()
    dtype = sp.HI.dtype
    tiny = 1e-300 if dtype == jnp.float64 else 1e-37
    if tgas_fixed is None:
        tgas_fixed = sp.tgas

    nh0 = sp.nh
    nhe0 = sp.nhe

    def substep(carry, _):
        sp, remaining = carry
        tgas = sp.tgas if evolve_energy else tgas_fixed
        tgas = jnp.clip(tgas, 1.0, 1e9)
        logtem = jnp.log(tgas)
        kk = _lookup_log(tables.kcol, logtem)
        k = tuple(kk[..., i] for i in range(20))
        k13dd_row = _lookup_lin(tables.k13dd, logtem)
        k13 = _k13_density_dependent(k13dd_row, sp.HI, tgas)
        k = k[:12] + (k13,) + k[13:]

        # --- timestep limiter ---------------------------------------------
        r = _substep_rates(sp, k, photo, k13)
        dedot = r["de"][0] - r["de"][1] * sp.de
        hidot = r["HI"][0] - r["HI"][1] * sp.HI
        dt_de = safety * jnp.maximum(sp.de, 1e-6 * nh0) / jnp.maximum(
            jnp.abs(dedot), tiny)
        dt_hi = safety * jnp.maximum(sp.HI, 1e-6 * nh0) / jnp.maximum(
            jnp.abs(hidot), tiny)
        # H2 can evolve on its own timescale while de/HI are static (e.g.
        # pure Lyman-Werner dissociation), so it gets its own limiter; the
        # 1e-6*nh floor keeps trace-level H2 from throttling ionized gas
        h2dot = r["H2I"][0] - r["H2I"][1] * sp.H2I
        dt_h2 = safety * jnp.maximum(sp.H2I, 1e-6 * nh0) / jnp.maximum(
            jnp.abs(h2dot), tiny)
        dtit = jnp.minimum(jnp.minimum(jnp.minimum(dt_de, dt_hi), dt_h2),
                           remaining)
        if evolve_energy:
            cool = _cooling_rate(sp, tgas, tables, current_redshift)
            edot = photo.heat - cool
            dt_e = safety * sp.eint / jnp.maximum(jnp.abs(edot), tiny)
            dtit = jnp.minimum(dtit, dt_e)
        dtit = jnp.maximum(dtit, 0.0)

        # --- sequential BDF1 update (Gauss-Seidel in species) -------------
        def bdf(x, cd, dt):
            c, d = cd
            return (x + dt * c) / (1.0 + dt * d)

        HI = bdf(sp.HI, r["HI"], dtit)
        HII = bdf(sp.HII, r["HII"], dtit)
        sp1 = dataclasses.replace(sp, HI=HI, HII=HII)
        r1 = _substep_rates(sp1, k, photo, k13)
        de = bdf(sp.de, r1["de"], dtit)
        sp1 = dataclasses.replace(sp1, de=de)
        r2 = _substep_rates(sp1, k, photo, k13)
        HeI = bdf(sp.HeI, r2["HeI"], dtit)
        HeII = bdf(sp.HeII, r2["HeII"], dtit)
        HeIII = bdf(sp.HeIII, r2["HeIII"], dtit)
        sp1 = dataclasses.replace(sp1, HeI=HeI, HeII=HeII, HeIII=HeIII)
        HM, H2II = _equilibrium_hm_h2ii(sp1, k, photo, tiny)
        sp1 = dataclasses.replace(sp1, HM=HM, H2II=H2II)
        r3 = _substep_rates(sp1, k, photo, k13)
        H2I = bdf(sp.H2I, r3["H2I"], dtit)
        sp1 = dataclasses.replace(sp1, H2I=H2I)

        # --- conservation rescale (Anninos 97 eq. 27 analog) --------------
        h_tot = sp1.HI + sp1.HII + sp1.HM + 2.0 * (sp1.H2I + sp1.H2II)
        fh = nh0 / jnp.maximum(h_tot, tiny)
        he_tot = sp1.HeI + sp1.HeII + sp1.HeIII
        fhe = nhe0 / jnp.maximum(he_tot, tiny)
        sp1 = dataclasses.replace(
            sp1, HI=sp1.HI * fh, HII=sp1.HII * fh, HM=sp1.HM * fh,
            H2I=sp1.H2I * fh, H2II=sp1.H2II * fh,
            HeI=sp1.HeI * fhe, HeII=sp1.HeII * fhe, HeIII=sp1.HeIII * fhe)
        de_new = jnp.maximum(sp1.charge_electrons(), tiny)
        sp1 = dataclasses.replace(sp1, de=de_new)

        if evolve_energy:
            cool = _cooling_rate(sp1, tgas, tables, current_redshift)
            eint = jnp.maximum(sp1.eint + dtit * (photo.heat - cool),
                               0.1 * sp1.eint)
            sp1 = dataclasses.replace(sp1, eint=eint)
        else:
            # keep eint consistent with the fixed temperature
            eint = KB * tgas_fixed * sp1.ntot / (GAMMA_ADIABATIC - 1.0)
            sp1 = dataclasses.replace(sp1, eint=eint)

        return (sp1, remaining - dtit), None

    remaining = jnp.full_like(sp.HI, dt)
    (sp, _), _ = jax.lax.scan(substep, (sp, remaining), None,
                              length=n_substeps)
    return sp
