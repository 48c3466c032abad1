"""Stellar-population SEDs and the 4-D attenuation rate tables.

Ports:

* StellarPopulation — Starburst99 `spectrum.out` parsing + interpolation
  (/root/reference/stellarPopulationModule.f90:7-50, parser
  equiSources.f90:847-916).  The reference's SED data files are not shipped;
  a blackbody fallback population is provided so the full point-source
  pipeline runs standalone (SURVEY.md §7.3 "missing data files").

* build_source_tables — the 4-D tables reactionRate1..3 / energyRate1..3
  over (tau1, tau2, tau3, tauDust) on an 11^4 grid
  (stellarBetaTable.f90:217-285).  The reference's quadruple loop over
  attenuation states is restructured as a rank-1-separable product: the
  attenuation factor exp(-sum tau_i s_i(nu)) factorizes per axis, so each
  table is one (nfreq x 121) @ (nfreq x 121) matmul — one dense product and
  ~5000x less exp() work than the reference's 5.9M exp per source.

* interp_rates_4d — quad-linear interpolation of log(rate)
  (getRatesHydrogenHelium, equiSources.f90:4157-4311), vectorized for the
  ray tracer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import (
    ANGSTROM,
    CLIGHT,
    EV_TO_ERG,
    EV_TO_HZ,
    HP,
    KB,
    LOWER_ENERGY,
    MAX_OPTICAL_DEPTH1,
    MAX_OPTICAL_DEPTH2,
    MAX_OPTICAL_DEPTH3,
    MAX_OPTICAL_DEPTH_DUST,
    MYR,
    NDEPTH1,
    NDEPTH2,
    NDEPTH3,
    NDEPTH_DUST,
    NENERGY,
    NU1,
    NU2,
    NU3,
    SIGMA24_AT_NU1,
    SIGMA25_AT_NU3,
    SIGMA26_AT_NU2,
    SIGMA_DUST_AT_NU1,
    UPPER_ENERGY,
)
from . import cross_sections as xs
from .dust import SMC, DustModel


@dataclasses.dataclass
class StellarPopulation:
    """(metallicity, age, wavelength)-interpolated specific luminosity.

    specific_luminosity: log10(erg/s/Angstrom), shape (nmetal, nspectra, nwav)
    spectrum_time: [s] ages of the spectra slices
    wavelength: [cm], ascending
    metallicity_log10: log10(Z) of the metallicity tracks
    """
    specific_luminosity: np.ndarray
    spectrum_time: np.ndarray
    wavelength: np.ndarray
    metallicity_log10: np.ndarray

    def age_bracket(self, age_s: float) -> tuple[int, float]:
        """(iSpectrum, coefSpectrum) for an age (equiSources.f90:1236-1242)."""
        t = self.spectrum_time
        i = 0
        while i + 2 < len(t) and age_s > t[i + 1]:
            i += 1
        coef = (age_s - t[i]) / (t[i + 1] - t[i])
        return i, float(np.clip(coef, 0.0, 1.0))

    def metallicity_bracket(self, abun2: float) -> tuple[int, float]:
        """(iMetal, coefMetal) for a metallicity (equiSources.f90:1282-1293)."""
        lz = np.log10(abun2) if abun2 > 1e-20 else -20.0
        m = self.metallicity_log10
        i = 0
        while i + 2 < len(m) and lz > m[i + 1]:
            i += 1
        coef = (lz - m[i]) / (m[i + 1] - m[i])
        return i, float(np.clip(coef, 0.0, 1.0))

    def luminosity(self, i_spec: int, coef_spec: float, i_metal: int,
                   coef_metal: float, freq_ev) -> np.ndarray:
        """Specific luminosity [erg/s/Hz] at photon energies [eV]
        (stellarPopulation, stellarPopulationModule.f90:7-50), vectorized."""
        freq_ev = np.atleast_1d(np.asarray(freq_ev, np.float64))
        lam = CLIGHT / (freq_ev * EV_TO_HZ)  # [cm]
        wav = self.wavelength
        iw = np.clip(np.searchsorted(wav, lam) - 1, 0, len(wav) - 2)
        cw = np.clip((lam - wav[iw]) / (wav[iw + 1] - wav[iw]), 0.0, 1.0)

        def bilin(imetal):
            sl = self.specific_luminosity[imetal]
            a = (1 - cw) * sl[i_spec, iw] + cw * sl[i_spec, iw + 1]
            b = (1 - cw) * sl[i_spec + 1, iw] + cw * sl[i_spec + 1, iw + 1]
            return (1 - coef_spec) * a + coef_spec * b

        log_l = (1 - coef_metal) * bilin(i_metal) + coef_metal * bilin(i_metal + 1)
        # log10(erg/s/A) -> erg/s/Hz  (stellarPopulationModule.f90:48)
        return (10.0 ** log_l) / ANGSTROM * CLIGHT / (freq_ev * EV_TO_HZ) ** 2


def parse_starburst99(paths: list[str], metallicities: list[float],
                      luminosity_shift_log10: float = 0.0) -> StellarPopulation:
    """Parse Starburst99 `spectrum.out` files (equiSources.f90:847-916).

    luminosity_shift_log10 folds in the per-particle normalization and
    mass-resolution rescaling (:886-916).
    """
    all_sl = []
    spectrum_time = None
    wavelength = None
    for path in paths:
        times, wavs, lums = [], [], []
        cur_time = None
        with open(path) as fh:
            lines = iter(fh.readlines())
        reading = False
        sl_rows: list[list[float]] = []
        cur_wavs: list[float] = []
        cur_lums: list[float] = []
        for line in lines:
            if line[1:10] == "TIME [YR]":
                reading = "skip2"
                continue
            if reading == "skip2":
                reading = "skip1"
                continue
            if reading == "skip1":
                reading = True
                if cur_lums:
                    sl_rows.append(cur_lums)
                    cur_lums = []
                continue
            if reading is True and line[1:6] != "MODEL" and line.strip():
                parts = line.split()
                try:
                    t, w, l = float(parts[0]), float(parts[1]), float(parts[2])
                except (ValueError, IndexError):
                    reading = False
                    continue
                if not cur_lums:
                    times.append(t)
                if len(sl_rows) == 0:
                    cur_wavs.append(w)
                cur_lums.append(l)
            else:
                reading = False
        if cur_lums:
            sl_rows.append(cur_lums)
        sl = np.array(sl_rows)
        all_sl.append(sl)
        spectrum_time = np.array(times) * 31557600.0
        wavelength = np.array(cur_wavs) * ANGSTROM
    specific = np.stack(all_sl) + luminosity_shift_log10
    return StellarPopulation(
        specific_luminosity=specific, spectrum_time=spectrum_time,
        wavelength=wavelength,
        metallicity_log10=np.log10(np.asarray(metallicities)))


# Starburst99 synthesis-model layout (equiSources.f90:83-87, 879-884):
# five metallicity tracks, each a model4X-salpeter-burst34/spectrum.out file.
STARBURST99_FILES = tuple(
    f"model4{i}-salpeter-burst34/spectrum.out" for i in range(1, 6))
STARBURST99_METALLICITIES = (0.0004, 0.004, 0.008, 0.020, 0.050)

# mass-resolution luminosity shifts, log10 per particle
# (equiSources.f90:892-916; enum definitionsModule.f90:90-91)
_MASS_PARTICLE_SHIFT = {
    1: 0.0,                                   # normal
    2: -np.log10(8.0),                        # hiRes
    3: -np.log10(64.0),                       # superHiRes
    4: np.log10(5.832 / 8.0),                 # hiResHeavy
    5: -np.log10(512.0),                      # crazyHiRes
    6: 3.0 * np.log10(0.6) - np.log10(512.0),  # light
    7: np.log10(65.0 / (70.0 * 8.0)),         # lyAlpha
    10: np.log10(2.7818),                     # massive
}


def luminosity_shift_log10(n_stars: int, n_stars_specific_age: int,
                           mass_stellar_particle: int = 1) -> float:
    """Per-particle luminosity normalization (equiSources.f90:886-916):
    the Starburst99 tables were computed for 11.6 Msun/yr spread over 34
    particles of a 347-particle fiducial volume; rescale to this run's
    particle count and mass resolution."""
    return (np.log10(n_stars / 347.0 * 34.0
                     / max(n_stars_specific_age, 1))
            + _MASS_PARTICLE_SHIFT[mass_stellar_particle])


def load_population(synthesis_dir: str, n_stars: int,
                    n_stars_specific_age: int,
                    mass_stellar_particle: int = 1
                    ) -> tuple[StellarPopulation, bool]:
    """The driver's SED source: Starburst99 spectrum.out files from
    synthesis_dir when all five metallicity tracks are present
    (equiSources.f90:840-884), else the blackbody fallback (the reference's
    data files are not shipped, SURVEY.md §0).

    Returns (population, used_starburst99)."""
    import os

    shift = luminosity_shift_log10(n_stars, n_stars_specific_age,
                                   mass_stellar_particle)
    if synthesis_dir:
        paths = [os.path.join(synthesis_dir, f) for f in STARBURST99_FILES]
        if all(os.path.exists(p) for p in paths):
            return parse_starburst99(
                paths, list(STARBURST99_METALLICITIES),
                luminosity_shift_log10=shift), True
    return blackbody_population(), False


def metal_bucket_plan(pop: StellarPopulation
                      ) -> tuple[np.ndarray, list[tuple[int, float]]]:
    """Metallicity buckets for source table sharing.

    The reference brackets each source's host metallicity continuously and
    rebuilds the 11^4 tables per source (equiSources.f90:1282-1298); here
    sources bucket to the NEAREST SED track and share its table — B tables
    total instead of one rebuild per source.  Returns (bucket edges in
    linear abun2 for io.sources_io.prepare_sources, metal_coefs for
    StellarContext.build): edges are geometric midpoints between tracks.
    """
    z = 10.0 ** pop.metallicity_log10
    mids = np.sqrt(z[:-1] * z[1:])
    edges = np.concatenate([[0.0], mids, [np.inf]])
    nmetal = len(z)
    coefs: list[tuple[int, float]] = []
    for i in range(nmetal):
        if i < nmetal - 1:
            coefs.append((i, 0.0))
        else:
            coefs.append((nmetal - 2, 1.0))
    return edges, coefs


def blackbody_population(temperature: float = 1.0e5,
                         q_ionizing: float = 1.0e53,
                         n_ages: int = 8, n_metal: int = 2,
                         age_decay_myr: float = 10.0) -> StellarPopulation:
    """Synthetic fallback population: blackbody SED normalized to
    q_ionizing H-ionizing photons/s per particle at age 0, decaying
    exponentially with age.  Stands in for the unavailable Starburst99
    data (SURVEY.md §0); metallicity tracks are identical.
    """
    wav = np.geomspace(1e-7, 1e-4, 600)  # 10 A .. 1e4 A [cm]
    nu_hz = CLIGHT / wav
    ev = nu_hz / EV_TO_HZ
    # photon-count normalization over nu >= nu1
    bb = nu_hz ** 3 / np.expm1(np.clip(HP * nu_hz / (KB * temperature), 1e-6, 500.0))
    mask = ev >= NU1
    # integrate photons/s: L_nu/(h nu) dnu over ionizing range
    order = np.argsort(nu_hz)
    nus, bbs = nu_hz[order], bb[order]
    photons = np.trapezoid(np.where(ev[order] >= NU1, bbs / (HP * nus), 0.0), nus)
    norm = q_ionizing / photons
    l_nu = norm * bb                      # erg/s/Hz
    l_lam = l_nu * CLIGHT / wav ** 2      # erg/s/cm
    log_l = np.log10(np.maximum(l_lam * ANGSTROM, 1e-300))  # log10(erg/s/A)

    ages = np.linspace(0.0, 40.0, n_ages) * MYR
    decay = -0.4343 * ages / (age_decay_myr * MYR)  # log10 of exp decay
    sl = log_l[None, :] + decay[:, None]
    specific = np.broadcast_to(sl, (n_metal, n_ages, len(wav))).copy()
    return StellarPopulation(
        specific_luminosity=specific, spectrum_time=ages, wavelength=wav,
        metallicity_log10=np.linspace(-4.0, -1.3, n_metal))


# ---------------------------------------------------------------------------
# 4-D attenuation tables
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SourceRateTables:
    """Per-(age, metallicity) attenuation tables for the ray tracer.

    reaction_log/energy_log: (3, 11, 11, 11, 11) log of rates
    ([1/s] and [erg/s] per particle).
    output_*: emergent-spectrum sampling arrays (nenergy,)
    (stellarBetaTable.f90:119-152).
    """
    reaction_log: np.ndarray
    energy_log: np.ndarray
    total_integral: float
    output_freq: np.ndarray
    output_sigma24: np.ndarray
    output_sigma25: np.ndarray
    output_sigma26: np.ndarray
    output_sigma_dust: np.ndarray


def output_spectrum_arrays(dust: DustModel | None = None, dust_kind: int = SMC):
    """The 300-point emergent-spectrum frequency/sigma arrays
    (stellarBetaTable.f90:119-152)."""
    i = np.arange(NENERGY, dtype=np.float64)
    freq = LOWER_ENERGY * np.exp(i / (NENERGY - 1) * (np.log(UPPER_ENERGY)
                                                      - np.log(LOWER_ENERGY)))
    s24 = xs.sigma24(freq)
    s24[freq == LOWER_ENERGY] = SIGMA24_AT_NU1  # :133-134 edge case
    s25 = xs.sigma25(freq)
    s26 = xs.sigma26(freq)
    sd = (dust or DustModel()).sigma_at_energy_ev(freq, dust_kind)
    return freq, s24, s25, s26, sd


def build_source_tables(pop: StellarPopulation, i_spec: int, coef_spec: float,
                        i_metal: int, coef_metal: float,
                        nfreq: int = 400, freqdel: float = 0.02,
                        dust: DustModel | None = None,
                        dust_kind: int = SMC) -> SourceRateTables:
    """Build the 11^4 attenuation tables for one SED
    (stellarBetaTable.f90:164-359), separable-product formulation."""
    nu = xs.frequency_grid(nfreq, freqdel)
    s24 = xs.sigma24(nu)
    s25 = xs.sigma25(nu)
    s26 = xs.sigma26(nu)
    dustm = dust or DustModel()
    sdust = dustm.sigma_at_energy_ev(nu, dust_kind)

    lum = pop.luminosity(i_spec, coef_spec, i_metal, coef_metal, nu)
    delta_nu = np.diff(nu)
    f = nu[1:]
    # photons/s per frequency bin (stellarBetaTable.f90:226)
    dtmp = lum[1:] / (f * EV_TO_ERG) * delta_nu * EV_TO_HZ
    total_integral = float(np.sum(np.where(f >= NU1, dtmp, 0.0)))

    # per-axis attenuation factors on the tau grids
    tau1 = np.linspace(0.0, MAX_OPTICAL_DEPTH1, NDEPTH1 + 1)
    tau2 = np.linspace(0.0, MAX_OPTICAL_DEPTH2, NDEPTH2 + 1)
    tau3 = np.linspace(0.0, MAX_OPTICAL_DEPTH3, NDEPTH3 + 1)
    taud = np.linspace(0.0, MAX_OPTICAL_DEPTH_DUST, NDEPTH_DUST + 1)
    a1 = np.exp(-np.outer(s24[1:] / SIGMA24_AT_NU1, tau1))   # (nf-1, 11)
    a2 = np.exp(-np.outer(s26[1:] / SIGMA26_AT_NU2, tau2))
    a3 = np.exp(-np.outer(s25[1:] / SIGMA25_AT_NU3, tau3))
    ad = np.exp(-np.outer(sdust[1:] / SIGMA_DUST_AT_NU1, taud))

    n1, nd = NDEPTH1 + 1, NDEPTH_DUST + 1
    v12 = (a1[:, :, None] * a2[:, None, :]).reshape(len(f), -1)   # (nf, 121)
    v3d = (a3[:, :, None] * ad[:, None, :]).reshape(len(f), -1)   # (nf, 121)

    shape4 = (n1, n1, n1, nd)
    reaction = np.empty((3,) + shape4)
    energy = np.empty((3,) + shape4)
    for r, nu_r in enumerate((NU1, NU2, NU3)):
        wr = np.where(f >= nu_r, dtmp, 0.0)
        we = np.where(f >= nu_r, dtmp * (f - nu_r) * EV_TO_ERG, 0.0)
        reaction[r] = ((v12 * wr[:, None]).T @ v3d).reshape(shape4)
        energy[r] = ((v12 * we[:, None]).T @ v3d).reshape(shape4)

    freq_out, o24, o25, o26, od = output_spectrum_arrays(dustm, dust_kind)
    return SourceRateTables(
        reaction_log=np.log(np.maximum(reaction, 1e-300)),
        energy_log=np.log(np.maximum(energy, 1e-300)),
        total_integral=total_integral,
        output_freq=freq_out, output_sigma24=o24, output_sigma25=o25,
        output_sigma26=o26, output_sigma_dust=od)


def quadrature_arrays(pop: StellarPopulation, i_spec: int, coef_spec: float,
                      i_metal: int, coef_metal: float,
                      nfreq: int = 400, freqdel: float = 0.02,
                      dust: DustModel | None = None,
                      dust_kind: int = SMC) -> tuple[np.ndarray, np.ndarray]:
    """Direct spectral-quadrature form of the attenuation rates.

    The 4-D tables of build_source_tables store
      rate_c(tau) = sum_f W[f, c] * exp(-sum_i tau_i * A[i, f])
    on an 11^4 grid (stellarBetaTable.f90:217-285).  This returns the
    integrand factors themselves so the ray tracer can evaluate the SAME
    sum exactly at arbitrary tau as two small matmuls plus an exp — a
    dense-product form with no table gathers (and no quad-linear
    interpolation error; the reference interpolates,
    equiSources.f90:4157-4311).

    Returns (A, W): A (4, F) attenuation slopes [HI, HeI, HeII, dust] in
    threshold-tau units; W (F, 6) weights [number bands 1..3, heat bands
    1..3] ([1/s] and [erg/s] per unit ndot).
    """
    nu = xs.frequency_grid(nfreq, freqdel)
    s24, s25, s26 = xs.sigma24(nu), xs.sigma25(nu), xs.sigma26(nu)
    dustm = dust or DustModel()
    sdust = dustm.sigma_at_energy_ev(nu, dust_kind)

    lum = pop.luminosity(i_spec, coef_spec, i_metal, coef_metal, nu)
    delta_nu = np.diff(nu)
    f = nu[1:]
    dtmp = lum[1:] / (f * EV_TO_ERG) * delta_nu * EV_TO_HZ

    A = np.stack([s24[1:] / SIGMA24_AT_NU1, s26[1:] / SIGMA26_AT_NU2,
                  s25[1:] / SIGMA25_AT_NU3, sdust[1:] / SIGMA_DUST_AT_NU1])
    W = np.empty((len(f), 6))
    for r, nu_r in enumerate((NU1, NU2, NU3)):
        W[:, r] = np.where(f >= nu_r, dtmp, 0.0)
        W[:, r + 3] = np.where(f >= nu_r, dtmp * (f - nu_r) * EV_TO_ERG, 0.0)
    return A, W


def quadrature_noneq_weights(pop: StellarPopulation, i_spec: int,
                             coef_spec: float, i_metal: int,
                             coef_metal: float,
                             nfreq: int = 400, freqdel: float = 0.02,
                             dust: DustModel | None = None,
                             dust_kind: int = SMC) -> np.ndarray:
    """Sigma-weighted photon-count spectra for the secondary photo channels
    k27..k31 (H- detachment, H2+/H2 photo-processes, Lyman-Werner).

    The reference never deposits these from rays (its non-equilibrium
    network was never wired up); this supplies the missing transport ->
    chemistry coupling for the noneq mode.  The per-cell per-particle rate
    estimator for channel c along a ray segment is

      Gamma_c = ndot * plen / V * sum_f sigma_c(f) W_f exp(-tau . A[:, f])

    (photon flux through the cell x cross-section), evaluated with the same
    attenuation slopes A as quadrature_arrays — sub-Lyman-limit photons
    (e.g. the 11.3-13.6 eV LW band, sigma31) pass unattenuated by HI/HeI/
    HeII exactly as they should since their sigma rows vanish there.

    Returns W27 (F, 5): columns [k27, k28, k29, k30, k31], units
    photons/s * cm^2 per unit ndot; the tracer divides by cell volume and
    multiplies by the physical segment length.
    """
    nu = xs.frequency_grid(nfreq, freqdel)
    sig = {c: getattr(xs, f"sigma{c}")(nu) for c in (27, 28, 29, 30, 31)}
    lum = pop.luminosity(i_spec, coef_spec, i_metal, coef_metal, nu)
    delta_nu = np.diff(nu)
    f = nu[1:]
    dtmp = lum[1:] / (f * EV_TO_ERG) * delta_nu * EV_TO_HZ  # photons/s per bin
    return np.stack([dtmp * sig[c][1:] for c in (27, 28, 29, 30, 31)],
                    axis=-1)


def interp_rates_4d(reaction_log, energy_log, tau1, tau2, tau3, tau_dust,
                    dust_on: bool = True):
    """Quad-linear log-space lookup of (numberRate, heatingRate)
    for all 3 reactions (getRatesHydrogenHelium, equiSources.f90:4157-4311).

    reaction_log/energy_log: (3, 11, 11, 11, 11) jnp arrays (log rates).
    tau*: arrays of any broadcastable shape.
    Returns (number, heat), each (3,) + tau.shape.  Out-of-range taus give 0.
    """
    import jax.numpy as jnp

    out_of_range = ((tau1 > MAX_OPTICAL_DEPTH1) | (tau2 > MAX_OPTICAL_DEPTH2)
                    | (tau3 > MAX_OPTICAL_DEPTH3)
                    | (tau_dust > MAX_OPTICAL_DEPTH_DUST))

    def idx_coef(tau, ndepth, maxdepth):
        pos = jnp.clip(tau, 0.0, maxdepth) / maxdepth * ndepth
        i = jnp.clip(pos.astype(jnp.int32), 0, ndepth - 1)
        return i, pos - i

    i1, c1 = idx_coef(tau1, NDEPTH1, MAX_OPTICAL_DEPTH1)
    i2, c2 = idx_coef(tau2, NDEPTH2, MAX_OPTICAL_DEPTH2)
    i3, c3 = idx_coef(tau3, NDEPTH3, MAX_OPTICAL_DEPTH3)
    if dust_on:
        i4, c4 = idx_coef(tau_dust, NDEPTH_DUST, MAX_OPTICAL_DEPTH_DUST)
    else:
        i4 = jnp.zeros_like(i1)
        c4 = jnp.zeros_like(c1)

    def quad(table):
        acc = 0.0
        for d1 in (0, 1):
            w1 = c1 if d1 else (1.0 - c1)
            for d2 in (0, 1):
                w2 = c2 if d2 else (1.0 - c2)
                for d3 in (0, 1):
                    w3 = c3 if d3 else (1.0 - c3)
                    for d4 in (0, 1):
                        w4 = c4 if d4 else (1.0 - c4)
                        v = table[:, i1 + d1, i2 + d2, i3 + d3, i4 + d4]
                        acc = acc + (w1 * w2 * w3 * w4) * v
        return jnp.exp(acc)

    number = quad(reaction_log)
    heat = quad(energy_log)
    zero = jnp.where(out_of_range, 0.0, 1.0)
    return number * zero, heat * zero
