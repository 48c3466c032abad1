"""Stromgren-sphere resolution convergence (VERDICT round-1 item 9).

Single blackbody source in uniform hydrogen, iterated to photoionization
equilibrium; the ionization-front radius is compared with the analytic
R_S = (3 Q / (4 pi alpha_B nH^2))^(1/3) at 32^3 / 64^3 / 128^3
to show the error shrinking with
resolution.  Reference analog: the point-source solve of
equiSources.f90:1260-1364 with the split law :304-309.

Run on the GPU:  python scripts/stromgren_convergence.py
Env: STROM_NS="32,64,128"   grid sizes
     STROM_F64=1            float64 (default f32)
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from radiativetransfer_tpu.constants import CASE_B, KPC
from radiativetransfer_tpu.core import chemistry, rays
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu.tables import chemistry_rates as cr
from radiativetransfer_tpu.tables import stellar

Q_ION = 5.0e48
NH = 1.0e-3
BOX = 16.0 * KPC
R_CAP = 0.45 * BOX     # estimator cap: stay inside the inscribed sphere


def radial_oracle(quad_a: np.ndarray, quad_w: np.ndarray, alpha_b: float,
                  n_r: int = 8192, n_iter: int = 40) -> dict:
    """High-resolution 1-D spherically-symmetric equilibrium profile.

    Solves the same physics as the 3-D run — multi-frequency attenuation
    with the SAME spectral quadrature (A, W) and case-B recombination at
    T = 1e4 K — on a fine radial grid, so the 3-D front-radius error
    against it measures RESOLUTION error only (the analytic monochromatic
    R_S misses spectral hardening: hard sigma ~ nu^-3 photons pre-ionize
    gas beyond the front, a physical offset that does not shrink with n).
    """
    sig = quad_a[0] * float(__import__(
        "radiativetransfer_tpu.constants", fromlist=["SIGMA24_AT_NU1"]
    ).SIGMA24_AT_NU1)                                   # (F,) sigma_HI [cm^2]
    n_phot = quad_w[:, 0].copy()                        # photons/s per bin
    r = (np.arange(n_r) + 0.5) * (R_CAP / n_r)
    dr = R_CAP / n_r
    x = np.full(n_r, 1e-6)
    for _ in range(n_iter):
        col = np.concatenate([[0.0], np.cumsum(NH * x * dr)])[:-1]   # (n_r,)
        atten = np.exp(-np.minimum(col[:, None] * sig[None, :], 200.0))
        gam = (atten * (n_phot * sig)[None, :]).sum(1) / (4 * np.pi * r ** 2)
        b = 2.0 * alpha_b * NH + gam
        x = (b - np.sqrt(np.maximum(b * b - 4 * (alpha_b * NH) ** 2, 0.0))) \
            / (2.0 * alpha_b * NH)
        x = np.clip(x, 1e-12, 1.0)
    v_ion = float(((1.0 - x) * 4 * np.pi * r ** 2 * dr).sum())
    r_vol = (3.0 * v_ion / (4.0 * np.pi)) ** (1.0 / 3.0)
    r_half = float(np.interp(0.5, x, r))    # x monotonically rises outward
    return {"r_vol": r_vol, "r_half": r_half, "x": x, "r": r}


def run_one(n: int, max_pixel_level: int, dtype) -> dict:
    geom = GridGeometry(n, n, n, BOX)
    pop = stellar.blackbody_population(temperature=1.0e5, q_ionizing=Q_ION)
    quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
    t = stellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
    q_ion = t.total_integral
    tables = {
        "quad_A": jnp.asarray(quad_a, dtype),
        "quad_W": jnp.asarray(quad_w / geom.cell_volume, dtype)[None],
        "output_freq": t.output_freq, "output_sigma24": t.output_sigma24,
        "output_sigma25": t.output_sigma25, "output_sigma26": t.output_sigma26,
        "output_sigma_dust": t.output_sigma_dust,
    }
    tabs = cr.calc_rates(recombination_type=CASE_B)
    dev_tables = chemistry.RateTablesDevice.from_tables(tabs, dtype)
    alpha_b = float(cr.interp_log_t(tabs.k["k2"], np.log(1.0e4)))
    r_s = (3.0 * q_ion / (4.0 * np.pi * alpha_b * NH ** 2)) ** (1.0 / 3.0)

    c = n // 2
    pos = np.array([[(c + 0.5) / n] * 3])
    src = rays.SourceBatch(position=pos, weight=np.array([1.0]),
                           table_idx=np.array([0], np.int32))
    state = uniform_state(n, nh=NH, tgas=1e4, dtype=dtype)
    # pure hydrogen, like the 1-D oracle: with H-only chemistry, neutral He
    # would otherwise absorb every >24.6 eV photon forever
    z = jnp.zeros_like(state.HeI)
    state = dataclasses.replace(state, HeI=z, HeII=z)

    HI = state.HI
    t0 = time.perf_counter()
    n_iters = int(os.environ.get("STROM_ITERS", "40"))
    for it in range(n_iters):
        st = dataclasses.replace(state, HI=HI)
        rf, _ = rays.trace_point_sources(st, geom, src, tables,
                                         max_pixel_level=max_pixel_level,
                                         dtype=dtype, n_bands=1)
        # volumetric deposits [1/s/cm^3] -> per-particle rate
        g24 = jnp.where(HI > 0, rf.krate24.reshape(n, n, n)
                        / jnp.where(HI > 0, HI, 1.0), 0.0)
        HI_new, _ = chemistry.solve_h_only_equilibrium(
            state.nh, state.tgas, jnp.maximum(g24, 0.0), dev_tables)
        delta = float(jnp.max(jnp.abs(HI_new - HI)))
        # damped lambda iteration: the bare fixpoint ping-pongs at the front
        HI = 0.5 * (HI_new + HI) if it > 2 else HI_new
        if delta < 1e-5 * NH:
            break
    dt = time.perf_counter() - t0
    # photons absorbed inside the box: hard photons (sigma ~ nu^-3) escape
    # the 16-kpc domain, so the photon-conserving oracle radius uses the
    # MEASURED absorption, R_eff = (3 Q_abs / (4 pi alpha_B nH^2))^(1/3)
    # (the reference's own balance logic, tests/test_rays.py r1 note)
    q_abs = float(jnp.sum(rf.krate24)) * geom.cell_volume
    r_eff = r_s * (q_abs / q_ion) ** (1.0 / 3.0)

    xneu = np.asarray(HI, np.float64) / NH
    idx = np.indices((n, n, n))
    r_cm = np.sqrt(((idx - c) ** 2).sum(axis=0)) * geom.cell_size

    # 1-D oracle with the same spectral quadrature (resolution-error target)
    orc = radial_oracle(quad_a, quad_w, alpha_b)

    # front estimator 1: ionized-volume radius (3 V_ion / 4pi)^(1/3),
    # capped at the inscribed sphere like the oracle
    inside = r_cm < R_CAP
    v_ion = float(((1.0 - xneu[inside]) * geom.cell_volume).sum())
    r_vol = (3.0 * v_ion / (4.0 * np.pi)) ** (1.0 / 3.0)
    # front estimator 2: shell-averaged xneu = 0.5 crossing
    shells = np.linspace(0.05 * r_s, 2.0 * r_s, 61)
    prof = np.array([xneu[(r_cm >= a) & (r_cm < b)].mean()
                     for a, b in zip(shells[:-1], shells[1:])])
    centers = 0.5 * (shells[:-1] + shells[1:])
    valid = ~np.isnan(prof)
    r_half = float(np.interp(0.5, prof[valid], centers[valid]))

    return {"n": n, "mpl": max_pixel_level, "iters": it + 1, "time_s": dt,
            "r_s_kpc": r_s / KPC, "r_eff_kpc": r_eff / KPC,
            "r_vol_kpc": r_vol / KPC, "r_half_kpc": r_half / KPC,
            "orc_vol_kpc": orc["r_vol"] / KPC,
            "orc_half_kpc": orc["r_half"] / KPC,
            "err_vol_pct": 100 * (r_vol - orc["r_vol"]) / orc["r_vol"],
            "err_half_pct": 100 * (r_half - orc["r_half"]) / orc["r_half"],
            "fesc_pct": 100 * (1.0 - q_abs / q_ion)}


def main():
    dtype = jnp.float64 if os.environ.get("STROM_F64") else jnp.float32
    if dtype == jnp.float64:
        jax.config.update("jax_enable_x64", True)
    ns = [int(x) for x in os.environ.get("STROM_NS", "32,64,128").split(",")]
    mpl = {32: 5, 64: 6, 128: 7}
    print(f"platform {jax.devices()[0].platform}, dtype {jnp.dtype(dtype).name}")
    for n in ns:
        r = run_one(n, mpl.get(n, 6), dtype)
        print(f"n={r['n']:4d} mpl={r['mpl']} iters={r['iters']:2d} "
              f"{r['time_s']:6.1f}s  R_S={r['r_s_kpc']:.3f} "
              f"oracle R_vol={r['orc_vol_kpc']:.3f} "
              f"R_half={r['orc_half_kpc']:.3f} kpc "
              f"(esc {r['fesc_pct']:.1f}%)  "
              f"R_vol={r['r_vol_kpc']:.3f} ({r['err_vol_pct']:+.2f}%)  "
              f"R_half={r['r_half_kpc']:.3f} ({r['err_half_pct']:+.2f}%)")


if __name__ == "__main__":
    main()
