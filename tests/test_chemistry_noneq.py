"""Oracle tests for the non-equilibrium 9-species chemistry.

The integrator (core.chemistry_noneq.evolve_noneq) is validated against a
scipy stiff-ODE (BDF) integration of the SAME reaction network with the SAME
rate coefficients on 0-D problems — an independent oracle for the
positivity-preserving sequential-BDF1 scheme.  The reaction stoichiometry is
written out independently here from the reference's reaction list
(/root/reference/coll_rates.f:30-49) rather than reusing the module's
creation/destruction terms, so a transcription error in either side fails the
comparison.

k13dd composition is golden-tested against the reference's documented
consumer contract (/root/reference/colh2diss.f:110-113).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp

from radiativetransfer_tpu.core import chemistry_noneq as cn
from radiativetransfer_tpu.constants import GAMMA_ADIABATIC, KB
from radiativetransfer_tpu.tables import chemistry_rates

SPECIES = ("HI", "HII", "HeI", "HeII", "HeIII", "de", "HM", "H2I", "H2II")


@pytest.fixture(scope="module")
def tables():
    return chemistry_rates.calc_rates()


@pytest.fixture(scope="module")
def dev_tables(tables):
    return cn.NoneqTablesDevice.from_tables(tables, jnp.float64)


def _coeffs_at(dev_tables, T):
    """Rate coefficients k1..k19, k22 via the device tables' own lookup, so
    oracle and integrator share identical coefficients."""
    kk = np.asarray(cn._lookup_log(dev_tables.kcol, jnp.log(jnp.float64(T))))
    k13dd = np.asarray(cn._lookup_lin(dev_tables.k13dd,
                                      jnp.log(jnp.float64(T))))
    return kk, k13dd


def _k13_at(dev_tables, T, HI):
    k13dd = cn._lookup_lin(dev_tables.k13dd, jnp.log(jnp.float64(T)))
    return float(cn._k13_density_dependent(k13dd, jnp.float64(HI),
                                           jnp.float64(T)))


def _rhs_factory(dev_tables, T, photo):
    """Net ODE right-hand side from the reference's reaction list
    (coll_rates.f:30-49), fixed temperature."""
    kk, _ = _coeffs_at(dev_tables, T)
    (k1, k2, k3, k4, k5, k6, k7, k8, k9, k10, k11, k12, _k13tab, k14, k15,
     k16, k17, k18, k19, k22) = kk
    p = {f"k{c}": photo.get(f"k{c}", 0.0) for c in range(24, 32)}

    def rhs(_t, y):
        HI, HII, HeI, HeII, HeIII, de, HM, H2I, H2II = np.maximum(y, 0.0)
        k13 = _k13_at(dev_tables, T, HI)
        # per-reaction fluxes [cm^-3 s^-1]
        r1 = k1 * HI * de
        r2 = k2 * HII * de
        r3 = k3 * HeI * de
        r4 = k4 * HeII * de
        r5 = k5 * HeII * de
        r6 = k6 * HeIII * de
        r7 = k7 * HI * de
        r8 = k8 * HM * HI
        r9 = k9 * HI * HII
        r10 = k10 * H2II * HI
        r11 = k11 * H2I * HII
        r12 = k12 * H2I * de
        r13 = k13 * H2I * HI
        r14 = k14 * HM * de
        r15 = k15 * HM * HI
        r16 = k16 * HM * HII
        r17 = k17 * HM * HII
        r18 = k18 * H2II * de
        r19 = k19 * H2II * HM
        r22 = k22 * HI ** 3
        p24 = p["k24"] * HI
        p25 = p["k25"] * HeII
        p26 = p["k26"] * HeI
        p27 = p["k27"] * HM
        p28 = p["k28"] * H2II
        p29 = p["k29"] * H2I
        p30 = p["k30"] * H2II
        p31 = p["k31"] * H2I

        dHI = (-r1 + r2 - r7 - r8 - r9 - r10 + r11 + 2 * r12 + 2 * r13 + r14
               + r15 + 2 * r16 + 2 * r18 + r19 - 2 * r22
               - p24 + p27 + p28 + 2 * p31)
        dHII = (r1 - r2 - r9 + r10 - r11 - r16 - r17
                + p24 + p28 + 2 * p30)
        dHeI = -r3 + r4 - p26
        dHeII = r3 - r4 - r5 + r6 + p26 - p25
        dHeIII = r5 - r6 + p25
        dde = (r1 - r2 + r3 - r4 + r5 - r6 - r7 + r8 + r14 + r15 + r17 - r18
               + p24 + p25 + p26 + p27 + p29 + p30)
        dHM = r7 - r8 - r14 - r15 - r16 - r17 - r19 - p27
        dH2I = r8 + r10 - r11 - r12 - r13 + r19 + r22 - p29 - p31
        dH2II = r9 - r10 + r11 + r17 - r18 - r19 + p29 - p28 - p30
        return [dHI, dHII, dHeI, dHeII, dHeIII, dde, dHM, dH2I, dH2II]

    return rhs


def _species_state(y, T):
    arr = lambda v: jnp.asarray([v], jnp.float64)
    sp = cn.SpeciesState(**{n: arr(v) for n, v in zip(SPECIES, y)},
                         eint=arr(0.0))
    eint = KB * T * sp.ntot / (GAMMA_ADIABATIC - 1.0)
    return dataclasses.replace(sp, eint=eint)


def _run_both(dev_tables, y0, T, dt, photo_dict, n_substeps=1200,
              safety=0.03):
    photo = cn.PhotoRates(**{k: v for k, v in photo_dict.items()})
    sp = _species_state(y0, T)
    sp = cn.evolve_noneq(sp, dt, dev_tables, photo=photo,
                         n_substeps=n_substeps, evolve_energy=False,
                         tgas_fixed=jnp.full_like(sp.HI, T), safety=safety)
    got = np.array([float(getattr(sp, n)[0]) for n in SPECIES])

    sol = solve_ivp(_rhs_factory(dev_tables, T, photo_dict), (0.0, dt), y0,
                    method="BDF", rtol=1e-9, atol=1e-30 * max(y0))
    assert sol.success
    want = sol.y[:, -1]
    return got, want


def _assert_close(got, want, nh, rel=0.03, floor=1e-6):
    """Relative agreement for species above floor*nh.

    Species below the floor are checked loosely (within 2x): HM and H2II are
    algebraic-equilibrium species in evolve_noneq (Anninos et al. 1997 §3)
    but explicit ODEs in the oracle; in diffuse ionized gas their
    equilibration time can exceed the run time, so at trace abundances the
    two formulations legitimately differ without affecting any major
    species.  The cold-dense H2 test compares H2I tightly where the
    equilibrium approximation is valid.
    """
    for name, g, w in zip(SPECIES, got, want):
        if w > floor * nh:
            assert abs(g - w) <= rel * w, (
                f"{name}: got {g:.6e} want {w:.6e} "
                f"(rel {abs(g - w) / w:.3e})")
        else:
            assert g <= 2.0 * w + floor * nh, (
                f"{name} (trace): got {g:.6e} want {w:.6e}")


# --------------------------------------------------------------------------
# oracle scenarios
# --------------------------------------------------------------------------

def test_ionizing_front(dev_tables):
    """Neutral gas hit by a strong ionizing flux."""
    nh, nhe = 1e-3, 1e-4 * 0.79
    x0 = 1e-6
    y0 = np.array([nh * (1 - x0), nh * x0, nhe, 0.0, 0.0, nh * x0,
                   0.0, 0.0, 0.0])
    photo = {"k24": 1e-12, "k26": 5e-13, "k25": 1e-14}
    got, want = _run_both(dev_tables, y0, 1.2e4, 3e12, photo)
    _assert_close(got, want, nh)


def test_recombining_cloud(dev_tables):
    """Fully ionized gas recombining with photo rates switched off.

    Also asserts first-order convergence: halving the substep safety factor
    must roughly halve the error on the fastest-decaying species (HeIII)."""
    nh, nhe = 1.0, 0.079
    y0 = np.array([1e-8 * nh, nh, 1e-8 * nhe, 1e-6 * nhe, nhe,
                   nh + 2 * nhe, 0.0, 0.0, 0.0])
    coarse, want = _run_both(dev_tables, y0, 1.5e4, 3e12, {},
                             n_substeps=1200, safety=0.03)
    got, _ = _run_both(dev_tables, y0, 1.5e4, 3e12, {},
                       n_substeps=4000, safety=0.01)
    _assert_close(got, want, nh, rel=0.04)
    i = SPECIES.index("HeIII")
    err_c = abs(coarse[i] - want[i]) / want[i]
    err_f = abs(got[i] - want[i]) / want[i]
    assert err_f < 0.55 * err_c, (err_c, err_f)


def test_h2_formation_cold_gas(dev_tables):
    """H2 formation through the H-/H2+ channels in cold mostly-neutral gas.

    The residual electron fraction catalyzes H- formation (k7) followed by
    associative detachment (k8); the H2 abundance is the classic Tegmark
    et al. freeze-out.  HM/H2II are algebraic-equilibrium species in
    evolve_noneq and explicit ODEs in the oracle.
    """
    nh, nhe = 1e2, 7.9
    xe = 1e-4
    y0 = np.array([nh * (1 - xe), nh * xe, nhe, 0.0, 0.0, nh * xe,
                   0.0, 0.0, 0.0])
    got, want = _run_both(dev_tables, y0, 800.0, 3e12, {}, n_substeps=600)
    _assert_close(got, want, nh)
    # H2 must actually have formed (meaningful level, not roundoff)
    assert want[7] > 1e-8 * nh
    assert abs(got[7] - want[7]) < 0.05 * want[7]


def test_h2_photodissociation_lw(dev_tables):
    """Lyman-Werner (k31) destruction of an initial H2 reservoir — the
    channel the combined H/He/H2 solve requires."""
    nh = 1.0
    fh2 = 1e-3
    y0 = np.array([nh * (1 - 2 * fh2), 1e-8 * nh, 0.079, 0.0, 0.0,
                   1e-8 * nh, 0.0, fh2 * nh, 0.0])
    photo = {"k31": 1e-11}
    got, want = _run_both(dev_tables, y0, 200.0, 2e11, photo)
    _assert_close(got, want, nh)
    # the reservoir must have been mostly destroyed: e-folding time 1e11 s
    assert want[7] < 0.3 * fh2 * nh


# --------------------------------------------------------------------------
# invariants
# --------------------------------------------------------------------------

def test_conservation_and_positivity(dev_tables):
    """H/He nuclei conservation, charge neutrality, positivity over a grid
    of initial states."""
    rng = np.random.default_rng(7)
    N = 64
    nh = 10.0 ** rng.uniform(-4, 2, N)
    nhe = 0.079 * nh
    x = rng.uniform(0, 1, N)
    T = 10.0 ** rng.uniform(2.2, 6.0, N)
    arr = lambda v: jnp.asarray(v, jnp.float64)
    sp = cn.SpeciesState(
        HI=arr(nh * (1 - x)), HII=arr(nh * x),
        HeI=arr(nhe), HeII=arr(0 * nhe), HeIII=arr(0 * nhe),
        de=arr(nh * x), HM=arr(0 * nh), H2I=arr(0 * nh), H2II=arr(0 * nh),
        eint=arr(np.zeros(N)))
    eint = KB * arr(T) * sp.ntot / (GAMMA_ADIABATIC - 1.0)
    sp = dataclasses.replace(sp, eint=eint)
    photo = cn.PhotoRates(k24=1e-13, k26=5e-14, k25=1e-15)
    out = cn.evolve_noneq(sp, 1e13, dev_tables, photo=photo, n_substeps=300,
                          evolve_energy=False, tgas_fixed=arr(T))
    for n in SPECIES:
        v = np.asarray(getattr(out, n))
        assert np.all(v >= 0.0), n
        assert np.all(np.isfinite(v)), n
    np.testing.assert_allclose(np.asarray(out.nh), nh, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(out.nhe), nhe, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(out.de),
                               np.asarray(out.charge_electrons()), rtol=1e-8)


def test_matches_equilibrium_solver(dev_tables, tables):
    """Long-time noneq limit == the equilibrium bisection solver for a
    pure-photoionization H/He problem (the reference's production regime)."""
    from radiativetransfer_tpu.core import chemistry
    from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
    from radiativetransfer_tpu.constants import KPC

    n = 4
    geom = GridGeometry(n, n, n, 100.0 * KPC)
    state = uniform_state(n, nh=1e-3, tgas=2e4, dtype=jnp.float64)
    dev = chemistry.RateTablesDevice.from_tables(tables, jnp.float64)
    gamma = (3e-13, 1e-15, 2e-14)
    eq = chemistry.solve_rate_equations(
        state.zero_rates(), geom, dev, gamma_thin=gamma,
        self_shielding_threshold=0.0, run_uvb_transfer=False, n_iter=110)

    sp = cn.species_from_field_state(state)
    photo = cn.PhotoRates(k24=gamma[0], k25=gamma[1], k26=gamma[2])
    sp = cn.evolve_noneq(sp, 1e16, dev_tables, photo=photo, n_substeps=500,
                         evolve_energy=False,
                         tgas_fixed=state.tgas.astype(jnp.float64))
    np.testing.assert_allclose(np.asarray(sp.HI), np.asarray(eq.HI),
                               rtol=2e-2)
    np.testing.assert_allclose(np.asarray(sp.HeII), np.asarray(eq.HeII),
                               rtol=5e-2)


# --------------------------------------------------------------------------
# k13dd golden values
# --------------------------------------------------------------------------

def _colh2diss_ref(t):
    """Direct scalar port of colh2diss.f:3-120 (f1..f7)."""
    if t <= 500.0 or t >= 1.0e6:
        return (1e-20, 1e-20, 1e-20, 1e-20, 1.0, 1.0, 0.0)
    y = [0.0, -1.784239e2, -6.842243e1, 4.320243e1, -4.633167e0, 6.970086e1,
         4.087038e4, -2.370570e4, 1.288953e2, -5.391334e1, 5.315517e0,
         -1.973427e1, 1.678095e4, -2.578611e4, 1.482123e1, -4.890915e0,
         4.749030e-1, -1.338283e2, -1.164408e0, 8.227443e-1, 5.864073e-1,
         -2.056313e0]
    tl = np.log10(t)
    a = y[1] + y[2] * tl + y[3] * tl**2 + y[4] * tl**3 + y[5] * np.log10(1 + y[6] / t)
    a1 = y[7] / t
    b = y[8] + y[9] * tl + y[10] * tl**2 + y[11] * np.log10(1 + y[12] / t)
    b1 = y[13] / t
    c = y[14] + y[15] * tl + y[16] * tl**2 + y[17] / t
    c1 = y[18] + c
    d = y[19] + y[20] * np.exp(-t / 1850.0) + y[21] * np.exp(-t / 440.0)
    return (a, a - b, a1, a1 - b1, 10.0**c, 10.0**c1, d)


@pytest.mark.parametrize("T,nH", [(600.0, 1.0), (2000.0, 1e2), (1e4, 1e4),
                                  (1e5, 1e8), (3e5, 1e-2)])
def test_k13dd_composition(dev_tables, T, nH):
    """k13(T, nH) == the commented consumer formula of colh2diss.f:110-113
    evaluated on the directly-ported fit functions."""
    f1, f2, f3, f4, f5, f6, f7 = _colh2diss_ref(T)
    want = 10.0 ** (f1 - f2 / (1.0 + (nH / f5) ** f7)
                    + f3 - f4 / (1.0 + (nH / f6) ** f7))
    got = _k13_at(dev_tables, T, nH)
    assert abs(got - want) <= 2e-3 * want


def test_k13dd_out_of_range(dev_tables):
    assert _k13_at(dev_tables, 400.0, 1e3) <= 1e-59
    assert _k13_at(dev_tables, 2e6, 1e3) <= 1e-59
