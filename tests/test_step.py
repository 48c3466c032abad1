"""End-to-end iteration tests: the minimum end-to-end slice (uniform
grid, diffuse UVB, equilibrium chemistry, neutral-fraction convergence)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from radiativetransfer_tpu.config import (
    MODE_NO_STARS_THIN_UVB,
    MODE_UVB_TRANSFER_ONLY,
    RunConfig,
)
from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import step as step_mod
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state


def _model(mode, n=8, box_kpc=200.0, z=6.55, n_angular_level=1):
    cfg = RunConfig(mode=mode, current_redshift=z,
                    self_shielding_threshold_kpc=0.1,
                    n_angular_level=n_angular_level,
                    reionization_model=10, grid="test")
    geom = GridGeometry(n, n, n, box_kpc * KPC)
    return step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)


class TestSetup:
    def test_uvb_band_intensities_ordered(self):
        m = _model(MODE_UVB_TRANSFER_ONLY)
        # spectrum falls with frequency: band1 > band2 > band3
        assert m.uvb[0] > m.uvb[1] > m.uvb[2] > 0
        a1, a2, a3 = m.alpha_bands
        # effective slopes lie between the stellar (5) and quasar (1.8) slopes
        for a in (a1, a2, a3):
            assert 1.8 <= a <= 5.0

    def test_gamma_thin_reionization_normalized(self):
        # after renormalization, the HI photoionization rate equals the
        # tabulated history value at z=6.55 (between table nodes)
        m = _model(MODE_NO_STARS_THIN_UVB)
        g24 = m.gamma_thin[0]
        assert 1e-14 < g24 < 1e-12


class TestThinUvbEquilibrium:
    def test_thin_ionization_converges(self):
        m = _model(MODE_NO_STARS_THIN_UVB, n=6)
        state = uniform_state(6, nh=1e-4, tgas=2e4, dtype=jnp.float64)
        state, hist = step_mod.iterate_to_equilibrium(m, state, max_iter=10)
        # low-density gas under the z~6.5 UVB is highly ionized
        assert hist[-1] < 0.05
        # converged
        assert abs(hist[-1] - hist[-2]) < 1e-6 * hist[-1] + 1e-12

    def test_matches_single_cell_equilibrium(self):
        # the grid result equals an independent single-cell solve
        from radiativetransfer_tpu.core import chemistry
        m = _model(MODE_NO_STARS_THIN_UVB, n=4)
        nh_val = 1e-4
        state = uniform_state(4, nh=nh_val, tgas=2e4, dtype=jnp.float64)
        state, _ = step_mod.iterate_to_equilibrium(m, state, max_iter=10)
        g24, g25, g26 = m.gamma_thin
        HI, HeI, HeII, _ = chemistry.solve_equilibrium(
            jnp.array([nh_val]), jnp.array([nh_val * 0.0789]),
            jnp.array([2e4]),
            jnp.array([g24]), jnp.array([g25]), jnp.array([g26]),
            m.dev_tables)
        got = float(state.HI[2, 2, 2])
        # nhe used in uniform_state: (1-psi)*rho/mhe with rho=nh*mh/psi
        from radiativetransfer_tpu.constants import MH, MHE, PSI
        nhe_val = (1 - PSI) * (nh_val * MH / PSI) / MHE
        HI2, _, _, _ = chemistry.solve_equilibrium(
            jnp.array([nh_val]), jnp.array([nhe_val]), jnp.array([2e4]),
            jnp.array([g24]), jnp.array([g25]), jnp.array([g26]),
            m.dev_tables)
        assert got == pytest.approx(float(HI2[0]), rel=1e-8)


class TestUvbTransferEquilibrium:
    def test_transfer_ionizes_thin_box(self):
        m = _model(MODE_UVB_TRANSFER_ONLY, n=6, box_kpc=50.0)
        state = uniform_state(6, nh=1e-5, tgas=2e4, dtype=jnp.float64)
        state, hist = step_mod.iterate_to_equilibrium(m, state, max_iter=8)
        assert hist[-1] < 0.01
        # Jmean is populated and close to uvb in a transparent box
        j = np.asarray(state.Jmean)
        assert j.shape == (3, 6, 6, 6)
        np.testing.assert_allclose(j[0], m.uvb[0], rtol=0.05)

    def test_dense_box_self_shields(self):
        # box in the self-shielding transition regime: the interior stays
        # neutral while the irradiated corner is substantially ionized
        m = _model(MODE_UVB_TRANSFER_ONLY, n=8, box_kpc=500.0)
        state = uniform_state(8, nh=2e-3, tgas=1e4, dtype=jnp.float64)
        state, hist = step_mod.iterate_to_equilibrium(m, state, max_iter=25)
        xneu = np.asarray(state.HI / state.nh)
        c = 4
        assert xneu[c, c, c] > 0.98
        assert xneu[0, 0, 0] < 0.5
        assert xneu[c, c, c] > 2 * xneu[0, 0, 0]

    def test_step_is_jittable_and_deterministic(self):
        m = _model(MODE_UVB_TRANSFER_ONLY, n=4)
        state = uniform_state(4, nh=1e-3, tgas=1.5e4, dtype=jnp.float64)
        step = m.make_step()
        s1 = step(state)
        s2 = step(state)
        np.testing.assert_array_equal(np.asarray(s1.HI), np.asarray(s2.HI))
        # rates were zeroed, species updated
        assert float(jnp.max(s1.krate24)) == 0.0
        assert not np.allclose(np.asarray(s1.HI), np.asarray(state.HI))
