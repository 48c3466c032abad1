"""End-to-end two-level AMR iteration tests."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiativetransfer_tpu.config import MODE_UVB_TRANSFER_ONLY, RunConfig
from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import amr, step as step_mod, step_amr
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu.io import snapshot


def _models(n=6, box_kpc=300.0):
    cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                    n_angular_level=1, reionization_model=10, grid="amr")
    geom = GridGeometry(n, n, n, box_kpc * KPC)
    rt = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
    return rt, step_amr.AMRModel.setup(rt)


class TestAmrStep:
    def test_unrefined_matches_uniform_step(self):
        n = 6
        rt, am = _models(n)
        base = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64)
        st = amr.make_amr_state(base, jnp.zeros((n, n, n), bool))
        out_amr = am.make_step()(st)
        out_uni = jax.jit(rt.transport_chemistry_step)(base)
        np.testing.assert_allclose(np.asarray(out_amr.base.HI),
                                   np.asarray(out_uni.HI), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(out_amr.base.Jmean),
                                   np.asarray(out_uni.Jmean), rtol=1e-10)

    def test_refined_region_evolves(self):
        n = 6
        rt, am = _models(n, box_kpc=500.0)
        base = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64)
        refined = np.zeros((n, n, n), bool)
        refined[2:4, 2:4, 2:4] = True
        st = amr.make_amr_state(base, jnp.asarray(refined))
        nf0 = am.neutral_fraction(st)
        step = am.make_step()
        for _ in range(3):
            st = step(st)
        nf = am.neutral_fraction(st)
        assert 0.0 < nf < nf0  # UVB ionizes
        # restriction consistency: base parents equal child averages
        r = np.asarray(st.refined)
        hi_restr = np.asarray(amr.restrict(st.fine.HI))
        np.testing.assert_allclose(np.asarray(st.base.HI)[r], hi_restr[r],
                                   rtol=1e-12)
        # fine region self-shields more than its surroundings would suggest:
        # at least the fine values are physical
        xf = np.asarray(st.fine.HI / st.fine.nh)
        assert np.all((xf >= -1e-12) & (xf <= 1 + 1e-9))

    def test_amr_snapshot_round_trip(self, tmp_path):
        n = 4
        rt, am = _models(n)
        base = uniform_state(n, nh=1e-3, tgas=1.2e4, dtype=jnp.float64)
        refined = np.zeros((n, n, n), bool)
        refined[1:3, 1:3, 1:3] = True
        st = amr.make_amr_state(base, jnp.asarray(refined))
        st = am.make_step()(st)
        p = str(tmp_path / "cellArray0001.npz")
        snapshot.write_snapshot_amr(p, st, 1, rt.geom.physical_box_size)

        fresh = amr.make_amr_state(
            uniform_state(n, nh=1e-3, tgas=1e4, dtype=jnp.float64),
            jnp.asarray(refined))
        restored, itime = snapshot.read_snapshot_amr(p, fresh)
        assert itime == 1
        np.testing.assert_allclose(np.asarray(restored.base.HI),
                                   np.asarray(st.base.HI), rtol=1e-6)
        rf = np.asarray(amr.prolong_mask(st.refined))
        np.testing.assert_allclose(np.asarray(restored.fine.HI)[rf],
                                   np.asarray(st.fine.HI)[rf], rtol=1e-6)

    def test_leaf_count(self):
        n = 4
        refined = np.zeros((n, n, n), bool)
        refined[0, 0, 0] = True
        st = amr.make_amr_state(
            uniform_state(n, dtype=jnp.float64), jnp.asarray(refined))
        assert st.n_leaves() == n ** 3 - 1 + 8
