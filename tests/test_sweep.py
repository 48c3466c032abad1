"""Tests for the diffuse sweep: physics invariants + parity with the serial
cell-by-cell oracle (SURVEY.md §4c/e)."""

import jax.numpy as jnp
import numpy as np
import pytest

from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import sweep
from radiativetransfer_tpu.geometry import healpix, octants

from reference_impl import serial_sweep


def _make_kappa(n, rng=None, tau_scale=1.0):
    """Random smooth opacity field, mean optical depth per cell ~ tau_scale."""
    rng = rng or np.random.default_rng(42)
    cell = KPC
    base = rng.lognormal(mean=0.0, sigma=1.0, size=(3, n, n, n))
    return base * (tau_scale / cell), cell


class TestSweepParity:
    @pytest.mark.parametrize("direction", [0, 17, 63, 100, 150, 191])
    def test_single_direction_matches_serial(self, direction):
        n = 6
        kappa, cell = _make_kappa(n, tau_scale=0.7)
        uvb = np.array([1.0, 0.5, 0.25])
        j_serial = serial_sweep(kappa, 3, uvb, cell, directions=[direction])

        plan_full = sweep.build_sweep_plan(3, n)
        # restrict the plan to the zone containing this direction only is
        # awkward; instead run the vectorized sweep per-zone via a filtered plan
        phi, theta = healpix.sweep_directions(3)
        d = octants.fold_direction(phi[direction], theta[direction])
        from radiativetransfer_tpu.geometry import patterns as pat
        p = pat.stack_patterns([pat.build_slab_patterns(d.phi, d.theta, n)])
        zone = sweep.ZoneBatch(izone=d.izone, ndir=1, len_xy=p.len_xy,
                               len_xz=p.len_xz, len_yz=p.len_yz,
                               chain2=p.chain2, chain3=p.chain3,
                               n_active=p.n_active)
        plan = sweep.SweepPlan(zones=(zone,), n_directions=plan_full.n_directions,
                               nslab=n)
        j_vec = np.asarray(sweep.diffuse_sweep(jnp.asarray(kappa), plan,
                                               jnp.asarray(uvb), cell))
        np.testing.assert_allclose(j_vec, j_serial, rtol=1e-10, atol=1e-14)

    def test_all_directions_match_serial_small(self):
        n = 4
        kappa, cell = _make_kappa(n, tau_scale=0.5)
        uvb = np.array([1.0, 0.6, 0.3])
        j_serial = serial_sweep(kappa, 1, uvb, cell)  # 12 directions

        plan = sweep.build_sweep_plan(1, n)
        j_vec = np.asarray(sweep.diffuse_sweep(jnp.asarray(kappa), plan,
                                               jnp.asarray(uvb), cell))
        np.testing.assert_allclose(j_vec, j_serial, rtol=1e-10, atol=1e-14)


class TestSweepPhysics:
    def test_transparent_box_recovers_uvb(self):
        # kappa -> 0: every ray carries the boundary intensity unattenuated,
        # so Jmean == uvb everywhere in every band
        n = 6
        kappa = jnp.full((3, n, n, n), 1e-30)
        uvb = jnp.array([1.0, 0.5, 0.25])
        plan = sweep.build_sweep_plan(1, n)
        j = sweep.diffuse_sweep(kappa, plan, uvb, KPC)
        np.testing.assert_allclose(np.asarray(j),
                                   np.asarray(uvb)[:, None, None, None]
                                   * np.ones((3, n, n, n)), rtol=1e-6)

    def test_transparent_box_recovers_uvb_f32(self):
        # the f32 path (the card's default) through its small-tau branch
        n = 6
        kappa = jnp.full((3, n, n, n), 1e-30, jnp.float32)
        uvb = jnp.array([1.0, 0.5, 0.25], jnp.float32)
        plan = sweep.build_sweep_plan(1, n)
        j = sweep.diffuse_sweep(kappa, plan, uvb, KPC)
        assert j.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(j),
                                   np.asarray(uvb)[:, None, None, None]
                                   * np.ones((3, n, n, n)), rtol=1e-5)

    def test_opaque_box_center_dark(self):
        # very optically thick uniform box: the center sees (almost) nothing
        n = 8
        cell = KPC
        kappa = jnp.full((3, n, n, n), 10.0 / cell)  # tau=10 per cell
        uvb = jnp.array([1.0, 1.0, 1.0])
        plan = sweep.build_sweep_plan(1, n)
        j = np.asarray(sweep.diffuse_sweep(kappa, plan, uvb, cell))
        c = n // 2
        assert np.all(j[:, c, c, c] < 1e-6)
        # boundary cells still see some light
        assert np.all(j[:, 0, 0, 0] > 1e-3)

    def test_uniform_slab_attenuation_law(self):
        # uniform absorption: J at depth d from one face along a single
        # direction ~ exp(-kappa * path). Checked per direction against the
        # serial oracle elsewhere; here check monotonic decay toward center.
        n = 10
        cell = KPC
        kappa = jnp.full((3, n, n, n), 0.5 / cell)
        uvb = jnp.array([1.0, 1.0, 1.0])
        plan = sweep.build_sweep_plan(1, n)
        j = np.asarray(sweep.diffuse_sweep(kappa, plan, uvb, cell))
        c = n // 2
        profile = j[0, :, c, c]
        # symmetric-ish and decreasing toward the center
        assert profile[0] > profile[2] > profile[c - 1]
        assert profile[-1] > profile[-3]
        assert profile.argmin() in (c - 1, c)

    def test_band_independence(self):
        # bands attenuate independently with their own kappa
        n = 6
        cell = KPC
        rng = np.random.default_rng(7)
        k1 = rng.lognormal(size=(n, n, n)) / cell
        kappa_a = jnp.asarray(np.stack([k1, 2 * k1, 3 * k1]))
        uvb = jnp.array([1.0, 1.0, 1.0])
        plan = sweep.build_sweep_plan(2, n)
        j_a = np.asarray(sweep.diffuse_sweep(kappa_a, plan, uvb, cell))
        # band 0 of a run with kappa k1 equals band 2 of a run where band 2
        # has kappa k1
        kappa_b = jnp.asarray(np.stack([3 * k1, k1, k1]))
        j_b = np.asarray(sweep.diffuse_sweep(kappa_b, plan, uvb, cell))
        np.testing.assert_allclose(j_a[0], j_b[1], rtol=1e-12)

    def test_jmean_positive_and_bounded(self):
        n = 6
        kappa, cell = _make_kappa(n, tau_scale=1.0)
        uvb = np.array([1.0, 0.5, 0.25])
        plan = sweep.build_sweep_plan(2, n)
        j = np.asarray(sweep.diffuse_sweep(jnp.asarray(kappa), plan,
                                           jnp.asarray(uvb), cell))
        assert np.all(j > 0)
        # J cannot exceed the boundary intensity (no emission inside)
        assert np.all(j <= np.asarray(uvb)[:, None, None, None] * (1 + 1e-9))


class TestSweepPlan:
    def test_malformed_chain_table_rejected(self):
        """The plan check (SURVEY.md 5.2): the slab step selects shifts and
        lengths by chain code, so a corrupted code must be rejected before
        it can silently give wrong intensities."""
        import dataclasses

        plan = sweep.build_sweep_plan(1, 8)
        bad_zone = plan.zones[0]
        chain2 = np.asarray(bad_zone.chain2).copy()
        chain2[0, 0] = 7                       # not a segment code
        bad_zone = dataclasses.replace(bad_zone, chain2=chain2)
        with pytest.raises(ValueError, match="malformed chain table"):
            sweep.validate_zone_tables(bad_zone)
        for z in plan.zones:                   # real plans pass
            sweep.validate_zone_tables(z)
