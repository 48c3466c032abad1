"""Point-source ray-tracer tests: photon conservation and the analytic
Stromgren-sphere oracle (SURVEY.md §4b)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiativetransfer_tpu.constants import CASE_B, KPC, MH, PSI
from radiativetransfer_tpu.core import chemistry, rays
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu.tables import chemistry_rates as cr
from radiativetransfer_tpu.tables import stellar


@pytest.fixture(scope="module")
def pop():
    return stellar.blackbody_population(temperature=1.0e5, q_ionizing=5.0e48)


@pytest.fixture(scope="module")
def src_tables(pop):
    t = stellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
    return {
        "reaction_log": jnp.asarray(t.reaction_log)[None],   # 1 bucket
        "energy_log": jnp.asarray(t.energy_log)[None],
        "output_freq": t.output_freq,
        "output_sigma24": t.output_sigma24,
        "output_sigma25": t.output_sigma25,
        "output_sigma26": t.output_sigma26,
        "output_sigma_dust": t.output_sigma_dust,
    }, t.total_integral


@pytest.fixture(scope="module")
def dev_tables():
    return chemistry.RateTablesDevice.from_tables(
        cr.calc_rates(recombination_type=CASE_B))


def _center_source(n):
    c = n // 2
    pos = np.array([[(c + 0.5) / n, (c + 0.5) / n, (c + 0.5) / n]])
    return rays.SourceBatch(position=pos, weight=np.array([1.0]),
                            table_idx=np.array([0], np.int32))


class TestSourceTables:
    def test_zero_depth_rate_is_ionizing_luminosity(self, src_tables):
        tables, total = src_tables
        # reactionRate1 at zero attenuation = the full ionizing photon rate
        r0 = float(jnp.exp(tables["reaction_log"][0, 0, 0, 0, 0, 0]))
        assert r0 == pytest.approx(total, rel=1e-10)
        assert total == pytest.approx(5.0e48, rel=0.05)

    def test_rates_decrease_with_depth(self, src_tables):
        tables, _ = src_tables
        r = np.asarray(jnp.exp(tables["reaction_log"][0, 0]))
        assert np.all(np.diff(r[:, 0, 0, 0]) < 0)        # tau1 axis
        assert np.all(r > 0)

    def test_interp_matches_nodes(self, src_tables):
        tables, _ = src_tables
        num, heat = stellar.interp_rates_4d(
            tables["reaction_log"][0], tables["energy_log"][0],
            jnp.array([3.0]), jnp.array([2.0]), jnp.array([1.0]),
            jnp.array([0.0]))
        expect = float(jnp.exp(tables["reaction_log"][0, 0, 3, 2, 1, 0]))
        assert float(num[0, 0]) == pytest.approx(expect, rel=1e-10)

    def test_out_of_range_zero(self, src_tables):
        tables, _ = src_tables
        num, heat = stellar.interp_rates_4d(
            tables["reaction_log"][0], tables["energy_log"][0],
            jnp.array([11.0]), jnp.array([0.0]), jnp.array([0.0]),
            jnp.array([0.0]))
        assert float(num[0, 0]) == 0.0

    def test_quadrature_matches_table_nodes(self, pop, src_tables):
        """The direct spectral quadrature (core.rays._deposit_quadrature)
        evaluates the same sum the 4-D tables store, so the two agree
        exactly ON the tau grid nodes (between nodes the table
        interpolates and the quadrature is exact)."""
        tables, _ = src_tables
        quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
        for tau in ([0.0, 0.0, 0.0, 0.0], [3.0, 2.0, 1.0, 0.0],
                    [1.0, 0.0, 4.0, 2.0]):
            t1, t2, t3, td = tau
            num, heat = stellar.interp_rates_4d(
                tables["reaction_log"][0], tables["energy_log"][0],
                jnp.array([t1]), jnp.array([t2]), jnp.array([t3]),
                jnp.array([td]))
            e = np.exp(-(np.array(tau) @ quad_a))
            for band in range(3):
                num_q = float(e @ quad_w[:, band])
                heat_q = float(e @ quad_w[:, band + 3])
                assert float(num[band, 0]) == pytest.approx(num_q, rel=1e-6)
                assert float(heat[band, 0]) == pytest.approx(heat_q, rel=1e-6)

    def test_quadrature_deposit_f32_highest_matches_oracle(self, pop):
        """The f32 quadrature deposit pins its products to HIGHEST (on the
        GPU an unpinned f32 product may run in TF32, ~3 digits) and agrees
        with the float64 serial oracle for optical depths up to the f32
        kill depth."""
        from reference_impl import quadrature_deposit_serial
        quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
        quad_w = quad_w / np.abs(quad_w).max()     # f32-representable
        rng = np.random.default_rng(7)
        r = 64
        depth = rng.uniform(0.0, 30.0, (r, 4)) * [1.0, 1.0, 1.0, 0.0]
        dtau = 10.0 ** rng.uniform(-6.0, 0.5, (r, 3))
        args = (jnp.asarray(depth, jnp.float32),
                jnp.asarray(dtau, jnp.float32),
                jnp.asarray(quad_a, jnp.float32),
                jnp.asarray(quad_w[None], jnp.float32),
                jnp.zeros(r, jnp.int32), jnp.ones(r, jnp.float32))
        eqns = jax.make_jaxpr(rays._deposit_quadrature)(*args).eqns
        dots = [e for e in eqns if e.primitive.name == "dot_general"]
        highest = jax.lax.Precision.HIGHEST
        assert dots and all(e.params["precision"] == (highest, highest)
                            for e in dots)
        got = rays._deposit_quadrature(*args)
        ref = [quadrature_deposit_serial(depth[i], dtau[i], quad_a, quad_w)
               for i in range(r)]
        for k, name in enumerate(("krate24", "krate25", "krate26",
                                  "crate24", "crate25", "crate26")):
            want = np.array([x[name] for x in ref])
            have = np.asarray(got[k], np.float64)
            assert got[k].dtype == jnp.float32
            sig = np.abs(want) > 1e-6 * np.abs(want).max()
            np.testing.assert_allclose(have[sig], want[sig], rtol=1e-4)

    def test_h_only_band_mode(self, pop, src_tables, dev_tables):
        """n_bands=1 (H-only configs) deposits identical krate24/crate24
        and zero He channels."""
        tables, _ = src_tables
        quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
        tables = dict(tables)
        tables["quad_A"], tables["quad_W"] = quad_a, quad_w[None]
        n = 16
        geom = GridGeometry(n, n, n, 100 * KPC)
        state = uniform_state(n, nh=1e-2, tgas=1e4, dtype=jnp.float64)
        rf3, _ = rays.trace_point_sources(state, geom, _center_source(n),
                                          tables, max_pixel_level=3,
                                          rates_mode="quadrature", n_bands=3)
        rf1, _ = rays.trace_point_sources(state, geom, _center_source(n),
                                          tables, max_pixel_level=3,
                                          rates_mode="quadrature", n_bands=1)
        np.testing.assert_allclose(np.asarray(rf1.krate24),
                                   np.asarray(rf3.krate24), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(rf1.crate24),
                                   np.asarray(rf3.crate24), rtol=1e-12)
        assert float(jnp.sum(jnp.abs(rf1.krate25))) == 0.0
        assert float(jnp.sum(jnp.abs(rf1.crate26))) == 0.0

    def test_tracer_quadrature_close_to_table(self, pop, src_tables,
                                              dev_tables):
        """Full traces in the two rate modes agree to interpolation error."""
        tables, total = src_tables
        quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
        tables = dict(tables)
        tables["quad_A"], tables["quad_W"] = quad_a, quad_w[None]
        n = 16
        geom = GridGeometry(n, n, n, 100 * KPC)
        state = uniform_state(n, nh=1e-2, tgas=1e4, dtype=jnp.float64)
        rf_t, _ = rays.trace_point_sources(state, geom, _center_source(n),
                                           tables, max_pixel_level=3,
                                           rates_mode="table")
        rf_q, _ = rays.trace_point_sources(state, geom, _center_source(n),
                                           tables, max_pixel_level=3,
                                           rates_mode="quadrature")
        tot_t = float(jnp.sum(rf_t.krate24))
        tot_q = float(jnp.sum(rf_q.krate24))
        assert tot_q == pytest.approx(tot_t, rel=0.02)
        assert float(jnp.sum(rf_q.crate24)) == pytest.approx(
            float(jnp.sum(rf_t.crate24)), rel=0.05)


class TestPhotonConservation:
    def test_transparent_box_deposits_nothing(self, src_tables, dev_tables):
        tables, total = src_tables
        n = 16
        geom = GridGeometry(n, n, n, 100 * KPC)
        state = uniform_state(n, nh=1e-30, tgas=1e4, dtype=jnp.float64)
        rf, diag = rays.trace_point_sources(state, geom, _center_source(n),
                                            tables, max_pixel_level=3)
        assert float(jnp.sum(rf.krate24)) < 1e-10 * total
        # everything escapes: fraction at radii inside the box ~ 1
        frac = rays.escape_fractions(diag, np.array([1.0]))[0]
        inside = np.array([0.1, 0.3, 1.0, 3.0, 10.0, 30.0]) < 50.0
        np.testing.assert_allclose(frac[:6][inside[:6]], 1.0, atol=1e-6)

    def test_opaque_box_absorbs_ionizing_photons(self, src_tables, dev_tables):
        tables, total = src_tables
        n = 16
        geom = GridGeometry(n, n, n, 100 * KPC)
        # neutral dense gas: every HI-ionizing photon absorbed near the source
        state = uniform_state(n, nh=1.0, tgas=1e4, dtype=jnp.float64)
        rf, diag = rays.trace_point_sources(state, geom, _center_source(n),
                                            tables, max_pixel_level=3)
        absorbed = float(jnp.sum(rf.krate24))
        assert absorbed == pytest.approx(total, rel=0.05)
        # absorption concentrated in the source cell's neighborhood
        k = np.asarray(rf.krate24).reshape(n, n, n)
        c = n // 2
        assert k[c, c, c] > 0.5 * absorbed

    def test_heating_exceeds_zero_when_absorbing(self, src_tables):
        tables, total = src_tables
        n = 16
        geom = GridGeometry(n, n, n, 100 * KPC)
        state = uniform_state(n, nh=1e-2, tgas=1e4, dtype=jnp.float64)
        rf, diag = rays.trace_point_sources(state, geom, _center_source(n),
                                            tables, max_pixel_level=3)
        assert float(jnp.sum(rf.crate24)) > 0.0


class TestStromgrenSphere:
    def test_stromgren_radius(self, src_tables, dev_tables):
        """Single source in uniform H gas: the converged ionization front
        must sit at the analytic Stromgren radius
        R_S = (3 Q / (4 pi alpha_B nH^2))^(1/3)."""
        tables, q_ion = src_tables
        n = 32
        nh_val = 1.0e-3
        box = 16.0 * KPC
        geom = GridGeometry(n, n, n, box)
        alpha_b = float(cr.interp_log_t(
            cr.calc_rates(recombination_type=CASE_B).k["k2"], np.log(1.0e4)))
        r_s = (3.0 * q_ion / (4.0 * np.pi * alpha_b * nh_val ** 2)) ** (1.0 / 3.0)
        assert 0.2 * box < r_s < 0.45 * box  # sanity: front inside the box

        state = uniform_state(n, nh=nh_val, tgas=1e4, dtype=jnp.float64)
        src = _center_source(n)
        vol = geom.cell_volume

        HI = state.HI
        for it in range(12):
            st = dataclasses.replace(state, HI=HI)
            rf, diag = rays.trace_point_sources(st, geom, src, tables,
                                                max_pixel_level=5)
            g24 = jnp.where(HI > 0,
                            rf.krate24.reshape(n, n, n) / (vol * jnp.where(HI > 0, HI, 1.0)),
                            0.0)
            HI_new, _ = chemistry.solve_h_only_equilibrium(
                state.nh, state.tgas, jnp.maximum(g24, 0.0), dev_tables)
            if float(jnp.max(jnp.abs(HI_new - HI))) < 1e-6 * nh_val:
                HI = HI_new
                break
            HI = HI_new

        xneu = np.asarray(HI).reshape(n, n, n) / nh_val
        c = n // 2
        # radial profile of the neutral fraction
        idx = np.indices((n, n, n))
        r_cells = np.sqrt(((idx - c + 0.5) ** 2).sum(axis=0))
        r_cm = r_cells * geom.cell_size
        # ionized interior, neutral exterior
        assert xneu[c, c, c] < 0.01
        assert xneu[0, 0, 0] > 0.9
        # front position: radius where the shell-averaged xneu crosses 0.5
        shells = np.linspace(0.02 * box, 0.5 * box, 23)
        prof = np.array([xneu[(r_cm >= a) & (r_cm < b)].mean()
                         for a, b in zip(shells[:-1], shells[1:])])
        centers = 0.5 * (shells[:-1] + shells[1:])
        i_front = int(np.argmax(prof > 0.5))
        r_front = centers[i_front]
        assert r_front == pytest.approx(r_s, rel=0.2)

        # conservation in equilibrium: total photoionizations/s equal total
        # recombinations/s (hard photons with tiny sigma escape the box, so
        # the absorbed count is below Q; the *balance* must hold exactly)
        total_ion = float(jnp.sum(rf.krate24))
        HII = np.asarray(state.nh) - np.asarray(HI).reshape(n, n, n)
        total_rec = float(np.sum(alpha_b * HII * HII) * geom.cell_volume)
        assert total_ion == pytest.approx(total_rec, rel=0.05)
        assert total_ion < q_ion


def test_stromgren_convergence_at_64(tmp_path):
    """Measured-resolution tightening (VERDICT r2 weak-4): at 64^3 the 3-D
    front radius matches the 1-D spectral-quadrature oracle to well under a
    percent (measured r3: err_vol -0.02%, err_half +0.05%; bounds 5x/10x).
    scripts/stromgren_convergence.py runs the 32/64/128 sequence."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "stromgren_convergence",
        os.path.join(os.path.dirname(__file__), "..", "scripts",
                     "stromgren_convergence.py"))
    strom = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(strom)
    r = strom.run_one(64, 6, jnp.float32)
    assert abs(r["err_vol_pct"]) < 0.1, r
    assert abs(r["err_half_pct"]) < 0.5, r


class TestF32KillEquivalence:
    """The f32 termination policy (tau_kill=30 + spectrum-exhaustion
    rel_kill=1e-10, core.rays defaults for f32) must reproduce the
    reference semantics (tau_kill=100, no rel_kill,
    /root/reference/equiSources.f90:3241) to float accumulation
    precision — the killed tail deposits e^-30 ~ 1e-13 of a ray's own
    scale."""

    def test_tau_kill_f32_equivalence(self, pop):
        n = 24
        t = stellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
        geom = GridGeometry(n, n, n, 60.0 * KPC)  # dense: tau builds fast
        quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
        log_vol = float(np.log(geom.cell_size) * 3)
        tables = {"quad_A": jnp.asarray(quad_a),
                  "quad_W": jnp.asarray(quad_w / np.exp(log_vol))[None],
                  "output_freq": t.output_freq,
                  "output_sigma24": t.output_sigma24,
                  "output_sigma25": t.output_sigma25,
                  "output_sigma26": t.output_sigma26,
                  "output_sigma_dust": t.output_sigma_dust}
        src = _center_source(n)
        state = uniform_state(n, nh=1e-2, tgas=1.0e4, dtype=jnp.float64)

        def trace(tau_kill, rel_kill):
            rf, diag = rays.trace_point_sources(
                state, geom, src, tables, max_pixel_level=4,
                dtype=jnp.float64, rates_mode="quadrature",
                tau_kill=tau_kill, rel_kill=rel_kill)
            return rf, diag

        rf_ref, diag_ref = trace(100.0, 0.0)        # reference semantics
        rf_f32, diag_f32 = trace(30.0, 1.0e-10)     # f32 policy, in f64
        for f in ("krate24", "krate25", "krate26", "crate24", "crate25",
                  "crate26"):
            a = np.asarray(getattr(rf_ref, f))
            b = np.asarray(getattr(rf_f32, f))
            scale = np.abs(a).max()
            if scale == 0.0:
                # no HeII in the state -> the band-3 threshold channels
                # deposit exactly zero in both policies
                assert np.abs(b).max() == 0.0, f
            else:
                assert np.abs(a - b).max() <= 1e-9 * scale, f
        a = np.asarray(diag_ref.ndot_remaining)
        b = np.asarray(diag_f32.ndot_remaining)
        assert np.abs(a - b).max() <= 1e-9 * max(a.max(), 1e-30)


class TestCompactTracer:
    """Host-driven final-phase compaction (trace_point_sources_compact)
    must reproduce the jittable tracer exactly up to deposit scatter
    ORDER (float rounding)."""

    def test_compact_matches_standard(self, pop):
        n = 24
        t = stellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
        geom = GridGeometry(n, n, n, 300.0 * KPC)
        quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
        log_vol = float(np.log(geom.cell_size) * 3)
        tables = {"quad_A": jnp.asarray(quad_a),
                  "quad_W": jnp.asarray(quad_w / np.exp(log_vol))[None],
                  "output_freq": t.output_freq,
                  "output_sigma24": t.output_sigma24,
                  "output_sigma25": t.output_sigma25,
                  "output_sigma26": t.output_sigma26,
                  "output_sigma_dust": t.output_sigma_dust}
        rng = np.random.default_rng(0)
        pos = (np.floor(rng.uniform(0.3, 0.7, (3, 3)) * n) + 0.5) / n
        src = rays.SourceBatch(position=pos, weight=np.ones(3),
                               table_idx=np.zeros(3, np.int32))
        state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=jnp.float64)

        rf_a, dg_a = rays.trace_point_sources(
            state, geom, src, tables, max_pixel_level=4,
            dtype=jnp.float64, rates_mode="quadrature")
        rf_b, dg_b = rays.trace_point_sources_compact(
            state, geom, src, tables, max_pixel_level=4,
            dtype=jnp.float64, rates_mode="quadrature", chunk=8)
        for f in ("krate24", "krate25", "krate26", "crate24", "crate25",
                  "crate26"):
            a = np.asarray(getattr(rf_a, f))
            b = np.asarray(getattr(rf_b, f))
            sc = np.abs(a).max()
            if sc == 0.0:
                assert np.abs(b).max() == 0.0, f
            else:
                assert np.abs(a - b).max() <= 1e-12 * sc, f
        for f in ("ndot_remaining", "ndot_boundary", "ndot_spectrum"):
            a = np.asarray(getattr(dg_a, f))
            b = np.asarray(getattr(dg_b, f))
            sc = max(np.abs(a).max(), 1e-300)
            assert np.abs(a - b).max() <= 1e-12 * sc, f
