"""Multi-device tests on the 8-virtual-device CPU mesh (SURVEY.md §4f):
sharded results must equal single-device results."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiativetransfer_tpu.config import MODE_UVB_TRANSFER_ONLY, RunConfig
from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import step as step_mod, sweep
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu.parallel import mesh as pmesh


needs_devices = pytest.mark.skipif(len(jax.devices()) < 8,
                                   reason="needs 8 virtual devices")


@needs_devices
class TestShardedSweep:
    def test_sweep_matches_single_device(self):
        n = 16
        rng = np.random.default_rng(0)
        cell = KPC
        kappa = jnp.asarray(rng.lognormal(0, 1, (3, n, n, n)) * 0.5 / cell,
                            jnp.float64)
        uvb = jnp.asarray([1.0, 0.5, 0.25], jnp.float64)
        plan = sweep.build_sweep_plan(1, n)
        j_single = np.asarray(sweep.diffuse_sweep(kappa, plan, uvb, cell))

        mesh = pmesh.make_grid_mesh(8)
        kappa_sh = jax.device_put(kappa, pmesh.band_field_sharding(mesh))
        run = jax.jit(lambda k: sweep.diffuse_sweep(k, plan, uvb, cell))
        j_sharded = np.asarray(run(kappa_sh))
        np.testing.assert_allclose(j_sharded, j_single, rtol=1e-12)

    def test_full_step_matches_single_device(self):
        n = 16
        cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                        n_angular_level=1, reionization_model=10, grid="t")
        geom = GridGeometry(n, n, n, 300.0 * KPC)
        model = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        state = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64)

        out_single = jax.jit(model.transport_chemistry_step)(state)

        mesh = pmesh.make_grid_mesh(8)
        state_sh = pmesh.shard_state(state, mesh)
        out_sharded = jax.jit(model.transport_chemistry_step)(state_sh)

        np.testing.assert_allclose(np.asarray(out_sharded.HI),
                                   np.asarray(out_single.HI), rtol=1e-11)
        np.testing.assert_allclose(np.asarray(out_sharded.Jmean),
                                   np.asarray(out_single.Jmean), rtol=1e-11)

    def test_explicit_pipelined_matches_single_device(self):
        """The shard_map + ppermute halo-line sweep (SURVEY.md §5.8/§7.3)
        must reproduce the serial sweep to roundoff."""
        from radiativetransfer_tpu.parallel import sweep_dist
        n = 16
        rng = np.random.default_rng(1)
        cell = KPC
        kappa = jnp.asarray(rng.lognormal(0, 1, (3, n, n, n)) * 0.5 / cell,
                            jnp.float64)
        uvb = jnp.asarray([1.0, 0.5, 0.25], jnp.float64)
        plan = sweep.build_sweep_plan(1, n)
        j_single = np.asarray(sweep.diffuse_sweep(kappa, plan, uvb, cell))

        mesh = pmesh.make_grid_mesh(8)
        kappa_sh = jax.device_put(kappa, pmesh.band_field_sharding(mesh))
        run = sweep_dist.make_jitted_sweep_dist(plan, mesh, "pipelined")
        j_dist = run(kappa_sh, uvb, cell)
        # output stays grid-decomposed (no gather)
        assert len(j_dist.sharding.device_set) == 8
        np.testing.assert_allclose(np.asarray(j_dist), j_single, rtol=1e-13)

    def test_explicit_zone_parallel_matches_single_device(self):
        """The angle-decomposed psum sweep must reproduce the serial sweep:
        each device sweeps its round-robin share of the 24 octant zones."""
        from radiativetransfer_tpu.parallel import sweep_dist
        n = 12
        rng = np.random.default_rng(2)
        cell = KPC
        kappa = jnp.asarray(rng.lognormal(0, 1, (3, n, n, n)) * 0.5 / cell,
                            jnp.float64)
        uvb = jnp.asarray([1.0, 0.5, 0.25], jnp.float64)
        plan = sweep.build_sweep_plan(2, n)   # 48 dirs -> all 24 zones
        assert len(plan.zones) == 24
        j_single = np.asarray(sweep.diffuse_sweep(kappa, plan, uvb, cell))

        mesh = pmesh.make_grid_mesh(8)
        run = sweep_dist.make_jitted_sweep_dist(plan, mesh, "zones")
        j_dist = np.asarray(run(kappa, uvb, cell))
        np.testing.assert_allclose(j_dist, j_single, rtol=1e-13)

    def test_sharded_output_stays_sharded(self):
        # the chemistry update must not gather the grid to one device
        n = 16
        cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                        n_angular_level=1, reionization_model=10, grid="t")
        geom = GridGeometry(n, n, n, 300.0 * KPC)
        model = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        state = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64)
        mesh = pmesh.make_grid_mesh(8)
        state_sh = pmesh.shard_state(state, mesh)
        out = jax.jit(model.transport_chemistry_step)(state_sh)
        assert len(out.HI.sharding.device_set) == 8


@needs_devices
class TestDistributedRays:
    """Source-parallel point-source tracing (parallel.rays_dist) vs the
    single-device tracer — VERDICT round-1 item 1."""

    def _setup(self, n_sources):
        from radiativetransfer_tpu.constants import MYR
        from radiativetransfer_tpu.core import rays
        from radiativetransfer_tpu.tables import stellar as stellar_tables
        n = 16
        cfg = RunConfig(mode=8, current_redshift=6.55,
                        n_angular_level=1, reionization_model=10, grid="t")
        geom = GridGeometry(n, n, n, 50.0 * KPC)
        state = uniform_state(n, nh=1e-3, tgas=1e4, dtype=jnp.float64)
        rng = np.random.default_rng(11)
        batch = rays.SourceBatch(
            position=rng.uniform(0.15, 0.85, (n_sources, 3)),
            weight=rng.integers(1, 4, n_sources).astype(np.float64),
            table_idx=np.zeros(n_sources, np.int32))
        pop = stellar_tables.blackbody_population()
        ctx = step_mod.StellarContext.build(
            pop, batch, geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
            max_pixel_level=3)
        return state, geom, ctx

    @pytest.mark.parametrize("n_sources", [8, 5])  # exact and padded splits
    def test_matches_single_device(self, n_sources):
        from radiativetransfer_tpu.core import rays
        from radiativetransfer_tpu.parallel import rays_dist
        state, geom, ctx = self._setup(n_sources)
        rf_s, diag_s = rays.trace_point_sources(
            state, geom, ctx.sources, ctx.tables, max_pixel_level=3,
            dtype=jnp.float64)
        mesh = pmesh.make_grid_mesh(8)
        state_sh = pmesh.shard_state(state, mesh)
        rf_d, diag_d = rays_dist.trace_point_sources_dist(
            state_sh, geom, ctx.sources, ctx.tables, mesh,
            max_pixel_level=3, dtype=jnp.float64)
        n = geom.nx
        np.testing.assert_allclose(
            np.asarray(rf_d.krate24), np.asarray(rf_s.krate24).reshape(n, n, n),
            rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(
            np.asarray(rf_d.crate25), np.asarray(rf_s.crate25).reshape(n, n, n),
            rtol=1e-12, atol=1e-300)
        for f in ("ndot_remaining", "ndot_boundary", "ndot_spectrum"):
            np.testing.assert_allclose(np.asarray(getattr(diag_d, f)),
                                       np.asarray(getattr(diag_s, f)),
                                       rtol=1e-12)
        # deposits stay on the grid decomposition (no silent gather)
        assert len(rf_d.krate24.sharding.device_set) == 8

    def test_full_stellar_step_sharded(self):
        """make_step(stellar, mesh) on a sharded FieldState: mode-8
        transport+chemistry parity with the single-device step."""
        state, geom, ctx = self._setup(6)
        cfg = RunConfig(mode=8, current_redshift=6.55,
                        n_angular_level=1, reionization_model=10, grid="t")
        model = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        out_s, diag_s = model.make_step(ctx)(state)

        mesh = pmesh.make_grid_mesh(8)
        state_sh = pmesh.shard_state(state, mesh)
        out_d, diag_d = model.make_step(ctx, mesh=mesh)(state_sh)
        np.testing.assert_allclose(np.asarray(out_d.HI),
                                   np.asarray(out_s.HI), rtol=1e-11)
        np.testing.assert_allclose(np.asarray(out_d.krate24),
                                   np.asarray(out_s.krate24), rtol=1e-11,
                                   atol=1e-300)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-11)
        assert len(out_d.HI.sharding.device_set) == 8


@needs_devices
class TestMeshGeneralization:
    """2-D meshes and the cfg.sweep_strategy knob through the production
    step (VERDICT round-1 item 4)."""

    def _model_state(self, n=16):
        cfg = RunConfig(mode=MODE_UVB_TRANSFER_ONLY, current_redshift=6.55,
                        n_angular_level=1, reionization_model=10, grid="t")
        geom = GridGeometry(n, n, n, 300.0 * KPC)
        model = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        state = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64)
        return model, state

    def test_2d_mesh_full_step(self):
        model, state = self._model_state()
        out_single = jax.jit(model.transport_chemistry_step)(state)
        mesh = pmesh.make_grid_mesh(shape=(2, 4))
        assert mesh.axis_names == ("gy", "gz")
        state_sh = pmesh.shard_state(state, mesh)
        assert len(state_sh.HI.sharding.device_set) == 8
        out = jax.jit(model.transport_chemistry_step)(state_sh)
        np.testing.assert_allclose(np.asarray(out.HI),
                                   np.asarray(out_single.HI), rtol=1e-11)
        assert len(out.HI.sharding.device_set) == 8

    def test_2d_mesh_distributed_rays(self):
        from radiativetransfer_tpu.constants import MYR
        from radiativetransfer_tpu.core import rays
        from radiativetransfer_tpu.parallel import rays_dist
        from radiativetransfer_tpu.tables import stellar as stellar_tables
        n = 16
        geom = GridGeometry(n, n, n, 50.0 * KPC)
        state = uniform_state(n, nh=1e-3, tgas=1e4, dtype=jnp.float64)
        rng = np.random.default_rng(5)
        batch = rays.SourceBatch(
            position=rng.uniform(0.2, 0.8, (9, 3)),
            weight=np.ones(9), table_idx=np.zeros(9, np.int32))
        ctx = step_mod.StellarContext.build(
            stellar_tables.blackbody_population(), batch, geom,
            10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3)
        rf_s, diag_s = rays.trace_point_sources(
            state, geom, ctx.sources, ctx.tables, max_pixel_level=3,
            dtype=jnp.float64)
        mesh = pmesh.make_grid_mesh(shape=(2, 4))
        rf_d, diag_d = rays_dist.trace_point_sources_dist(
            pmesh.shard_state(state, mesh), geom, ctx.sources, ctx.tables,
            mesh, max_pixel_level=3, dtype=jnp.float64)
        # rtol reflects cross-shard reduction-order roundoff (the 8-way
        # psum_scatter tree differs from the serial accumulation order)
        np.testing.assert_allclose(
            np.asarray(rf_d.krate24),
            np.asarray(rf_s.krate24).reshape(n, n, n), rtol=1e-10,
            atol=1e-300)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-12)

    @pytest.mark.parametrize("strategy", ["pipelined", "zones"])
    def test_strategy_through_production_step(self, strategy):
        import dataclasses as dc
        model, state = self._model_state()
        out_single = jax.jit(model.transport_chemistry_step)(state)
        mesh = pmesh.make_grid_mesh(8)
        model_s = dc.replace(model, config=dc.replace(
            model.config, sweep_strategy=strategy))
        out = model_s.make_step(mesh=mesh)(pmesh.shard_state(state, mesh))
        np.testing.assert_allclose(np.asarray(out.HI),
                                   np.asarray(out_single.HI), rtol=1e-11)

    def test_pipelined_on_2d_mesh(self):
        """Pipelined halo-line sweep on a (2, 4) mesh: both in-plane axes
        sharded, scan axis local; per-slab halo lines cross BOTH mesh axes
        (VERDICT r2 missing-6)."""
        import dataclasses as dc
        model, state = self._model_state()
        out_single = jax.jit(model.transport_chemistry_step)(state)
        mesh = pmesh.make_grid_mesh(shape=(2, 4))
        model_s = dc.replace(model, config=dc.replace(
            model.config, sweep_strategy="pipelined"))
        out = model_s.make_step(mesh=mesh)(pmesh.shard_state(state, mesh))
        np.testing.assert_allclose(np.asarray(out.HI),
                                   np.asarray(out_single.HI), rtol=1e-11)

    def test_full_step_on_3d_mesh(self):
        """GSPMD full step on a (2, 2, 2) 3-D mesh (all grid axes
        decomposed) matches single-device (VERDICT r2 missing-6)."""
        model, state = self._model_state()
        out_single = jax.jit(model.transport_chemistry_step)(state)
        mesh = pmesh.make_grid_mesh(shape=(2, 2, 2))
        out = jax.jit(model.transport_chemistry_step)(
            pmesh.shard_state(state, mesh))
        np.testing.assert_allclose(np.asarray(out.HI),
                                   np.asarray(out_single.HI), rtol=1e-11)
        assert len(out.HI.sharding.device_set) == 8

    def test_strategy_requires_mesh(self):
        import dataclasses as dc
        model, state = self._model_state(8)
        model_s = dc.replace(model, config=dc.replace(
            model.config, sweep_strategy="pipelined"))
        with pytest.raises(ValueError, match="needs a mesh"):
            model_s.make_step()(state)


@needs_devices
class TestDomainDecomposedRays:
    """Domain-decomposed tracer (VERDICT r2 missing-2): fields stay
    sharded, rays migrate via per-step ppermute; parity vs the
    single-device tracer, and per-device field memory = the shard."""

    def _setup(self, n=16, mpl=4):
        from radiativetransfer_tpu.constants import MYR
        from radiativetransfer_tpu.core import rays
        from radiativetransfer_tpu.tables import stellar as stellar_tables
        cfg = RunConfig(mode=8, current_redshift=6.55, n_angular_level=1,
                        reionization_model=10, grid="dom")
        geom = GridGeometry(n, n, n, 100.0 * KPC)
        rt = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        state = rt.initialize_equilibrium(
            uniform_state(n, nh=1e-4, tgas=2e4, dtype=jnp.float64))
        rng = np.random.default_rng(3)
        batch = rays.SourceBatch(position=rng.uniform(0.2, 0.8, (5, 3)),
                                 weight=np.ones(5),
                                 table_idx=np.zeros(5, np.int32))
        ctx = step_mod.StellarContext.build(
            stellar_tables.blackbody_population(), batch, geom, 10.0 * MYR,
            metal_coefs=[(0, 0.0)], max_pixel_level=mpl)
        return rt, geom, state, ctx

    def test_matches_single_device(self):
        from radiativetransfer_tpu.core import rays
        from radiativetransfer_tpu.parallel import rays_domain
        rt, geom, state, ctx = self._setup()
        rf_s, diag_s = rays.trace_point_sources(
            state, geom, ctx.sources, ctx.tables, max_pixel_level=4,
            dtype=jnp.float64, rates_mode="quadrature")
        mesh = pmesh.make_grid_mesh(8)
        rf_d, diag_d = rays_domain.trace_point_sources_domain(
            pmesh.shard_state(state, mesh), geom, ctx.sources, ctx.tables,
            mesh, max_pixel_level=4, dtype=jnp.float64)
        n = geom.nx
        np.testing.assert_allclose(
            np.asarray(rf_d.krate24),
            np.asarray(rf_s.krate24).reshape(n, n, n), rtol=1e-12,
            atol=1e-300)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_spectrum),
                                   np.asarray(diag_s.ndot_spectrum),
                                   rtol=1e-12)
        # the deposits carry the sharded-fields decomposition
        assert len(rf_d.krate24.sharding.device_set) == 8

    def test_through_production_step(self):
        import dataclasses as dc
        rt, geom, state, ctx = self._setup()
        out_ref, diag_ref = rt.make_step(ctx)(state)
        mesh = pmesh.make_grid_mesh(8)
        rt_d = dc.replace(rt, config=dc.replace(rt.config,
                                                tracer_strategy="domain"))
        out_d, diag_d = rt_d.make_step(ctx, mesh=mesh)(
            pmesh.shard_state(state, mesh))
        np.testing.assert_allclose(np.asarray(out_d.HI),
                                   np.asarray(out_ref.HI), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_ref.ndot_remaining),
                                   rtol=1e-12)

    @pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
    def test_matches_single_device_2d_mesh(self, shape):
        """2-D mesh (VERDICT r3 item 5): rays migrate along BOTH sharded
        grid axes; fields and deposits keep the 2-D decomposition."""
        from radiativetransfer_tpu.core import rays
        from radiativetransfer_tpu.parallel import rays_domain
        rt, geom, state, ctx = self._setup()
        rf_s, diag_s = rays.trace_point_sources(
            state, geom, ctx.sources, ctx.tables, max_pixel_level=4,
            dtype=jnp.float64, rates_mode="quadrature")
        mesh = pmesh.make_grid_mesh(shape=shape)
        rf_d, diag_d = rays_domain.trace_point_sources_domain(
            pmesh.shard_state(state, mesh), geom, ctx.sources, ctx.tables,
            mesh, max_pixel_level=4, dtype=jnp.float64)
        n = geom.nx
        np.testing.assert_allclose(
            np.asarray(rf_d.krate24),
            np.asarray(rf_s.krate24).reshape(n, n, n), rtol=1e-12,
            atol=1e-300)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_spectrum),
                                   np.asarray(diag_s.ndot_spectrum),
                                   rtol=1e-12)
        assert len(rf_d.krate24.sharding.device_set) == 8


@needs_devices
class TestShardedAMR:
    """Sharded two-level AMR step (VERDICT round-1 item 8): the AMR sweep,
    tracer, and chemistry on the 8-device mesh must match single-device."""

    def _amr_setup(self, n=16, with_sources=False):
        from radiativetransfer_tpu.constants import MYR
        from radiativetransfer_tpu.core import amr, rays, step_amr
        from radiativetransfer_tpu.tables import stellar as stellar_tables
        cfg = RunConfig(mode=8 if with_sources else MODE_UVB_TRANSFER_ONLY,
                        current_redshift=6.55, n_angular_level=1,
                        reionization_model=10, grid="amr")
        geom = GridGeometry(n, n, n, 300.0 * KPC)
        rt = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        am = step_amr.AMRModel.setup(rt)
        base = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64)
        refined = np.zeros((n, n, n), bool)
        refined[5:9, 6:10, 4:8] = True
        st = amr.make_amr_state(base, jnp.asarray(refined))
        ctx = None
        if with_sources:
            rng = np.random.default_rng(3)
            batch = rays.SourceBatch(
                position=rng.uniform(0.2, 0.8, (5, 3)),
                weight=rng.integers(1, 4, 5).astype(np.float64),
                table_idx=np.zeros(5, np.int32))
            ctx = step_mod.StellarContext.build(
                stellar_tables.blackbody_population(), batch, geom,
                10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3)
        return am, st, ctx

    def test_sharded_amr_step_matches_single_device(self):
        am, st, _ = self._amr_setup()
        out_s = am.make_step()(st)
        mesh = pmesh.make_grid_mesh(8)
        st_sh = pmesh.shard_amr_state(st, mesh)
        out_d = am.make_step()(st_sh)
        np.testing.assert_allclose(np.asarray(out_d.base.HI),
                                   np.asarray(out_s.base.HI), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(out_d.fine.HI),
                                   np.asarray(out_s.fine.HI), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(out_d.fine.Jmean),
                                   np.asarray(out_s.fine.Jmean), rtol=1e-12)
        assert len(out_d.base.HI.sharding.device_set) == 8

    def test_distributed_amr_tracer_matches_single_device(self):
        from radiativetransfer_tpu.core import rays_amr
        from radiativetransfer_tpu.parallel import rays_dist
        am, st, ctx = self._amr_setup(with_sources=True)
        geom = am.rt.geom
        rfb_s, rff_s, diag_s = rays_amr.trace_point_sources_amr(
            st, geom, ctx.sources, ctx.tables, max_pixel_level=3,
            dtype=jnp.float64)
        mesh = pmesh.make_grid_mesh(8)
        st_sh = pmesh.shard_amr_state(st, mesh)
        rfb_d, rff_d, diag_d = rays_dist.trace_point_sources_amr_dist(
            st_sh, geom, ctx.sources, ctx.tables, mesh,
            max_pixel_level=3, dtype=jnp.float64)
        n = geom.nx
        np.testing.assert_allclose(
            np.asarray(rfb_d.krate24),
            np.asarray(rfb_s.krate24).reshape(n, n, n),
            rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(
            np.asarray(rff_d.krate24),
            np.asarray(rff_s.krate24).reshape(2 * n, 2 * n, 2 * n),
            rtol=1e-12, atol=1e-300)
        for f in ("ndot_remaining", "ndot_boundary", "ndot_spectrum"):
            np.testing.assert_allclose(np.asarray(getattr(diag_d, f)),
                                       np.asarray(getattr(diag_s, f)),
                                       rtol=1e-12)
        assert len(rfb_d.krate24.sharding.device_set) == 8

    def test_full_amr_stellar_step_sharded(self):
        """mode-8 (stellar + UVB) AMR step through make_step(stellar, mesh)
        on a sharded AMRState."""
        am, st, ctx = self._amr_setup(with_sources=True)
        out_s, diag_s = am.make_step(ctx)(st)
        mesh = pmesh.make_grid_mesh(8)
        st_sh = pmesh.shard_amr_state(st, mesh)
        out_d, diag_d = am.make_step(ctx, mesh=mesh)(st_sh)
        np.testing.assert_allclose(np.asarray(out_d.base.HI),
                                   np.asarray(out_s.base.HI), rtol=1e-11)
        np.testing.assert_allclose(np.asarray(out_d.fine.HI),
                                   np.asarray(out_s.fine.HI), rtol=1e-11)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-12)


@needs_devices
class TestShardedMultiLevel:
    """Sharded L-level AMR step: the multilevel sweep, source-parallel
    tracer, and per-level chemistry on the 8-device mesh must match the
    single-device MultiLevelModel."""

    def _ml_setup(self, n=8, n_levels=3, with_sources=False):
        from radiativetransfer_tpu.constants import MYR
        from radiativetransfer_tpu.core import amr, rays, step_amr
        from radiativetransfer_tpu.tables import stellar as stellar_tables
        cfg = RunConfig(mode=8 if with_sources else MODE_UVB_TRANSFER_ONLY,
                        current_redshift=6.55, n_angular_level=1,
                        reionization_model=10, grid="ml")
        geom = GridGeometry(n, n, n, 300.0 * KPC)
        rt = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        ml = step_amr.MultiLevelModel.setup(rt, n_levels)
        base = uniform_state(n, nh=2e-3, tgas=1e4, dtype=jnp.float64)
        refined = [np.zeros((n, n, n), bool),
                   np.zeros((2 * n,) * 3, bool)][:n_levels - 1]
        refined[0][2:6, 3:7, 2:6] = True
        if n_levels > 2:
            refined[1][6:10, 7:11, 6:10] = True
        refined = amr.enforce_balance(refined)
        st = amr.make_multilevel_state(base, refined)
        ctx = None
        if with_sources:
            rng = np.random.default_rng(7)
            batch = rays.SourceBatch(
                position=rng.uniform(0.2, 0.8, (5, 3)),
                weight=rng.integers(1, 4, 5).astype(np.float64),
                table_idx=np.zeros(5, np.int32))
            ctx = step_mod.StellarContext.build(
                stellar_tables.blackbody_population(), batch, geom,
                10.0 * MYR, metal_coefs=[(0, 0.0)], max_pixel_level=3)
        return ml, st, ctx

    def test_sharded_ml_step_matches_single_device(self):
        ml, st, _ = self._ml_setup()
        out_s = ml.make_step()(st)
        mesh = pmesh.make_grid_mesh(8)
        st_sh = pmesh.shard_multilevel_state(st, mesh)
        out_d = ml.make_step(mesh=mesh)(st_sh)
        for ell in range(3):
            np.testing.assert_allclose(
                np.asarray(out_d.levels[ell].HI),
                np.asarray(out_s.levels[ell].HI), rtol=1e-12)
        np.testing.assert_allclose(np.asarray(out_d.levels[2].Jmean),
                                   np.asarray(out_s.levels[2].Jmean),
                                   rtol=1e-12)
        assert len(out_d.levels[0].HI.sharding.device_set) == 8

    def test_distributed_ml_tracer_matches_single_device(self):
        from radiativetransfer_tpu.core import rays_multilevel
        from radiativetransfer_tpu.parallel import rays_dist
        ml, st, ctx = self._ml_setup(with_sources=True)
        geom = ml.rt.geom
        rfs_s, diag_s = rays_multilevel.trace_point_sources_ml(
            st, geom, ctx.sources, ctx.tables, max_pixel_level=3,
            dtype=jnp.float64)
        mesh = pmesh.make_grid_mesh(8)
        st_sh = pmesh.shard_multilevel_state(st, mesh)
        rfs_d, diag_d = rays_dist.trace_point_sources_ml_dist(
            st_sh, geom, ctx.sources, ctx.tables, mesh,
            max_pixel_level=3, dtype=jnp.float64)
        for ell, (rf_d, rf_s) in enumerate(zip(rfs_d, rfs_s)):
            m = geom.nx * 2 ** ell
            np.testing.assert_allclose(
                np.asarray(rf_d.krate24),
                np.asarray(rf_s.krate24).reshape(m, m, m),
                rtol=1e-12, atol=1e-300)
        for f in ("ndot_remaining", "ndot_boundary", "ndot_spectrum"):
            np.testing.assert_allclose(np.asarray(getattr(diag_d, f)),
                                       np.asarray(getattr(diag_s, f)),
                                       rtol=1e-12)
        assert len(rfs_d[0].krate24.sharding.device_set) == 8

    def test_full_ml_stellar_step_sharded(self):
        """mode-8 (stellar + UVB) L=3 step through make_step(stellar, mesh)
        on a sharded MultiLevelState."""
        ml, st, ctx = self._ml_setup(with_sources=True)
        out_s, diag_s = ml.make_step(ctx)(st)
        mesh = pmesh.make_grid_mesh(8)
        st_sh = pmesh.shard_multilevel_state(st, mesh)
        out_d, diag_d = ml.make_step(ctx, mesh=mesh)(st_sh)
        for ell in range(3):
            np.testing.assert_allclose(
                np.asarray(out_d.levels[ell].HI),
                np.asarray(out_s.levels[ell].HI), rtol=1e-11)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-12)


@needs_devices
class TestDomainDecomposedRaysAMR:
    """Two-level AMR domain tracer (VERDICT r3 item 5): base+fine fields
    stay sharded, rays migrate across shards AND levels; parity vs the
    single-device AMR tracer."""

    def _setup(self, n=16, mpl=4):
        from radiativetransfer_tpu.constants import MYR
        from radiativetransfer_tpu.core import amr, rays
        from radiativetransfer_tpu.tables import stellar as stellar_tables
        cfg = RunConfig(mode=8, current_redshift=6.55, n_angular_level=1,
                        reionization_model=10, grid="domamr")
        geom = GridGeometry(n, n, n, 100.0 * KPC)
        rt = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        base = rt.initialize_equilibrium(
            uniform_state(n, nh=1e-4, tgas=2e4, dtype=jnp.float64))
        refined = np.zeros((n, n, n), bool)
        refined[5:11, 5:11, 5:11] = True
        st = amr.make_amr_state(base, jnp.asarray(refined))
        # perturb the fine level so level selection matters
        import dataclasses as dc
        st = dc.replace(st, fine=dc.replace(
            st.fine, HI=st.fine.HI * 1.3))
        st = amr.sync_restriction(st)
        rng = np.random.default_rng(5)
        batch = rays.SourceBatch(position=rng.uniform(0.3, 0.7, (4, 3)),
                                 weight=np.ones(4),
                                 table_idx=np.zeros(4, np.int32))
        ctx = step_mod.StellarContext.build(
            stellar_tables.blackbody_population(), batch, geom, 10.0 * MYR,
            metal_coefs=[(0, 0.0)], max_pixel_level=mpl)
        return rt, geom, st, ctx

    @pytest.mark.parametrize("shape", [None, (2, 4)])
    def test_matches_single_device(self, shape):
        from radiativetransfer_tpu.core import rays_amr
        from radiativetransfer_tpu.parallel import rays_domain
        rt, geom, st, ctx = self._setup()
        rfb_s, rff_s, diag_s = rays_amr.trace_point_sources_amr(
            st, geom, ctx.sources, ctx.tables, max_pixel_level=4,
            dtype=jnp.float64, rates_mode="quadrature")
        mesh = (pmesh.make_grid_mesh(8) if shape is None
                else pmesh.make_grid_mesh(shape=shape))
        st_sh = pmesh.shard_amr_state(st, mesh)
        rfb_d, rff_d, diag_d = rays_domain.trace_point_sources_domain_amr(
            st_sh, geom, ctx.sources, ctx.tables, mesh,
            max_pixel_level=4, dtype=jnp.float64)
        n = geom.nx
        np.testing.assert_allclose(
            np.asarray(rfb_d.krate24),
            np.asarray(rfb_s.krate24).reshape(n, n, n), rtol=1e-12,
            atol=1e-300)
        np.testing.assert_allclose(
            np.asarray(rff_d.krate24),
            np.asarray(rff_s.krate24).reshape(2 * n, 2 * n, 2 * n),
            rtol=1e-12, atol=1e-300)
        assert float(np.abs(np.asarray(rff_s.krate24)).max()) > 0.0
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_spectrum),
                                   np.asarray(diag_s.ndot_spectrum),
                                   rtol=1e-12)
        assert len(rfb_d.krate24.sharding.device_set) == 8

    def test_through_amr_production_step(self):
        import dataclasses as dc
        from radiativetransfer_tpu.core import step_amr
        rt, geom, st, ctx = self._setup()
        am = step_amr.AMRModel.setup(rt)
        out_ref, diag_ref = am.make_step(ctx)(st)
        mesh = pmesh.make_grid_mesh(8)
        rt_d = dc.replace(rt, config=dc.replace(rt.config,
                                                tracer_strategy="domain"))
        am_d = step_amr.AMRModel.setup(rt_d)
        out_d, diag_d = am_d.make_step(ctx, mesh=mesh)(
            pmesh.shard_amr_state(st, mesh))
        np.testing.assert_allclose(np.asarray(out_d.base.HI),
                                   np.asarray(out_ref.base.HI), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(out_d.fine.HI),
                                   np.asarray(out_ref.fine.HI), rtol=1e-10)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_ref.ndot_remaining),
                                   rtol=1e-12)


@needs_devices
class TestDomainDecomposedRaysML:
    """Deep-grid (L-level) domain tracer (VERDICT r4 weak-7/item 10):
    every level's fields stay sharded, rays migrate across shards and
    levels; parity vs the single-device multilevel tracer."""

    def _setup(self, n=16, L=3, mpl=4):
        from radiativetransfer_tpu.constants import MYR
        from radiativetransfer_tpu.core import amr, rays
        from radiativetransfer_tpu.tables import stellar as stellar_tables
        cfg = RunConfig(mode=8, current_redshift=6.55, n_angular_level=1,
                        reionization_model=10, grid="domml")
        geom = GridGeometry(n, n, n, 100.0 * KPC)
        rt = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float64)
        rng = np.random.default_rng(7)
        refined = []
        m = n
        for _ in range(L - 1):
            r = np.zeros((m,) * 3, bool)
            c = m // 2
            r[c - 3:c + 3, c - 3:c + 3, c - 3:c + 3] = (
                rng.random((6, 6, 6)) < 0.6)
            refined.append(r)
            m *= 2
        refined = amr.enforce_balance(refined)
        cov = np.ones((n,) * 3, bool)
        for l in range(L - 1):
            refined[l] &= cov
            cov = np.repeat(np.repeat(np.repeat(refined[l], 2, 0), 2, 1),
                            2, 2)
        levels = [rt.initialize_equilibrium(
            uniform_state(n * 2 ** l, nh=1e-4 * 1.3 ** l, tgas=2e4,
                          dtype=jnp.float64)) for l in range(L)]
        st = amr.sync_restriction_multi(
            amr.make_multilevel_state(levels[0], refined, levels[1:]))
        batch = rays.SourceBatch(position=rng.uniform(0.35, 0.65, (4, 3)),
                                 weight=np.ones(4),
                                 table_idx=np.zeros(4, np.int32))
        ctx = step_mod.StellarContext.build(
            stellar_tables.blackbody_population(), batch, geom, 10.0 * MYR,
            metal_coefs=[(0, 0.0)], max_pixel_level=mpl)
        return rt, geom, st, ctx

    @pytest.mark.parametrize("shape", [None, (2, 4)])
    def test_matches_single_device(self, shape):
        from radiativetransfer_tpu.core import rays_multilevel
        from radiativetransfer_tpu.parallel import rays_domain
        rt, geom, st, ctx = self._setup()
        L = st.n_levels
        rfs_s, diag_s = rays_multilevel.trace_point_sources_ml(
            st, geom, ctx.sources, ctx.tables, max_pixel_level=4,
            dtype=jnp.float64, rates_mode="quadrature")
        mesh = (pmesh.make_grid_mesh(8) if shape is None
                else pmesh.make_grid_mesh(shape=shape))
        st_sh = pmesh.shard_multilevel_state(st, mesh)
        rfs_d, diag_d = rays_domain.trace_point_sources_domain_ml(
            st_sh, geom, ctx.sources, ctx.tables, mesh,
            max_pixel_level=4, dtype=jnp.float64)
        n = geom.nx
        for ell in range(L):
            m = n * 2 ** ell
            np.testing.assert_allclose(
                np.asarray(rfs_d[ell].krate24),
                np.asarray(rfs_s[ell].krate24).reshape(m, m, m),
                rtol=1e-12, atol=1e-300, err_msg=f"level {ell}")
            np.testing.assert_allclose(
                np.asarray(rfs_d[ell].crate26),
                np.asarray(rfs_s[ell].crate26).reshape(m, m, m),
                rtol=1e-12, atol=1e-300, err_msg=f"level {ell}")
        assert float(np.abs(np.asarray(rfs_s[L - 1].krate24)).max()) > 0.0
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_s.ndot_remaining),
                                   rtol=1e-12)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_spectrum),
                                   np.asarray(diag_s.ndot_spectrum),
                                   rtol=1e-12)
        assert len(rfs_d[0].krate24.sharding.device_set) == 8

    def test_through_ml_production_step(self):
        import dataclasses as dc

        from radiativetransfer_tpu.core import step_amr
        rt, geom, st, ctx = self._setup()
        ml = step_amr.MultiLevelModel.setup(rt, st.n_levels)
        out_ref, diag_ref = ml.make_step(ctx)(st)
        mesh = pmesh.make_grid_mesh(8)
        rt_d = dc.replace(
            rt, config=dc.replace(rt.config, tracer_strategy="domain"))
        ml_d = step_amr.MultiLevelModel.setup(rt_d, st.n_levels)
        ml_d.n_coupling_iters = ml.n_coupling_iters
        st_sh = pmesh.shard_multilevel_state(st, mesh)
        out_d, diag_d = ml_d.make_step(ctx, mesh=mesh)(st_sh)
        np.testing.assert_allclose(np.asarray(out_d.levels[0].HI),
                                   np.asarray(out_ref.levels[0].HI),
                                   rtol=1e-10)
        np.testing.assert_allclose(np.asarray(diag_d.ndot_remaining),
                                   np.asarray(diag_ref.ndot_remaining),
                                   rtol=1e-10)
