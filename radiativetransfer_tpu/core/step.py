"""The main iteration: transport + chemistry cycle, and the model setup.

Mirrors the reference's driver flow (/root/reference/equiSources.f90:1230-1843):
  zero rates -> [point-source ray trace] -> [opacities + diffuse sweep] ->
  save previous fields -> equilibrium chemistry -> neutral-fraction log ->
  snapshot.

`RTModel.setup()` performs the table initialization the reference does before
the loop (calc_rates, uniformTable, UVB amplitudes, powerSpectrumIndex,
uvbBetaTable; equiSources.f90:172-289) and compiles the fused device step.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RunConfig
from ..constants import (
    ALPHA_QUASAR,
    ALPHA_STELLAR,
    COMPA,
    FOUR_PI,
    FREQUENCY_BIN_WIDTH,
    MH,
    NFBINS,
    NU1,
    NU2,
    NU3,
    PSI,
)
from ..tables import chemistry_rates, spectral, stellar as stellar_tables, uvb_models
from . import chemistry, opacity, rays, sweep
from .rays import _HIGHEST
from .state import FieldState, GridGeometry


@dataclasses.dataclass
class StellarContext:
    """Point-source transfer inputs for one iteration.

    The reference rebuilds the 11^4 attenuation tables per source
    (equiSources.f90:1298); here sources sharing an (age, metallicity)
    bucket share a table (SURVEY.md §3.3) and the tables are stacked on a
    leading bucket axis for per-ray gathering.
    """
    population: "stellar_tables.StellarPopulation"
    sources: rays.SourceBatch
    tables: dict                 # reaction_log/energy_log (B,3,11^4) + output_*
    n_stars_specific_age: int
    dust_approximation: int = 0
    max_pixel_level: int = 6

    @classmethod
    def build(cls, population, sources: rays.SourceBatch, geom: GridGeometry,
              age_s: float, metal_coefs: list[tuple[int, float]],
              n_stars_specific_age: int | None = None,
              dust_approximation: int = 0, max_pixel_level: int = 6,
              dust=None, noneq: bool = False) -> "StellarContext":
        """Build stacked tables for the metallicity buckets at a fixed age
        slice (the reference uses timeReadTable = 10 Myr,
        equiSources.f90:1236).

        The tables are divided by the cell volume (in float64, on host) so
        the ray deposits are volumetric rates [1/s/cm^3]: CGS cell volumes
        overflow float32 on device (see chemistry.photo_rates_from_sources).
        """
        i_spec, coef_spec = population.age_bracket(age_s)
        log_vol = float(np.log(geom.cell_volume))
        reaction, energy, quad_w, quad_w27 = [], [], [], []
        out = quad_a = None
        for i_metal, coef_metal in metal_coefs:
            t = stellar_tables.build_source_tables(
                population, i_spec, coef_spec, i_metal, coef_metal, dust=dust)
            reaction.append(t.reaction_log - log_vol)
            energy.append(t.energy_log - log_vol)
            out = t
            quad_a, w = stellar_tables.quadrature_arrays(
                population, i_spec, coef_spec, i_metal, coef_metal, dust=dust)
            quad_w.append(w / geom.cell_volume)
            if noneq:
                w27 = stellar_tables.quadrature_noneq_weights(
                    population, i_spec, coef_spec, i_metal, coef_metal,
                    dust=dust)
                quad_w27.append(w27 / geom.cell_volume)
        tables = {
            "reaction_log": jnp.asarray(np.stack(reaction)),
            "energy_log": jnp.asarray(np.stack(energy)),
            # direct-quadrature factors: the tracer's default fast path
            # (core.rays._deposit_quadrature)
            "quad_A": jnp.asarray(quad_a),
            "quad_W": jnp.asarray(np.stack(quad_w)),
            "output_freq": jnp.asarray(out.output_freq),
            "output_sigma24": jnp.asarray(out.output_sigma24),
            "output_sigma25": jnp.asarray(out.output_sigma25),
            "output_sigma26": jnp.asarray(out.output_sigma26),
            "output_sigma_dust": jnp.asarray(out.output_sigma_dust),
        }
        if noneq:
            tables["quad_W27"] = jnp.asarray(np.stack(quad_w27))
        return cls(population=population, sources=sources, tables=tables,
                   n_stars_specific_age=(n_stars_specific_age
                                         or int(sources.weight.sum())),
                   dust_approximation=dust_approximation,
                   max_pixel_level=max_pixel_level)


@dataclasses.dataclass
class RTModel:
    """All static data for a run: tables, geometry, compiled step."""
    config: RunConfig
    geom: GridGeometry
    tables: chemistry_rates.ChemistryTables
    dev_tables: chemistry.RateTablesDevice
    quasar: spectral.NormCrossSections
    stellar: spectral.NormCrossSections
    groups: tuple | None            # (g1, g2, g3) when UVB transfer is on
    opacity_coef: opacity.GroupOpacityCoefficients | None
    ksi_matrix: jax.Array | None    # (3 bands, 3 species) for diffuse rates
    uvb: np.ndarray                 # (3,) band boundary intensities
    uniform_quasar: float
    uniform_stellar: float
    sweep_plan: sweep.SweepPlan | None
    alpha_bands: tuple[float, float, float] | None
    # (3 bands, 8 channels 24..31) group ksi matrix and (3 bands, 3 species
    # [HI, HeII, HeI]) group heating matrix for the non-equilibrium mode
    ksi_all: jax.Array | None = None
    gamma_matrix: jax.Array | None = None

    # ----- setup ---------------------------------------------------------

    @classmethod
    def setup(cls, config: RunConfig, geom: GridGeometry,
              recombination_type: int | None = None,
              dtype=jnp.float32) -> "RTModel":
        from ..constants import CASE_B
        rt = CASE_B if recombination_type is None else recombination_type
        tables = chemistry_rates.calc_rates(recombination_type=rt)
        dev_tables = chemistry.RateTablesDevice.from_tables(tables, dtype)
        quasar, stellar = spectral.uniform_table(
            NFBINS, FREQUENCY_BIN_WIDTH, ALPHA_QUASAR, ALPHA_STELLAR)

        z = config.current_redshift
        amps = uvb_models.uniform_uvb_intensities(z, config.uvb_coefficient)
        uniform_quasar, uniform_stellar = amps.quasar, amps.stellar

        groups = None
        opacity_coef = None
        ksi_matrix = None
        ksi_all = None
        gamma_matrix = None
        alpha_bands = None
        uvb = np.zeros(3)
        if config.run_uvb_transfer:
            s_bands, q_bands = uvb_models.band_intensities(
                amps, ALPHA_STELLAR, ALPHA_QUASAR)
            uvb1, a1 = spectral.power_spectrum_index(
                s_bands[0], ALPHA_STELLAR, q_bands[0], ALPHA_QUASAR, NU1, NU2, True)
            uvb2, a2 = spectral.power_spectrum_index(
                s_bands[1], ALPHA_STELLAR, q_bands[1], ALPHA_QUASAR, NU2, NU3, True)
            uvb3, a3 = spectral.power_spectrum_index(
                s_bands[2], ALPHA_STELLAR, q_bands[2], ALPHA_QUASAR, NU3, NU3, False)
            uvb = np.array([uvb1, uvb2, uvb3])
            alpha_bands = (a1, a2, a3)
            g1, g2, g3 = spectral.uvb_beta_table(NFBINS, FREQUENCY_BIN_WIDTH,
                                                 alpha_bands)
            groups = (g1, g2, g3)
            opacity_coef = opacity.GroupOpacityCoefficients.from_groups(g1, g2, g3)
            # rows: bands; cols: (HI ksi24, HeII ksi25, HeI ksi26)
            ksi_matrix = jnp.asarray(np.array([
                [g1.ksi[24], g1.ksi[25], g1.ksi[26]],
                [g2.ksi[24], g2.ksi[25], g2.ksi[26]],
                [g3.ksi[24], g3.ksi[25], g3.ksi[26]],
            ]), dtype)
            # all 8 photo channels per band, for the non-equilibrium network
            ksi_all = jnp.asarray(np.array(
                [[g.ksi[c] for c in range(24, 32)] for g in (g1, g2, g3)]),
                dtype)
            gamma_matrix = jnp.asarray(np.array(
                [[g.gammaHI, g.gammaHeII, g.gammaHeI] for g in (g1, g2, g3)]),
                dtype)

        # reionization-history renormalization (equiSources.f90:259-289)
        if config.reionization_model:
            coef = uvb_models.reionization_rate_coefficient(
                z, config.reionization_model, uniform_quasar, uniform_stellar,
                quasar.ksi[24], stellar.ksi[24])
            uniform_quasar *= coef
            uniform_stellar *= coef
            uvb = uvb * coef

        sweep_plan = None
        if config.run_uvb_transfer:
            sweep_plan = sweep.build_sweep_plan(config.n_angular_level, geom.nx)

        return cls(config=config, geom=geom, tables=tables,
                   dev_tables=dev_tables, quasar=quasar, stellar=stellar,
                   groups=groups, opacity_coef=opacity_coef,
                   ksi_matrix=ksi_matrix, uvb=uvb,
                   uniform_quasar=uniform_quasar,
                   uniform_stellar=uniform_stellar, sweep_plan=sweep_plan,
                   alpha_bands=alpha_bands, ksi_all=ksi_all,
                   gamma_matrix=gamma_matrix)

    # ----- derived coefficients -----------------------------------------

    @property
    def gamma_thin(self) -> tuple[float, float, float]:
        """Optically-thin uniform-UVB photoionization rates [1/s]
        (equiSources.f90:3558-3560): (HI, HeII, HeI)."""
        q, s = self.quasar, self.stellar
        return (
            FOUR_PI * (self.uniform_quasar * q.ksi[24] + self.uniform_stellar * s.ksi[24]),
            FOUR_PI * (self.uniform_quasar * q.ksi[25] + self.uniform_stellar * s.ksi[25]),
            FOUR_PI * (self.uniform_quasar * q.ksi[26] + self.uniform_stellar * s.ksi[26]),
        )

    @property
    def heat_thin(self) -> tuple[float, float, float]:
        """Optically-thin photo-heating coefficients [erg cm^2/s?]
        (thermalEquilibrium, equiSources.f90:3931-3933): (HI, HeII, HeI)."""
        q, s = self.quasar, self.stellar
        return (
            FOUR_PI * (self.uniform_quasar * q.gammaHI + self.uniform_stellar * s.gammaHI),
            FOUR_PI * (self.uniform_quasar * q.gammaHeII + self.uniform_stellar * s.gammaHeII),
            FOUR_PI * (self.uniform_quasar * q.gammaHeI + self.uniform_stellar * s.gammaHeI),
        )

    @property
    def photo_thin_all(self) -> np.ndarray:
        """Optically-thin uniform-UVB rates [1/s] for all 8 photo channels
        k24..k31 (the reference integrates its uniform ksi above nu1 only,
        uniformTable.f90:137-192 — followed here)."""
        q, s = self.quasar, self.stellar
        return np.array([
            FOUR_PI * (self.uniform_quasar * q.ksi[c]
                       + self.uniform_stellar * s.ksi[c])
            for c in range(24, 32)])

    # ----- setup-time equilibrium ----------------------------------------

    def initialize_equilibrium(self, state: FieldState) -> FieldState:
        """Initial ionization equilibrium under the uniform UVB, run twice
        because the self-shielding surface moves after the first pass
        (equiSources.f90:1012-1021), followed by the thermal-balance
        diagnostic (:1026-1033)."""
        init = jax.jit(lambda s: chemistry.solve_rate_equations(
            s.zero_rates(), self.geom, self.dev_tables,
            gamma_thin=self.gamma_thin,
            self_shielding_threshold=self.config.self_shielding_threshold,
            run_uvb_transfer=False,
            n_iter=110 if s.rho.dtype == jnp.float64 else 60))
        state = init(state)
        state = init(state)
        return chemistry.thermal_equilibrium(
            state, heat_thin=self.heat_thin,
            self_shielding_threshold=self.config.self_shielding_threshold,
            current_redshift=self.config.current_redshift,
            tables=self.dev_tables, compa=COMPA)

    # ----- the iteration -------------------------------------------------

    def transport_chemistry_step(self, state: FieldState,
                                 stellar: StellarContext | None = None,
                                 mesh=None
                                 ) -> FieldState | tuple[FieldState, "rays.RayDiagnostics"]:
        """One full transport + chemistry iteration (pure function of state;
        jit this or use make_step()).  With a StellarContext the point-source
        phase runs first and RayDiagnostics are returned alongside the
        state."""
        cfg = self.config
        state = state.zero_rates()
        diag = None

        if cfg.run_stellar_transfer and stellar is not None:
            n = self.geom.nx
            rf, diag = rays.trace_point_sources(
                state, self.geom, stellar.sources, stellar.tables,
                dust_approximation=stellar.dust_approximation,
                max_pixel_level=stellar.max_pixel_level,
                dtype=state.rho.dtype)
            shape = state.shape
            state = dataclasses.replace(
                state,
                krate24=rf.krate24.reshape(shape),
                krate25=rf.krate25.reshape(shape),
                krate26=rf.krate26.reshape(shape),
                crate24=rf.crate24.reshape(shape),
                crate25=rf.crate25.reshape(shape),
                crate26=rf.crate26.reshape(shape))

        state = self._sweep_and_chemistry(state, mesh)
        if diag is not None:
            return state, diag
        return state

    def _run_sweep(self, kappa, mesh=None):
        """Dispatch the configured sweep strategy (cfg.sweep_strategy).

        "auto": the lax.scan slab sweep (core.sweep), partitioned by GSPMD
        when the input is sharded.  The explicit collective schedules need
        a `mesh`: "pipelined" keeps the grid decomposition and exchanges
        per-slab halo lines, "zones" replicates the field and decomposes
        over octant zones with a psum (parallel.sweep_dist).
        """
        cfg = self.config
        uvb = jnp.asarray(self.uvb, kappa.dtype)
        cell = self.geom.cell_size
        strategy = cfg.sweep_strategy
        if strategy != "auto" and mesh is None:
            raise ValueError(f"sweep_strategy={strategy!r} needs a mesh")
        if strategy == "pipelined":
            from ..parallel import sweep_dist
            return sweep_dist.diffuse_sweep_pipelined(
                kappa, self.sweep_plan, uvb, cell, mesh)
        if strategy == "zones":
            from ..parallel import sweep_dist
            return sweep_dist.diffuse_sweep_zone_parallel(
                kappa, self.sweep_plan, uvb, cell, mesh)
        if strategy != "auto":
            raise ValueError(f"unknown sweep_strategy {strategy!r}")
        return sweep.diffuse_sweep(kappa, self.sweep_plan, uvb, cell)

    def _sweep_and_chemistry(self, state: FieldState,
                             mesh=None) -> FieldState:
        cfg = self.config
        if cfg.run_uvb_transfer:
            kappa = opacity.compute_opacities(state.HI, state.HeI, state.HeII,
                                              self.opacity_coef)
            state = dataclasses.replace(state,
                                        Jmean=self._run_sweep(kappa, mesh))

        return chemistry.solve_rate_equations(
            state, self.geom, self.dev_tables,
            ksi_matrix=self.ksi_matrix,
            gamma_thin=self.gamma_thin,
            self_shielding_threshold=self.config.self_shielding_threshold,
            run_uvb_transfer=cfg.run_uvb_transfer,
            n_iter=110 if state.rho.dtype == jnp.float64 else 60)

    def make_step(self, stellar: StellarContext | None = None, mesh=None):
        """jit-compiled iteration step.  The point-source tracer keeps its
        own compilation cache; the sweep+chemistry body is jitted here.

        With `mesh` (a jax.sharding.Mesh) the point-source phase runs
        source-parallel across the mesh (parallel.rays_dist): sources are
        sharded, fields all-gathered per shard, deposits reduce-scattered
        back onto the grid decomposition."""
        if stellar is None:
            return jax.jit(lambda state: self.transport_chemistry_step(
                state, mesh=mesh))
        rest = jax.jit(lambda state: self._sweep_and_chemistry(state, mesh))

        def step(state: FieldState):
            state = state.zero_rates()
            if mesh is not None and self.config.tracer_strategy == "domain":
                from ..parallel import rays_domain
                rf, diag = rays_domain.trace_point_sources_domain(
                    state, self.geom, stellar.sources, stellar.tables, mesh,
                    dust_approximation=stellar.dust_approximation,
                    max_pixel_level=stellar.max_pixel_level,
                    dtype=state.rho.dtype)
            elif mesh is not None:
                from ..parallel import rays_dist
                rf, diag = rays_dist.trace_point_sources_dist(
                    state, self.geom, stellar.sources, stellar.tables, mesh,
                    dust_approximation=stellar.dust_approximation,
                    max_pixel_level=stellar.max_pixel_level,
                    dtype=state.rho.dtype)
            else:
                tracer = (rays.trace_point_sources_compact
                          if getattr(self.config, "tracer_compact", False)
                          else rays.trace_point_sources)
                rf, diag = tracer(
                    state, self.geom, stellar.sources, stellar.tables,
                    dust_approximation=stellar.dust_approximation,
                    max_pixel_level=stellar.max_pixel_level,
                    dtype=state.rho.dtype)
            shape = state.shape
            state = dataclasses.replace(
                state,
                krate24=rf.krate24.reshape(shape),
                krate25=rf.krate25.reshape(shape),
                krate26=rf.krate26.reshape(shape),
                crate24=rf.crate24.reshape(shape),
                crate25=rf.crate25.reshape(shape),
                crate26=rf.crate26.reshape(shape))
            return rest(state), diag

        return step

    # ----- non-equilibrium chemistry mode ---------------------------------

    def _assemble_photo_rates(self, state: FieldState, rf=None):
        """Per-cell PhotoRates for the 9-species network from the transport
        products: point-source deposits (krate/crate fields + the k27..k31
        channels of a NoneqRateFields) plus diffuse-band or uniform-thin UVB
        contributions.  Rate assembly mirrors solveRateEquations
        (equiSources.f90:3519-3562) extended to the secondary channels."""
        from . import chemistry_noneq as cn

        cfg = self.config
        nh, nhe = state.nh, state.nhe
        HI, HeI, HeII = chemistry.clamp_species(nh, nhe, state.HI, state.HeI,
                                                state.HeII)
        k24 = chemistry.photo_rates_from_sources(state.krate24, HI)
        k25 = chemistry.photo_rates_from_sources(state.krate25, HeII)
        k26 = chemistry.photo_rates_from_sources(state.krate26, HeI)
        heat = state.crate24 + state.crate25 + state.crate26  # [erg/cm^3/s]
        k_sec = [0.0] * 5
        if rf is not None and hasattr(rf, "krate27"):
            shape = state.shape
            k_sec = [rf.krate27.reshape(shape), rf.krate28.reshape(shape),
                     rf.krate29.reshape(shape), rf.krate30.reshape(shape),
                     rf.krate31.reshape(shape)]

        if cfg.run_uvb_transfer:
            j = FOUR_PI * state.Jmean                      # (3, nx, ny, nz)
            ch = jnp.tensordot(self.ksi_all, j, axes=([0], [0]),
                               precision=_HIGHEST)  # (8, ...)
            k24, k25, k26 = k24 + ch[0], k25 + ch[1], k26 + ch[2]
            k_sec = [k + ch[3 + i] for i, k in enumerate(k_sec)]
            gm = self.gamma_matrix
            heat = heat + (
                jnp.tensordot(gm[:, 0], j, axes=([0], [0]),
                              precision=_HIGHEST) * HI
                + jnp.tensordot(gm[:, 1], j, axes=([0], [0]),
                                precision=_HIGHEST) * HeII
                + jnp.tensordot(gm[:, 2], j, axes=([0], [0]),
                                precision=_HIGHEST) * HeI)
        else:
            thin_all = self.photo_thin_all
            u24, u25, u26 = chemistry.uniform_photo_rates(
                HI, HeI, HeII, cfg.self_shielding_threshold,
                tuple(thin_all[:3]))
            # the same self-shielding switch gates the secondary channels
            shielded_off = jnp.where(u24 > 0.0, 1.0, 0.0)
            k24, k25, k26 = k24 + u24, k25 + u25, k26 + u26
            k_sec = [k + float(thin_all[3 + i]) * shielded_off
                     for i, k in enumerate(k_sec)]
            ht = self.heat_thin
            heat = heat + shielded_off * (ht[0] * HI + ht[1] * HeII
                                          + ht[2] * HeI)

        return cn.PhotoRates(k24=k24, k25=k25, k26=k26,
                             k27=k_sec[0], k28=k_sec[1], k29=k_sec[2],
                             k30=k_sec[3], k31=k_sec[4], heat=heat)

    def make_noneq_step(self, dt: float, stellar: StellarContext | None = None,
                        noneq_tables=None, n_substeps: int = 200,
                        evolve_energy: bool = False, f_h2: float = 0.0,
                        mesh=None):
        """Transport + NON-EQUILIBRIUM chemistry iteration advancing the
        9-species network by dt [s] per step (the capability the reference
        built its k1..k19/k13dd/sigma24..31 tables for but never wired;
        coll_rates.f:3-234, colh2diss.f:3-120).

        Returns step(state, species) -> (state, species[, diag]): `state` is
        the FieldState the transport sees (HI/HeI/HeII synced from the
        species each step), `species` the chemistry_noneq.SpeciesState.
        Use chemistry_noneq.species_from_field_state to initialize.

        With `mesh`, the point-source phase runs source-parallel
        (parallel.rays_dist, quadrature_noneq deposits reduce-scattered
        onto the grid decomposition) and the sweep + network integration
        partition under GSPMD from the sharded state/species
        (parallel.mesh.shard_state / shard_species).
        """
        from . import chemistry_noneq as cn

        if noneq_tables is None:
            noneq_tables = cn.NoneqTablesDevice.from_tables(
                self.tables, jnp.float64 if jax.config.jax_enable_x64
                else jnp.float32)
        cfg = self.config

        def sweep_and_evolve(state: FieldState, species, rf):
            if cfg.run_uvb_transfer:
                kappa = opacity.compute_opacities(
                    state.HI, state.HeI, state.HeII, self.opacity_coef)
                # the mesh must reach _run_sweep: explicit sweep strategies
                # (pipelined/zones) raise without it
                state = dataclasses.replace(state,
                                            Jmean=self._run_sweep(kappa, mesh))
            photo = self._assemble_photo_rates(state, rf)
            species = cn.evolve_noneq(
                species, dt, noneq_tables, photo=photo,
                n_substeps=n_substeps, evolve_energy=evolve_energy,
                tgas_fixed=None if evolve_energy else state.tgas,
                current_redshift=cfg.current_redshift)
            state = dataclasses.replace(
                state, HI=species.HI.astype(state.HI.dtype),
                HeI=species.HeI.astype(state.HI.dtype),
                HeII=species.HeII.astype(state.HI.dtype),
                tgas=(species.tgas.astype(state.tgas.dtype)
                      if evolve_energy else state.tgas))
            return state, species

        if stellar is None:
            return jax.jit(lambda state, species: sweep_and_evolve(
                state.zero_rates(), species, None))
        rest = jax.jit(sweep_and_evolve)

        def step(state: FieldState, species):
            state = state.zero_rates()
            if mesh is not None:
                from ..parallel import rays_dist
                rf, diag = rays_dist.trace_point_sources_dist(
                    state, self.geom, stellar.sources, stellar.tables, mesh,
                    dust_approximation=stellar.dust_approximation,
                    max_pixel_level=stellar.max_pixel_level,
                    dtype=state.rho.dtype, rates_mode="quadrature_noneq")
            else:
                rf, diag = rays.trace_point_sources(
                    state, self.geom, stellar.sources, stellar.tables,
                    dust_approximation=stellar.dust_approximation,
                    max_pixel_level=stellar.max_pixel_level,
                    dtype=state.rho.dtype, rates_mode="quadrature_noneq")
            shape = state.shape
            state = dataclasses.replace(
                state,
                krate24=rf.krate24.reshape(shape),
                krate25=rf.krate25.reshape(shape),
                krate26=rf.krate26.reshape(shape),
                crate24=rf.crate24.reshape(shape),
                crate25=rf.crate25.reshape(shape),
                crate26=rf.crate26.reshape(shape))
            state, species = rest(state, species, rf)
            return state, species, diag

        return step

    def neutral_fraction(self, state: FieldState) -> float:
        """Global neutral-hydrogen mass fraction (computeMass,
        equiSources.f90:4369-4393 / :1833-1836)."""
        return float(jnp.sum(state.HI) / jnp.sum(state.nh))


def iterate_to_equilibrium(model: RTModel, state: FieldState,
                           max_iter: int = 50, tol: float = 1e-6,
                           log=None) -> tuple[FieldState, list[float]]:
    """Run transport+chemistry iterations until the global neutral fraction
    stabilizes (the reference loops forever and is killed by hand; we add the
    convergence check the reference's author applied by eye on the `time`
    log)."""
    step = model.make_step()
    history = []
    prev = np.inf
    for it in range(max_iter):
        state = step(state)
        nf = model.neutral_fraction(state)
        history.append(nf)
        if log is not None:
            log(it, nf)
        if abs(nf - prev) <= tol * max(nf, 1e-30):
            break
        prev = nf
    return state, history
