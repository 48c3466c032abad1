"""Runtime sanitizers (SURVEY.md §5.2).

The reference guards its hot paths with ~40 stop-asserts (intensity
sanity, geometry bound checks, species-range checks — e.g. checkPoint,
/root/reference/equiSources.f90:2962-2976; transportRoutinesModule.f90:
680-688).  The analogs here:

* `jax.config.jax_debug_nans` (CLI --debug-nans) — cheap, always
  available;
* host-side chain-table validation of every sweep plan
  (core.sweep.validate_zone_tables);
* THIS module: `checkify` instrumentation of the XLA compute paths —
  gather/scatter index bounds, NaN/Inf production, and division — run as
  a pre-flight on the actual ingested data (CLI --debug-checkify).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import checkify

from . import chemistry, opacity, rays, sweep

ERRORS = checkify.index_checks | checkify.float_checks | checkify.div_checks


def checked_trace(state_fields, geom, sources, tables,
                  dust_approximation: int = 0, max_pixel_level: int = 3,
                  dtype=jnp.float64, rates_mode: str = "auto",
                  n_bands: int = 3):
    """Point-source trace under checkify: every gather/scatter index is
    bounds-checked and every float op NaN/Inf-checked.  Raises
    checkify.JaxRuntimeError on the first violated invariant; returns
    (RateFields, RayDiagnostics) otherwise.  ~2-4x the uninstrumented
    cost — a debug tool, not the production path."""
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    n = geom.nx
    fields = {
        "HI": state_fields.HI.reshape(-1).astype(dtype),
        "HeI": state_fields.HeI.reshape(-1).astype(dtype),
        "HeII": state_fields.HeII.reshape(-1).astype(dtype),
        "nH": state_fields.nh.reshape(-1).astype(dtype),
        "abun2": state_fields.abun2.reshape(-1).astype(dtype),
    }
    st = rays._spawn_phase(sources, 1, dtype)
    st = dataclasses.replace(
        st, cell=jnp.clip((st.pos * n).astype(jnp.int32), 0, n - 1))
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}
    f = partial(rays._trace_all_phases, geom=geom,
                n_sources=sources.n_sources,
                dust_approximation=dust_approximation,
                max_pixel_level=max_pixel_level, dtype=dtype,
                rates_mode=rates_mode, n_bands=n_bands)
    checked = jax.jit(checkify.checkify(f, errors=ERRORS))
    err, out = checked(fields, st, tables_dev)
    checkify.check_error(err)
    return out


def checked_sweep_chemistry(model, state):
    """One diffuse sweep + equilibrium chemistry under checkify.
    Raises on the first NaN/Inf, out-of-bounds index, or bad division."""
    cfg = model.config

    def run(state):
        if cfg.run_uvb_transfer:
            kappa = opacity.compute_opacities(
                state.HI, state.HeI, state.HeII, model.opacity_coef)
            j = sweep.diffuse_sweep(
                kappa, model.sweep_plan,
                jnp.asarray(model.uvb, kappa.dtype), model.geom.cell_size)
            state = dataclasses.replace(state, Jmean=j)
        return chemistry.solve_rate_equations(
            state, model.geom, model.dev_tables,
            ksi_matrix=model.ksi_matrix, gamma_thin=model.gamma_thin,
            self_shielding_threshold=cfg.self_shielding_threshold,
            run_uvb_transfer=cfg.run_uvb_transfer,
            n_iter=110 if state.rho.dtype == jnp.float64 else 60)

    checked = jax.jit(checkify.checkify(run, errors=ERRORS))
    err, out = checked(state)
    checkify.check_error(err)
    return out


def preflight(model, state, stellar_ctx=None, max_pixel_level: int = 3):
    """Run the checked sweep+chemistry (and trace, when sources are
    present) once on the ACTUAL ingested data — the sanitizer analog of
    the reference's startup-time asserts.  Returns normally or raises
    with the first violated invariant."""
    checked_sweep_chemistry(model, state)
    if stellar_ctx is not None:
        checked_trace(state, model.geom, stellar_ctx.sources,
                      stellar_ctx.tables,
                      dust_approximation=stellar_ctx.dust_approximation,
                      max_pixel_level=min(max_pixel_level,
                                          stellar_ctx.max_pixel_level),
                      dtype=state.rho.dtype)


# ---------------------------------------------------------------------------
# nested / block-sparse storage (VERDICT r4 item 5): the slot-map and
# padding-block index machinery is exactly where bounds bugs live (the
# round-4 padding-zeroing fix 341dba6 is the proof), so the production
# storage gets the same pre-flight
# ---------------------------------------------------------------------------


def checked_trace_sparse(sp_state, geom, sources, tables,
                         dust_approximation: int = 0,
                         max_pixel_level: int = 3, dtype=jnp.float64,
                         rates_mode: str = "auto"):
    """Sparse point-source trace under checkify: every slot-map gather,
    level-concatenated field gather, and deposit scatter is bounds-checked
    and every float op NaN/Inf-checked."""
    from . import rays_multilevel as rml
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    L = sp_state.n_levels
    n = geom.nx
    nF = n * 2 ** (L - 1)
    st0 = sp_state.base
    packed = [rays._pack_fields(
        st0.HI.reshape(-1).astype(dtype), st0.HeI.reshape(-1).astype(dtype),
        st0.HeII.reshape(-1).astype(dtype), st0.nh.reshape(-1).astype(dtype),
        st0.abun2.reshape(-1).astype(dtype))]
    fields = {}
    for ell in range(1, L):
        lv = sp_state.levels[ell - 1]
        fl = lv.fields
        packed.append(rays._pack_fields(
            fl.HI.reshape(-1).astype(dtype),
            fl.HeI.reshape(-1).astype(dtype),
            fl.HeII.reshape(-1).astype(dtype),
            fl.nh.reshape(-1).astype(dtype),
            fl.abun2.reshape(-1).astype(dtype)))
        fields[f"slot{ell}"] = lv.slot
        fields[f"cover{ell}"] = lv.cover.reshape(-1)
    fields["lv_all"] = jnp.concatenate(packed, axis=0)
    st = rays._spawn_phase(sources, 1, dtype)
    st = dataclasses.replace(
        st, cell=jnp.clip((st.pos * nF).astype(jnp.int32), 0, nF - 1))
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}
    f = partial(rml._trace_all_phases_ml, geom=geom, n_levels=L,
                n_sources=sources.n_sources,
                dust_approximation=dust_approximation,
                max_pixel_level=max_pixel_level, dtype=dtype,
                rates_mode=rates_mode)
    checked = jax.jit(checkify.checkify(f, errors=ERRORS))
    err, out = checked(fields, st, tables_dev)
    checkify.check_error(err)
    return out


def checked_sweep_chemistry_sparse(amodel, state):
    """One block-sparse sweep (12-direction level-1 plan — the slot-map
    gather/scatter machinery is zone-independent, so 12 directions
    exercise every indexing path at ~1/16 the full-plan cost) +
    equilibrium chemistry + restriction sync under checkify."""
    from . import amr_sparse, sweep_multilevel, sweep_sparse
    rt = amodel.rt
    cfg = rt.config
    plan1 = (sweep_multilevel.build_ml_sweep_plan(1, rt.geom.nx,
                                                  amodel.n_levels)
             if cfg.run_uvb_transfer else None)
    # resolve the static refinement window eagerly (it is a trace-time
    # static) so the CHECKED sweep exercises the windowed production path
    win = sweep_sparse.compute_window(state)

    def run(state):
        if cfg.run_uvb_transfer:
            k0 = opacity.compute_opacities(
                state.base.HI, state.base.HeI, state.base.HeII,
                rt.opacity_coef)
            lv_k = [opacity.compute_opacities(
                lv.fields.HI, lv.fields.HeI, lv.fields.HeII,
                rt.opacity_coef) for lv in state.levels]
            j0, jbs = sweep_sparse.diffuse_sweep_sparse(
                k0, lv_k, state, plan1, jnp.asarray(rt.uvb, k0.dtype),
                rt.geom.cell_size,
                n_coupling_iters=amodel.n_coupling_iters,
                max_dirs_per_launch=amodel.max_dirs_per_launch,
                window=win)
            state = dataclasses.replace(
                state,
                base=dataclasses.replace(state.base, Jmean=j0),
                levels=tuple(
                    dataclasses.replace(lv, fields=dataclasses.replace(
                        lv.fields, Jmean=j))
                    for lv, j in zip(state.levels, jbs)))
        return amodel._chemistry_and_sync(state)

    checked = jax.jit(checkify.checkify(run, errors=ERRORS))
    err, out = checked(state)
    checkify.check_error(err)
    return out


def checked_sweep_chemistry_ml(amodel, state):
    """Dense multilevel analog of checked_sweep_chemistry_sparse
    (12-direction level-1 plan)."""
    from . import amr, chemistry as chem_mod, sweep_multilevel
    rt = amodel.rt
    cfg = rt.config
    plan1 = (sweep_multilevel.build_ml_sweep_plan(1, rt.geom.nx,
                                                  amodel.n_levels)
             if cfg.run_uvb_transfer else None)

    def run(state):
        if cfg.run_uvb_transfer:
            kappas = [opacity.compute_opacities(
                lv.HI, lv.HeI, lv.HeII, rt.opacity_coef)
                for lv in state.levels]
            js = sweep_multilevel.diffuse_sweep_multilevel(
                kappas, list(state.refined), plan1,
                jnp.asarray(rt.uvb, kappas[0].dtype), rt.geom.cell_size,
                n_coupling_iters=amodel.n_coupling_iters)
            state = amr.MultiLevelState(
                levels=tuple(dataclasses.replace(lv, Jmean=j)
                             for lv, j in zip(state.levels, js)),
                refined=state.refined)
        kwargs = dict(
            ksi_matrix=rt.ksi_matrix, gamma_thin=rt.gamma_thin,
            self_shielding_threshold=cfg.self_shielding_threshold,
            run_uvb_transfer=cfg.run_uvb_transfer,
            n_iter=110 if state.levels[0].rho.dtype == jnp.float64 else 60)
        new_levels = tuple(
            chem_mod.solve_rate_equations(lv, amodel.level_geom(ell),
                                          rt.dev_tables, **kwargs)
            for ell, lv in enumerate(state.levels))
        return amr.sync_restriction_multi(
            amr.MultiLevelState(levels=new_levels, refined=state.refined))

    checked = jax.jit(checkify.checkify(run, errors=ERRORS))
    err, out = checked(state)
    checkify.check_error(err)
    return out


def checked_trace_ml(ml_state, geom, sources, tables,
                     dust_approximation: int = 0, max_pixel_level: int = 3,
                     dtype=jnp.float64, rates_mode: str = "auto"):
    """Dense multilevel trace under checkify."""
    from . import rays_multilevel as rml
    if rates_mode == "auto":
        rates_mode = "quadrature" if "quad_A" in tables else "table"
    L = ml_state.n_levels
    n = geom.nx
    nF = n * 2 ** (L - 1)
    fields = {"leaf_level": rml.leaf_level_volume(ml_state.refined, n, L)}
    fields["lv_all"] = jnp.concatenate([
        rays._pack_fields(
            st.HI.reshape(-1).astype(dtype),
            st.HeI.reshape(-1).astype(dtype),
            st.HeII.reshape(-1).astype(dtype),
            st.nh.reshape(-1).astype(dtype),
            st.abun2.reshape(-1).astype(dtype))
        for st in ml_state.levels], axis=0)
    st = rays._spawn_phase(sources, 1, dtype)
    st = dataclasses.replace(
        st, cell=jnp.clip((st.pos * nF).astype(jnp.int32), 0, nF - 1))
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}
    f = partial(rml._trace_all_phases_ml, geom=geom, n_levels=L,
                n_sources=sources.n_sources,
                dust_approximation=dust_approximation,
                max_pixel_level=max_pixel_level, dtype=dtype,
                rates_mode=rates_mode)
    checked = jax.jit(checkify.checkify(f, errors=ERRORS))
    err, out = checked(fields, st, tables_dev)
    checkify.check_error(err)
    return out


def preflight_sparse(amodel, state, stellar_ctx=None,
                     max_pixel_level: int = 3):
    """Pre-flight the block-sparse production path on the ingested data:
    checked sweep + chemistry + restriction, and a checked sparse trace
    when sources are present (the reference's stop-asserts analog on the
    storage form that actually runs production)."""
    checked_sweep_chemistry_sparse(amodel, state)
    if stellar_ctx is not None:
        checked_trace_sparse(
            state, amodel.rt.geom, stellar_ctx.sources, stellar_ctx.tables,
            dust_approximation=stellar_ctx.dust_approximation,
            max_pixel_level=min(max_pixel_level,
                                stellar_ctx.max_pixel_level),
            dtype=state.base.rho.dtype)


def preflight_ml(amodel, state, stellar_ctx=None, max_pixel_level: int = 3):
    """Pre-flight the dense multilevel path on the ingested data."""
    checked_sweep_chemistry_ml(amodel, state)
    if stellar_ctx is not None:
        checked_trace_ml(
            state, amodel.rt.geom, stellar_ctx.sources, stellar_ctx.tables,
            dust_approximation=stellar_ctx.dust_approximation,
            max_pixel_level=min(max_pixel_level,
                                stellar_ctx.max_pixel_level),
            dtype=state.levels[0].rho.dtype)
