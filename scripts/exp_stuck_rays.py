"""Diagnose the production final-phase zombie rays (round 5).

The per-chunk alive profile showed ~6 of 98,304 final-phase lanes
surviving to the 12k-step cap while everyone else dies within the first
512-step chunk — the entire 165 s final phase marches for 6 lanes.
This script reproduces the production trace and dumps the survivors'
full ray state every chunk once the population is tiny.

Run from the repository root:  python scripts/exp_stuck_rays.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from radiativetransfer_tpu.config import load_config
from radiativetransfer_tpu.constants import MYR
from radiativetransfer_tpu.core import amr_sparse, rays_multilevel, step as step_mod
from radiativetransfer_tpu.io import grid_io, sources_io
from radiativetransfer_tpu.tables import stellar as stellar_tables

PROD = os.environ.get("PROD_DIR", "/tmp/rt_prod_r5")


def main():
    cfg = load_config(os.path.join(PROD, "inputParameters"))
    levels = grid_io.read_level_npz(os.path.join(PROD, "prodgrid.npz"))
    sp_state, geom = amr_sparse.sparse_from_level_lists(
        levels, cfg.read_metals, be=8, max_depth=4, dtype=jnp.float32)
    lo, hi, _ = grid_io.grid_bounds(levels)
    stars = sources_io.read_star_file(
        os.path.join(PROD, "prodsources.dat"), lo, hi)
    batch, host, n_young = sources_io.prepare_sources(
        stars, geom.nx, cfg.upper_age_limit,
        abun2=np.asarray(sp_state.base.abun2),
        refined=np.asarray(sp_state.refined0))
    population, _ = stellar_tables.load_population(
        cfg.synthesis_dir, len(stars.age), n_young,
        cfg.mass_stellar_particle)
    ctx = step_mod.StellarContext.build(
        population, batch, geom, 10.0 * MYR, metal_coefs=[(0, 0.0)],
        n_stars_specific_age=n_young,
        dust_approximation=cfg.dust_approximation, max_pixel_level=6)

    # equilibrium init (same as the CLI) so fields match the run
    model = step_mod.RTModel.setup(cfg, geom, dtype=jnp.float32)
    base = model.initialize_equilibrium(sp_state.base)
    sp_state = dataclasses.replace(sp_state, base=base)

    # run the production tracer with a small chunk and a survivor dump
    rml = rays_multilevel
    L = sp_state.n_levels
    n = geom.nx
    nF = n * 2 ** (L - 1)
    dtype = jnp.float32

    # monkeypatch-free: call the host driver directly but stop to inspect
    st0 = sp_state.base
    from radiativetransfer_tpu.core.rays import _pack_fields, _spawn_phase
    packed = [_pack_fields(
        st0.HI.reshape(-1).astype(dtype), st0.HeI.reshape(-1).astype(dtype),
        st0.HeII.reshape(-1).astype(dtype), st0.nh.reshape(-1).astype(dtype),
        st0.abun2.reshape(-1).astype(dtype))]
    fields = {}
    for ell in range(1, L):
        lv = sp_state.levels[ell - 1]
        f = lv.fields
        packed.append(_pack_fields(
            f.HI.reshape(-1).astype(dtype), f.HeI.reshape(-1).astype(dtype),
            f.HeII.reshape(-1).astype(dtype), f.nh.reshape(-1).astype(dtype),
            f.abun2.reshape(-1).astype(dtype)))
        fields[f"slot{ell}"] = lv.slot
        fields[f"cover{ell}"] = lv.cover.reshape(-1)
    fields["lv_all"] = jnp.concatenate(packed, axis=0)

    tables_dev = {k: jnp.asarray(v) for k, v in ctx.tables.items()}
    sources = ctx.sources

    from radiativetransfer_tpu.constants import rmax_table
    from radiativetransfer_tpu.core.rays import (RayDiagnostics,
                                                 _split_rays)
    rmax = rmax_table()
    state = _spawn_phase(sources, 1, dtype)
    state = dataclasses.replace(
        state, cell=jnp.clip((state.pos * nF).astype(jnp.int32), 0, nF - 1))
    diag = RayDiagnostics.zeros(sources.n_sources, dtype)
    rfs = rml.RateFields(*[jnp.zeros(fields["lv_all"].shape[0], dtype)
                           for _ in range(6)])
    ctx_arrays = (jnp.asarray(tables_dev["quad_A"], dtype),
                  jnp.asarray(tables_dev["quad_W"], dtype))
    rel_kill = 1.0e-10

    chunk = 512

    def run_phase(state, rfs, diag, level, last, r_stop, max_steps):
        rays_per_source = 12 * 4 ** (level - 1)
        src_of_ray = jnp.repeat(
            jnp.arange(sources.n_sources, dtype=jnp.int32),
            rays_per_source)

        @jax.jit
        def step_chunk(state, rfs, diag):
            s2, d2, r2 = rml._march_phase_ml(
                state, fields, geom, L, ("quadrature", ctx_arrays), diag,
                rfs, r_stop, last, ctx.dust_approximation, chunk,
                src_of_ray, rel_kill=rel_kill)
            return s2, r2, d2, jnp.sum(s2.alive.astype(jnp.int32))

        steps = 0
        while steps < max_steps:
            state, rfs, diag, cnt = step_chunk(state, rfs, diag)
            steps += chunk
            cnt = int(cnt)
            print(f"  level {level}: after {steps} steps alive = {cnt}")
            if cnt == 0:
                break
            if last and cnt <= 16:
                alive = np.asarray(state.alive)
                idx = np.nonzero(alive)[0]
                pos = np.asarray(state.pos)[idx]
                cell = np.asarray(state.cell)[idx]
                rad = np.asarray(state.radius)[idx]
                dep = np.asarray(state.depth)[idx]
                dirs = np.asarray(state.direction)[idx]
                ndot = np.asarray(state.ndot)[idx]
                for i, lane in enumerate(idx):
                    print(f"    lane {lane}: pos={pos[i]} cell={cell[i]} "
                          f"radius={rad[i]:.3f} depth={dep[i]} "
                          f"dir={dirs[i]} ndot={ndot[i]:.3e}")
                if steps >= 3 * chunk:
                    break
        if not last:
            state, in_box, was_split = _split_rays(state, level, n, dtype,
                                                   cell_grid=nF)
        return state, rfs, diag

    for level in range(1, 7):
        last = level == 6
        r_stop = float(rmax[level - 1])
        max_steps = (int(12 * nF + 64) if last
                     else int(6 * 2 ** (L - 1) * (r_stop + 2) + 32))
        state, rfs, diag = run_phase(state, rfs, diag, level, last,
                                     r_stop, max_steps)


if __name__ == "__main__":
    main()
