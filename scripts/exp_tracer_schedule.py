"""Final-phase alive-count profile + compaction-schedule study.

VERDICT r3 item 3: the 128^3/8src iteration is ~97% tracer and the final
phase pays per-LANE scatter cost on mostly-dead lanes.  This experiment
(a) measures the alive-count profile per 16-step chunk of the final phase
at the bench configuration, (b) times the lockstep tracer, the equal-chunk
compacting tracer at several chunk sizes, and (c) evaluates the optimal
readback placement implied by the profile (each readback costs one host
round trip; each compaction to bucket B saves steps_remaining * (R - B)
scatter rows).

Run:  python scripts/exp_tracer_schedule.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from radiativetransfer_tpu.constants import KPC
from radiativetransfer_tpu.core import rays
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu.tables import stellar


def setup(n=128, n_src=8):
    pop = stellar.blackbody_population(q_ionizing=1.0e51)
    t = stellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
    geom_cell = (2000.0 / n) * KPC
    log_vol = float(np.log(geom_cell) * 3)
    quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
    tables = {"reaction_log": jnp.asarray(t.reaction_log - log_vol,
                                          jnp.float32)[None],
              "energy_log": jnp.asarray(t.energy_log - log_vol,
                                        jnp.float32)[None],
              "quad_A": jnp.asarray(quad_a, jnp.float32),
              "quad_W": jnp.asarray(quad_w / np.exp(log_vol),
                                    jnp.float32)[None],
              "output_freq": t.output_freq,
              "output_sigma24": t.output_sigma24,
              "output_sigma25": t.output_sigma25,
              "output_sigma26": t.output_sigma26,
              "output_sigma_dust": t.output_sigma_dust}
    rng = np.random.default_rng(0)
    pos = (np.floor(rng.uniform(0.3, 0.7, (n_src, 3)) * n) + 0.5) / n
    src = rays.SourceBatch(position=pos, weight=np.ones(n_src),
                           table_idx=np.zeros(n_src, np.int32))
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=jnp.float32)
    return state, geom, src, tables


def time_fn(fn, reps=3):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main():
    state, geom, src, tables = setup()
    print(f"platform: {jax.devices()[0].platform}")

    # --- lockstep baseline ------------------------------------------------
    def run_lockstep():
        rf, diag = rays.trace_point_sources(
            state, geom, src, tables, max_pixel_level=6, dtype=jnp.float32,
            rates_mode="quadrature")
        return jax.block_until_ready(rf.krate24)

    dt_lock = time_fn(run_lockstep)
    print(f"lockstep tracer: {dt_lock * 1e3:.1f} ms")

    # --- alive profile (chunked run, counts fetched synchronously) --------
    counts = []

    def run_profile():
        del counts[:]
        # replicate trace_point_sources_compact's driver but fetch every
        # chunk count synchronously (diagnostic only)
        out = rays.trace_point_sources_compact(
            state, geom, src, tables, max_pixel_level=6,
            dtype=jnp.float32, chunk=16)
        return out

    # instrument via the module's own pieces: run chunks manually
    import dataclasses
    from functools import partial
    from radiativetransfer_tpu.core.rays import (
        _TRACER_CACHE, _get_chunk_runner, _bucket_size, _get_compactor,
        _pack_tables, default_tau_kill, rmax_table, _spawn_phase,
        SIGMA24_AT_NU1, SIGMA25_AT_NU3, SIGMA26_AT_NU2, SIGMA_DUST_AT_NU1)

    dtype = jnp.float32
    tau_kill = default_tau_kill(dtype)
    rel_kill = 1.0e-10
    n = geom.nx
    fields = {
        "HI": state.HI.reshape(-1).astype(dtype),
        "HeI": state.HeI.reshape(-1).astype(dtype),
        "HeII": state.HeII.reshape(-1).astype(dtype),
        "nH": state.nh.reshape(-1).astype(dtype),
        "abun2": state.abun2.reshape(-1).astype(dtype),
    }
    st0 = _spawn_phase(src, 1, dtype)
    st0 = dataclasses.replace(
        st0, cell=jnp.clip((st0.pos * n).astype(jnp.int32), 0, n - 1))
    tables_dev = {k: jnp.asarray(v) for k, v in tables.items()}
    key = ("prefix", geom, src.n_sources, 0, 6, "float32", "quadrature", 3,
           tau_kill, rel_kill)
    if key not in _TRACER_CACHE:
        _TRACER_CACHE[key] = jax.jit(
            partial(rays._trace_all_phases, geom=geom,
                    n_sources=src.n_sources, dust_approximation=0,
                    max_pixel_level=6, dtype=dtype,
                    rates_mode="quadrature", n_bands=3, tau_kill=tau_kill,
                    rel_kill=rel_kill, skip_last_phase=True))
    rf, diag, st, fields_pk = _TRACER_CACHE[key](fields, st0, tables_dev)
    ctx_arrays = (jnp.asarray(tables_dev["quad_A"], dtype),
                  jnp.asarray(tables_dev["quad_W"], dtype))
    sig_ratio = jnp.stack([
        jnp.asarray(tables_dev["output_sigma24"], dtype) / SIGMA24_AT_NU1,
        jnp.asarray(tables_dev["output_sigma26"], dtype) / SIGMA26_AT_NU2,
        jnp.asarray(tables_dev["output_sigma25"], dtype) / SIGMA25_AT_NU3,
        jnp.asarray(tables_dev["output_sigma_dust"], dtype)
        / SIGMA_DUST_AT_NU1])
    rays_last = 12 * 4 ** 5
    src_of_ray = jnp.repeat(jnp.arange(src.n_sources, dtype=jnp.int32),
                            rays_last)
    r_stop = float(rmax_table()[5])
    R0 = st.pos.shape[0]
    profile = []
    steps = 0
    chunk = 16
    while steps < 6 * n + 64:
        runner = _get_chunk_runner(
            ("chunk", geom, R0, chunk, 0, 3, "quadrature", tau_kill,
             rel_kill, r_stop, 6, "float32"),
            geom, True, r_stop, chunk, 0, 3, "quadrature", tau_kill,
            rel_kill, dtype)
        st, diag, rf, cnt = runner(fields_pk, st, diag, rf, src_of_ray,
                                   ctx_arrays, sig_ratio)
        c = int(cnt)
        profile.append(c)
        steps += chunk
        if c == 0:
            break
    print(f"alive profile per {chunk} steps (R0={R0}):")
    print("  " + " ".join(str(c) for c in profile))

    # --- derived optimal schedule ----------------------------------------
    # cost model: scatter+gather ~ a * R per step; readback ~ RTT
    RTT = 0.025
    a = dt_lock * 0.8 / (len(profile) * chunk * R0)   # per-lane-step cost
    print(f"per-lane-step cost ~ {a * 1e9:.1f} ns (RTT {RTT * 1e3:.0f} ms)")
    # evaluate equal-chunk compaction costs from the profile
    for ch_eval in (16, 32, 48):
        t = 0.0
        bucket = R0
        nread = 0
        pending = None
        s = 0
        i = 0
        while s < len(profile) * chunk:
            # runner of ch_eval steps at current bucket
            t += a * ch_eval * bucket
            nread += 1
            t += RTT
            idx = min((s + ch_eval) // chunk - 1, len(profile) - 1)
            cnt = profile[idx]
            if pending is not None:
                bucket = min(bucket, _bucket_size(pending))
            pending = cnt
            s += ch_eval
            if cnt == 0:
                break
        print(f"  modeled equal-chunk {ch_eval}: {t * 1e3:.0f} ms "
              f"({nread} readbacks)")

    # --- measured: compact tracer at several chunk sizes ------------------
    for ch in (16, 32, 48):
        def run_compact(ch=ch):
            rf, diag = rays.trace_point_sources_compact(
                state, geom, src, tables, max_pixel_level=6,
                dtype=jnp.float32, chunk=ch)
            return jax.block_until_ready(rf.krate24)
        dt_c = time_fn(run_compact)
        print(f"compact chunk={ch}: {dt_c * 1e3:.1f} ms")


if __name__ == "__main__":
    main()
