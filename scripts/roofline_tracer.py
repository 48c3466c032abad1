"""Point-source tracer roofline (VERDICT r2 weak-2).

Decomposes the tracer's per-while-step cost into its four component
kernels, measures each at the production shape on the live backend, counts
the ACTUAL lockstep iterations each phase executes (numpy geometry replay,
host-side), and prints measured-vs-floor, for the hot loop of
/root/reference/equiSources.f90:3168-3276.

Run on the GPU:  python scripts/roofline_tracer.py
Env: ROOF_N (grid, default 128), ROOF_SOURCES (default 8)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from radiativetransfer_tpu.constants import KPC, rmax_table
from radiativetransfer_tpu.core import rays
from radiativetransfer_tpu.core.state import GridGeometry, uniform_state
from radiativetransfer_tpu.tables import stellar

N = int(os.environ.get("ROOF_N", "128"))
NSRC = int(os.environ.get("ROOF_SOURCES", "8"))
REPS = 3


sync = jax.block_until_ready


def timeit(fn, *args):
    sync(fn(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def count_phase_steps(state, geom, sources, tables, max_pixel_level=6):
    """Lockstep while-iteration counts per phase: the DEVICE tracer runs
    each phase (exact dynamics), and a host geometry replay of the same
    phase counts the iterations until every lane is dead — the quantity the
    roofline needs and the device loop doesn't expose.  Models the
    production f32 termination policy (tau_kill=30 + spectrum-exhaustion
    rel_kill=1e-10, round-3 defaults in core.rays)."""
    import dataclasses
    n = geom.nx
    rmax = rmax_table()
    dtype = jnp.float32
    fields_pk = rays._pack_fields(
        state.HI.astype(dtype).reshape(-1),
        state.HeI.astype(dtype).reshape(-1),
        state.HeII.astype(dtype).reshape(-1),
        state.nh.astype(dtype).reshape(-1),
        state.abun2.astype(dtype).reshape(-1))
    fp = np.asarray(fields_pk, np.float64)
    cs = geom.cell_size
    from radiativetransfer_tpu.constants import (SIGMA24_AT_NU1,
                                                 SIGMA25_AT_NU3,
                                                 SIGMA26_AT_NU2)
    rf = rays.RateFields(*[jnp.zeros(n ** 3, dtype) for _ in range(6)])
    rate_ctx = ("quadrature", (tables["quad_A"], tables["quad_W"]))
    quad_A_h = np.asarray(tables["quad_A"], np.float64)
    wsum_h = np.abs(np.asarray(tables["quad_W"], np.float64)).sum(2).max(0)
    rem_floor = 1.0e-10 * wsum_h.sum()
    diag = rays.RayDiagnostics.zeros(sources.n_sources, dtype)
    st = rays._spawn_phase(sources, 1, dtype)
    st = dataclasses.replace(
        st, cell=jnp.clip((st.pos * n).astype(jnp.int32), 0, n - 1))
    steps = []
    for level in range(1, max_pixel_level + 1):
        last = level == max_pixel_level
        r_stop = rmax[level - 1]
        max_steps = int(12 * n + 64) if last else int(6 * (r_stop + 2) + 32)
        src_of_ray = jnp.repeat(
            jnp.arange(sources.n_sources, dtype=jnp.int32),
            12 * 4 ** (level - 1))

        # host replay of THIS phase from the device start state
        pos = np.asarray(st.pos, np.float64)
        cell = np.asarray(st.cell, np.int64)
        d = np.asarray(st.direction, np.float64)
        alive = np.asarray(st.alive)
        radius = np.asarray(st.radius, np.float64)
        depth4 = np.asarray(st.depth, np.float64).copy()
        depth = depth4[:, :3]
        it = 0
        while alive.any() and it < max_steps:
            d_safe = np.where(np.abs(d) < 1e-12,
                              np.where(d < 0, -1e-12, 1e-12), d)
            bound = (cell + (d_safe > 0)) / n
            t_ax = (bound - pos) / d_safe
            t_min = np.maximum(t_ax.min(1), 0.0)
            exit_axis = t_ax.argmin(1)
            seg = t_min * n
            radius_new = radius + seg
            if last:
                cut = np.zeros_like(alive)
                will_split = cut
            else:
                will_split = radius_new >= r_stop
                cut = will_split
                seg = np.where(cut, np.maximum(r_stop - radius, 0.0), seg)
                radius_new = radius + seg
                t_min = seg / n
            idx = np.clip((cell[:, 0] * n + cell[:, 1]) * n + cell[:, 2],
                          0, n ** 3 - 1)
            plen = seg * cs
            tau = np.stack([plen * fp[idx, 0] * SIGMA24_AT_NU1,
                            plen * fp[idx, 1] * SIGMA26_AT_NU2,
                            plen * fp[idx, 2] * SIGMA25_AT_NU3], 1)
            tau = np.where(alive[:, None], np.maximum(tau, 0), 0)
            depth4[:, :3] += tau
            depth = depth4[:, :3]
            pos_new = pos + t_min[:, None] * d
            hop = np.eye(3, dtype=np.int64)[exit_axis] * np.where(
                d_safe > 0, 1, -1)
            cell_new = np.where(cut[:, None], cell, cell + hop)
            face = np.take_along_axis(bound, exit_axis[:, None], 1)[:, 0]
            on = np.arange(3)[None, :] == exit_axis[:, None]
            pos_new = np.where(on & ~cut[:, None], face[:, None], pos_new)
            oob = ((cell_new < 0) | (cell_new >= n)).any(1) & ~cut
            killed = depth.min(1) > 30.0
            rem = np.exp(-(depth4 @ quad_A_h)) @ wsum_h
            killed |= rem < rem_floor
            pos = np.where(alive[:, None], pos_new, pos)
            cell = np.where(alive[:, None], cell_new, cell)
            radius = np.where(alive, radius_new, radius)
            alive = alive & ~oob & ~killed & ~will_split
            it += 1
        steps.append(it)

        # exact device phase advance to the next start state
        st, diag, rf = rays._march_phase(st, fields_pk, geom, rate_ctx,
                                         diag, rf, r_stop, last, 0,
                                         max_steps, src_of_ray, n_bands=3,
                                         tau_kill=30.0, unroll=4,
                                         rel_kill=1.0e-10)
        if not last:
            st, _, _ = rays._split_rays(st, level, n, dtype)
    return steps


def main():
    platform = jax.devices()[0].platform
    n = N
    pop = stellar.blackbody_population(q_ionizing=1.0e51)
    t = stellar.build_source_tables(pop, 0, 0.0, 0, 0.0)
    geom = GridGeometry(n, n, n, 2000.0 * KPC)
    log_vol = float(np.log(geom.cell_size) * 3)
    quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
    tables = {"quad_A": jnp.asarray(quad_a, jnp.float32),
              "quad_W": jnp.asarray(quad_w / np.exp(log_vol),
                                    jnp.float32)[None],
              "output_freq": t.output_freq,
              "output_sigma24": t.output_sigma24,
              "output_sigma25": t.output_sigma25,
              "output_sigma26": t.output_sigma26,
              "output_sigma_dust": t.output_sigma_dust}
    rng = np.random.default_rng(0)
    pos = (np.floor(rng.uniform(0.3, 0.7, (NSRC, 3)) * n) + 0.5) / n
    src = rays.SourceBatch(position=pos, weight=np.ones(NSRC),
                           table_idx=np.zeros(NSRC, np.int32))
    state = uniform_state(n, nh=2e-4, tgas=1.5e4, dtype=jnp.float32)

    # ---- full tracer ----
    def full():
        rf, diag = rays.trace_point_sources(state, geom, src, tables,
                                            max_pixel_level=6,
                                            dtype=jnp.float32,
                                            rates_mode="quadrature")
        return rf.krate24
    dt_full = timeit(full)
    total_rays = NSRC * sum(12 * 4 ** (l - 1) for l in range(1, 7))
    print(f"platform={platform} n={n} sources={NSRC}")
    print(f"full tracer: {dt_full * 1e3:.1f} ms  "
          f"({total_rays / dt_full:.3e} rays/s)")

    # ---- actual lockstep iteration counts (host replay) ----
    steps = count_phase_steps(state, geom, src, tables)
    R_per_phase = [NSRC * 12 * 4 ** (l - 1) for l in range(1, 7)]
    ray_steps = sum(r * s for r, s in zip(R_per_phase, steps))
    print(f"phase steps executed: {steps} -> "
          f"{ray_steps:.3e} ray-steps (lockstep slots incl. dead lanes)")

    # ---- component floors at the final-phase shape ----
    R = R_per_phase[-1]
    K = 50
    fp = jnp.zeros((n ** 3, 5), jnp.float32)
    idx0 = jnp.asarray(rng.integers(0, n ** 3, R), jnp.int32)
    A = tables["quad_A"]; W = tables["quad_W"][0]
    F = A.shape[1]

    @jax.jit
    def gather_bench(idx0):
        def body(i, acc):
            idx = (idx0 + i * 1646237) % (n ** 3)
            return acc + fp[idx].sum(1)
        return jax.lax.fori_loop(0, K, body, jnp.zeros(R, jnp.float32))

    @jax.jit
    def scatter_bench(idx0, v):
        def body(i, rf):
            idx = (idx0 + i * 1234577) % (n ** 3)
            for _ in range(6):
                rf = rf.at[idx].add(v)
            return rf
        return jax.lax.fori_loop(0, K, body, jnp.zeros(n ** 3, jnp.float32))

    @jax.jit
    def quad_bench(d0, dtau, w):
        def body(i, acc):
            dep = rays._deposit_quadrature(d0 + 1e-6 * i, dtau, A,
                                           tables["quad_W"],
                                           jnp.zeros(R, jnp.int32), w)
            return acc + dep[0]
        return jax.lax.fori_loop(0, K, body, jnp.zeros(R, jnp.float32))

    import dataclasses as dc
    st0 = rays._spawn_phase(src, 6, jnp.float32)   # final-phase ray count

    @jax.jit
    def while_bench(bump):
        def cond(c):
            return c[1] < K
        def body(c):
            s, i = c
            return dc.replace(s, radius=s.radius + bump), i + 1
        s, _ = jax.lax.while_loop(cond, body, (st0, jnp.int32(0)))
        return s.radius

    d0 = jnp.abs(jnp.asarray(rng.normal(0, 1, (R, 4)), jnp.float32))
    dtau = jnp.abs(jnp.asarray(rng.normal(0, 1, (R, 3)), jnp.float32))
    w = jnp.ones(R, jnp.float32)

    dt_g = timeit(gather_bench, idx0) / K
    dt_s = timeit(scatter_bench, idx0, w) / K
    dt_q = timeit(quad_bench, d0, dtau, w) / K
    dt_w = timeit(while_bench, jnp.float32(1.0)) / K

    per_step = {"row gather (R,5)": dt_g, "6 scalar scatter-adds": dt_s,
                "quadrature deposit (4 exp fields, F=%d)" % F: dt_q,
                "while carry churn (trivial body)": dt_w}
    print(f"\nper-while-step component costs at R={R}:")
    floor = 0.0
    steps_final = steps[-1]
    for k, v in per_step.items():
        print(f"  {k:44s} {v * 1e6:8.1f} us/step  "
              f"x{steps_final} = {v * steps_final * 1e3:7.2f} ms")
        floor += v * steps_final
    # earlier phases: scale by ray-step totals
    scale = ray_steps / (R * steps_final)
    floor_all = floor * scale
    print(f"\ncomponent floor (final phase): {floor * 1e3:.1f} ms; "
          f"all phases ~{floor_all * 1e3:.1f} ms; "
          f"measured {dt_full * 1e3:.1f} ms "
          f"-> {dt_full / floor_all:.2f}x the component floor")


if __name__ == "__main__":
    main()
