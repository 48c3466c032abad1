"""Scatter-add cost scaling experiments for the tracer deposit (round 3).

Questions:
  1. How does scatter-add cost scale with row count?  (is there a large
     fixed per-call overhead that batching K steps would amortize?)
  2. 6 scalar scatters vs ONE scalar scatter with combined idx*8+c rows
     vs one 6-column row scatter.
  3. Does sorting indices help?
  4. while_loop per-iteration overhead vs carry size.
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

N = 128
NC = N ** 3
REPS = 5
K = 20  # fori iterations per timed call


sync = jax.block_until_ready


def timeit(fn, *args):
    sync(fn(*args))
    ts = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        sync(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts)


def main():
    rng = np.random.default_rng(0)
    print(f"platform={jax.devices()[0].platform}  grid={N}^3")

    # --- 1/2/3: scatter variants at several row counts ---
    for R in (12288, 98304, 393216, 786432):
        idx_np = rng.integers(0, NC, R)
        idx = jnp.asarray(idx_np, jnp.int32)
        idx_sorted = jnp.asarray(np.sort(idx_np), jnp.int32)
        v = jnp.ones(R, jnp.float32)
        v6 = jnp.ones((R, 6), jnp.float32)

        @jax.jit
        def six_scalar(idx, v):
            def body(i, rf):
                ii = (idx + i) % NC
                for _ in range(6):
                    rf = rf.at[ii].add(v)
                return rf
            return jax.lax.fori_loop(0, K, body, jnp.zeros(NC, jnp.float32))

        @jax.jit
        def one_combined(idx, v):
            def body(i, rf):
                ii = (idx + i) % NC
                big = (ii[:, None] * 8 + jnp.arange(6)[None, :]).reshape(-1)
                return rf.at[big].add(jnp.tile(v, 6))
            return jax.lax.fori_loop(0, K, body,
                                     jnp.zeros(NC * 8, jnp.float32))

        @jax.jit
        def row6(idx, v6):
            def body(i, rf):
                ii = (idx + i) % NC
                return rf.at[ii].add(v6)
            return jax.lax.fori_loop(0, K, body,
                                     jnp.zeros((NC, 6), jnp.float32))

        t_six = timeit(six_scalar, idx, v) / K
        t_six_s = timeit(six_scalar, idx_sorted, v) / K
        t_comb = timeit(one_combined, idx, v) / K
        t_row = timeit(row6, idx, v6) / K
        print(f"R={R:7d}: 6xscalar {t_six*1e6:8.1f} us  "
              f"(sorted {t_six_s*1e6:8.1f})  combined1 {t_comb*1e6:8.1f}  "
              f"row6 {t_row*1e6:8.1f}   per-row 6x: {t_six/R*1e9:.2f} ns")

    # --- 4: while_loop overhead vs carry size ---
    for R in (96, 98304):
        carry_big = {
            "a": jnp.zeros((R, 3), jnp.float32),
            "b": jnp.zeros((R, 3), jnp.float32),
            "c": jnp.zeros((R, 3), jnp.int32),
            "d": jnp.zeros((R, 4), jnp.float32),
            "e": jnp.zeros((R,), jnp.float32),
            "rf": [jnp.zeros(NC, jnp.float32) for _ in range(6)],
        }

        @jax.jit
        def wl(carry):
            def cond(c):
                return c[1] < 200
            def body(c):
                s, i = c
                s = dict(s)
                s["e"] = s["e"] + 1.0
                return s, i + 1
            s, _ = jax.lax.while_loop(cond, body, (carry, jnp.int32(0)))
            return s["e"]

        t = timeit(wl, carry_big) / 200
        print(f"while trivial body, R={R:6d} + 6 grid bufs in carry: "
              f"{t*1e6:8.1f} us/iter")

        @jax.jit
        def wl_small(e):
            def cond(c):
                return c[1] < 200
            def body(c):
                s, i = c
                return s + 1.0, i + 1
            s, _ = jax.lax.while_loop(cond, body, (e, jnp.int32(0)))
            return s

        t = timeit(wl_small, carry_big["e"]) / 200
        print(f"while trivial body, R={R:6d} scalar-ish carry only:      "
              f"{t*1e6:8.1f} us/iter")

    # --- 5: fori vs while (bounded-trip-count specialization) ---
    e = jnp.zeros((98304,), jnp.float32)

    @jax.jit
    def fl(e):
        def body(i, s):
            return s + 1.0
        return jax.lax.fori_loop(0, 200, body, e)

    t = timeit(fl, e) / 200
    print(f"fori trivial body, R=98304 carry:                    "
          f"{t*1e6:8.1f} us/iter")


if __name__ == "__main__":
    main()
