"""Card-only checks: the f32 paths that the GPU could otherwise run at
reduced precision (TF32 products), compiled for the card and compared
with float64 on the host."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radiativetransfer_tpu.core import rays
from radiativetransfer_tpu.tables import stellar

from reference_impl import quadrature_deposit_serial


@pytest.mark.gpu
def test_quadrature_deposit_f32_on_gpu_matches_f64_oracle(gpu_device):
    pop = stellar.blackbody_population(temperature=1.0e5, q_ionizing=5e48)
    quad_a, quad_w = stellar.quadrature_arrays(pop, 0, 0.0, 0, 0.0)
    quad_w = quad_w / np.abs(quad_w).max()
    rng = np.random.default_rng(7)
    r = 4096
    depth = rng.uniform(0.0, 30.0, (r, 4)) * [1.0, 1.0, 1.0, 0.0]
    dtau = 10.0 ** rng.uniform(-6.0, 0.5, (r, 3))
    args = jax.device_put(
        (jnp.asarray(depth, jnp.float32), jnp.asarray(dtau, jnp.float32),
         jnp.asarray(quad_a, jnp.float32),
         jnp.asarray(quad_w[None], jnp.float32),
         jnp.zeros(r, jnp.int32), jnp.ones(r, jnp.float32)), gpu_device)
    got = jax.jit(rays._deposit_quadrature)(*args)
    assert got[0].devices() == {gpu_device}
    ref = [quadrature_deposit_serial(depth[i], dtau[i], quad_a, quad_w)
           for i in range(r)]
    for k, name in enumerate(("krate24", "krate25", "krate26",
                              "crate24", "crate25", "crate26")):
        want = np.array([x[name] for x in ref])
        have = np.asarray(got[k], np.float64)
        sig = np.abs(want) > 1e-6 * np.abs(want).max()
        np.testing.assert_allclose(have[sig], want[sig], rtol=1e-4)
