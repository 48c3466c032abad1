"""Dense field state for the transport + chemistry solve.

The reference stores per-cell physics in a pointer octree (zoneType,
/root/reference/definitionsModule.f90:163-180).  This design keeps
level-dense arrays: a uniform base level (nx, ny, nz) plus optional refined
levels (added in the AMR extension).  All fields are JAX arrays registered as
a pytree so the full state flows through jit/shard_map.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import MH, MHE, PSI


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FieldState:
    """Prognostic + diagnostic fields on a uniform (nx, ny, nz) grid.

    Number densities in cm^-3, temperature in K, rho in g/cm^3.
    krate* are photoionization counts per cell [1/s] from point sources
    (converted to per-particle rates in the chemistry step); crate* are the
    matching heating rates [erg/s].  Jmean* are the angle-averaged mean
    intensities of the three diffuse bands [erg/cm^2/s/Hz/sr].
    """
    rho: jax.Array
    tgas: jax.Array
    HI: jax.Array
    HeI: jax.Array
    HeII: jax.Array
    abun2: jax.Array       # oxygen (metallicity) abundance, dust scaling
    krate24: jax.Array
    krate25: jax.Array
    krate26: jax.Array
    crate24: jax.Array
    crate25: jax.Array
    crate26: jax.Array
    Jmean: jax.Array       # (3, nx, ny, nz)
    hydroHeating: jax.Array
    # Optional kinematics (velx/y/z), carried for I/O round-trips exactly as
    # the reference does (placeCellProjectWithVelocity,
    # equiSources.f90:1870-1974; writeIonization :4869-4890): transport and
    # chemistry never read it.  None when the grid has no velocity data.
    vel: jax.Array | None = None    # (3, nx, ny, nz) [km/s] or None

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.rho.shape

    @property
    def nh(self) -> jax.Array:
        """Total hydrogen number density [cm^-3] (psi*rho/mh)."""
        return PSI * self.rho / MH

    @property
    def nhe(self) -> jax.Array:
        """Total helium number density [cm^-3]."""
        return (1.0 - PSI) * self.rho / MHE

    def zero_rates(self) -> "FieldState":
        """Reset per-iteration accumulators (setZeroRates,
        equiSources.f90:4128-4155)."""
        z = jnp.zeros_like(self.krate24)
        return dataclasses.replace(
            self, krate24=z, krate25=z, krate26=z,
            crate24=z, crate25=z, crate26=z)


def make_state(rho, tgas, HI, HeI=None, HeII=None, abun2=None,
               dtype=jnp.float32, vel=None) -> FieldState:
    """Build a FieldState from density/temperature/neutral-H arrays.

    Helium defaults to fully neutral, matching grid ingestion
    (placeCellProjectWithVelocity, equiSources.f90:1941-1943); abun2 defaults
    to 0.02 (equiSources.f90:1958).
    """
    rho = jnp.asarray(rho, dtype)
    shape = rho.shape
    nhe = (1.0 - PSI) * rho / MHE
    if HeI is None:
        HeI = nhe
    if HeII is None:
        HeII = jnp.zeros(shape, dtype)
    if abun2 is None:
        abun2 = jnp.full(shape, 0.02, dtype)
    z = jnp.zeros(shape, dtype)
    return FieldState(
        rho=rho, tgas=jnp.asarray(tgas, dtype), HI=jnp.asarray(HI, dtype),
        HeI=jnp.asarray(HeI, dtype), HeII=jnp.asarray(HeII, dtype),
        abun2=jnp.asarray(abun2, dtype),
        krate24=z, krate25=z, krate26=z, crate24=z, crate25=z, crate26=z,
        Jmean=jnp.zeros((3,) + shape, dtype), hydroHeating=z,
        vel=None if vel is None else jnp.asarray(vel, dtype))


def uniform_state(n: int, nh: float = 1.0e-3, tgas: float = 1.0e4,
                  x_neutral: float = 1.0, dtype=jnp.float32) -> FieldState:
    """Uniform test box: hydrogen number density nh [cm^-3]."""
    shape = (n, n, n)
    rho = np.full(shape, nh * MH / PSI)
    return make_state(rho, np.full(shape, tgas),
                      np.full(shape, nh * x_neutral), dtype=dtype)


@dataclasses.dataclass(frozen=True)
class GridGeometry:
    """Static geometry of the base grid."""
    nx: int
    ny: int
    nz: int
    physical_box_size: float   # [cm]

    @property
    def cell_size(self) -> float:
        """Base-cell size [cm] (cellSizeAbsoluteUnits, equiSources.f90:1570)."""
        return self.physical_box_size / self.nx

    @property
    def cell_volume(self) -> float:
        return self.cell_size ** 3
