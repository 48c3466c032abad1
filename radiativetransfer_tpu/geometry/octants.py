"""Folding sweep directions into the 24 octant-orientation zones and the
corresponding dense-array axis transforms.

The reference walks the octree with per-zone index rotation
(/root/reference/rotateIndicesModule.f90:7-113) driven by the folding logic
at equiSources.f90:1395-1454.  On dense fields the 24 index rotations become
pure transpose+flip views, so the sweep kernel always runs in a canonical
orientation: sweep slabs advance along array axis 0 (the direction's dominant
component), the xz-ray upwind neighbor is at axis1-1, and the yz-ray upwind
neighbor is at axis2-1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..constants import HALF_PI, PI

# Per-zone (1-based izone -> (q, flips)):
#   q[a]     = transfer axis (0-based) read by grid axis a, i.e.
#              grid_index[a] = transfer_index[q[a]] (possibly flipped);
#   flips[a] = grid axes with reversed order (the "n+1-i" cases).
# Derived from rotateIndicesModule.f90:14-111.
_ZONE_TABLE: dict[int, tuple[tuple[int, int, int], tuple[int, ...]]] = {
    1: ((0, 1, 2), ()),
    2: ((1, 2, 0), ()),
    3: ((2, 0, 1), ()),
    4: ((0, 2, 1), (2,)),
    5: ((1, 0, 2), (2,)),
    6: ((2, 1, 0), (2,)),
    7: ((0, 1, 2), (1, 2)),
    8: ((1, 2, 0), (1, 2)),
    9: ((2, 0, 1), (1, 2)),
    10: ((0, 2, 1), (1,)),
    11: ((1, 0, 2), (1,)),
    12: ((2, 1, 0), (1,)),
    13: ((0, 1, 2), (0,)),
    14: ((1, 2, 0), (0,)),
    15: ((2, 0, 1), (0,)),
    16: ((0, 2, 1), (0, 2)),
    17: ((1, 0, 2), (0, 2)),
    18: ((2, 1, 0), (0, 2)),
    19: ((0, 1, 2), (0, 1, 2)),
    20: ((1, 2, 0), (0, 1, 2)),
    21: ((2, 0, 1), (0, 1, 2)),
    22: ((0, 2, 1), (0, 1)),
    23: ((1, 0, 2), (0, 1)),
    24: ((2, 1, 0), (0, 1)),
}


def rotate_indices(i: int, j: int, k: int, nx: int, ny: int, nz: int,
                   izone: int) -> tuple[int, int, int]:
    """Scalar 1-based index rotation, exact port of rotateIndices
    (rotateIndicesModule.f90:7-113).  Used for testing and AMR addressing."""
    q, flips = _ZONE_TABLE[izone]
    t = (i, j, k)
    n = (nx, ny, nz)
    out = []
    for a in range(3):
        v = t[q[a]]
        if a in flips:
            v = n[a] + 1 - v
        out.append(v)
    return tuple(out)


def transfer_shape(nx: int, ny: int, nz: int, izone: int) -> tuple[int, int, int]:
    """Rotated (nxtransfer, nytransfer, nztransfer) (equiSources.f90:1458-1483)."""
    q, _ = _ZONE_TABLE[izone]
    n = (nx, ny, nz)
    # transfer axis t has extent of the grid axis that reads it
    shape = [0, 0, 0]
    for a in range(3):
        shape[q[a]] = n[a]
    return tuple(shape)


def rotate_to_sweep(field, izone: int):
    """View of a (nx,ny,nz[,...]) grid field in sweep (transfer) orientation.

    Result R satisfies R[i-1,j-1,k-1] = field[rotate_indices(i,j,k)-1].
    Works on NumPy or JAX arrays; trailing axes beyond the first three are
    untouched.
    """
    import jax.numpy as jnp
    xp = jnp if not isinstance(field, np.ndarray) else np
    q, flips = _ZONE_TABLE[izone]
    for a in flips:
        field = xp.flip(field, axis=a)
    # G[t] = F_flipped[t[q[0]], t[q[1]], t[q[2]]]  ->  axes = inverse perm of q
    inv = [0, 0, 0]
    for a in range(3):
        inv[q[a]] = a
    ndim = field.ndim
    axes = tuple(inv) + tuple(range(3, ndim))
    return xp.transpose(field, axes)


def rotate_from_sweep(field, izone: int):
    """Inverse of rotate_to_sweep."""
    import jax.numpy as jnp
    xp = jnp if not isinstance(field, np.ndarray) else np
    q, flips = _ZONE_TABLE[izone]
    ndim = field.ndim
    axes = tuple(q) + tuple(range(3, ndim))
    field = xp.transpose(field, axes)
    for a in flips:
        field = xp.flip(field, axis=a)
    return field


def rotate_blocks_to_sweep(x, izone: int):
    """rotate_to_sweep applied to the LAST three axes (per-block data).

    For block-sparse levels whose block edge divides the grid edge, rotating
    the dense volume factors exactly into (a) rotate_to_sweep of the
    tile->slot volume and (b) this within-block transform of the block data
    — the flips reverse both the tile index and the in-block offset, and the
    transpose permutes both jointly.
    """
    import jax.numpy as jnp
    xp = jnp if not isinstance(x, np.ndarray) else np
    q, flips = _ZONE_TABLE[izone]
    off = x.ndim - 3
    for a in flips:
        x = xp.flip(x, axis=off + a)
    inv = [0, 0, 0]
    for a in range(3):
        inv[q[a]] = a
    axes = tuple(range(off)) + tuple(off + i for i in inv)
    return xp.transpose(x, axes)


def rotate_blocks_from_sweep(x, izone: int):
    """Inverse of rotate_blocks_to_sweep (last three axes)."""
    import jax.numpy as jnp
    xp = jnp if not isinstance(x, np.ndarray) else np
    q, flips = _ZONE_TABLE[izone]
    off = x.ndim - 3
    axes = tuple(range(off)) + tuple(off + a for a in q)
    x = xp.transpose(x, axes)
    for a in flips:
        x = xp.flip(x, axis=off + a)
    return x


@dataclasses.dataclass(frozen=True)
class FoldedDirection:
    """A sweep direction folded into the canonical octant."""
    izone: int        # 1..24
    phi: float        # in (0, pi/2)
    theta: float      # in (0, pi/2); sin(theta) is the dominant cosine
    phi_raw: float    # original angles before folding
    theta_raw: float


def fold_direction(phi_large: float, theta_large: float) -> FoldedDirection:
    """Fold a direction into zone 1..24 with local (phi, theta).

    Exact port of the folding logic at equiSources.f90:1395-1454:
    quadrant of phi contributes {0,3,6,9}, sign of theta contributes {0,12},
    and the dominant-axis permutation contributes {0,1,2}.
    """
    izone = 1
    if 0.0 < phi_large < 0.5 * PI:
        phi1 = phi_large
    elif 0.5 * PI < phi_large < PI:
        phi1 = phi_large - 0.5 * PI
        izone += 3
    elif PI < phi_large < 1.5 * PI:
        phi1 = phi_large - PI
        izone += 6
    elif 1.5 * PI < phi_large < 2.0 * PI:
        phi1 = phi_large - 1.5 * PI
        izone += 9
    else:
        raise ValueError(f"phi on an octant boundary: {phi_large}")

    if 0.0 < theta_large < 0.5 * PI:
        theta1 = theta_large
    elif -0.5 * PI < theta_large < 0.0:
        theta1 = -theta_large
        izone += 12
    else:
        raise ValueError(f"theta on an octant boundary: {theta_large}")

    tmp1 = 1.0 / np.sin(theta1)
    tmp2 = 1.0 / (np.cos(phi1) * np.cos(theta1))
    tmp3 = 1.0 / (np.sin(phi1) * np.cos(theta1))

    if tmp1 < min(tmp2, tmp3):
        theta, phi = theta1, phi1
    elif tmp2 < min(tmp1, tmp3):
        theta = np.arcsin(min(np.cos(theta1) * np.cos(phi1), 1.0))
        phi = np.arcsin(min(np.sin(theta1) / np.cos(theta), 1.0))
        izone += 1
    else:
        theta = np.arcsin(min(np.cos(theta1) * np.sin(phi1), 1.0))
        phi = np.arccos(min(np.sin(theta1) / np.cos(theta), 1.0))
        izone += 2

    return FoldedDirection(izone=int(izone), phi=float(phi), theta=float(theta),
                           phi_raw=float(phi_large), theta_raw=float(theta_large))


def fold_all(phis: np.ndarray, thetas: np.ndarray) -> list[FoldedDirection]:
    return [fold_direction(p, t) for p, t in zip(phis, thetas)]


def group_by_zone(dirs: list[FoldedDirection]) -> dict[int, list[FoldedDirection]]:
    """Directions grouped by zone; the sweep batches each group with a single
    field transpose (the batched analog of the per-direction rotateIndices walk)."""
    groups: dict[int, list[FoldedDirection]] = {}
    for d in dirs:
        groups.setdefault(d.izone, []).append(d)
    return groups
