"""Two-level nested (AMR) grid support.

The reference's fully-threaded octree supports arbitrary nesting; this
design replaces pointer-walking with LEVEL-DENSE fields
(SURVEY.md §7.1): the base level is a dense (n,n,n) grid, the refinement
level a dense (2n,2n,2n) grid valid only where the parent bitmap is set.
Fully-threaded semantics (cross-level neighbor access) become restrict /
prolong operators and masked shifts.

Memory note: the fine level is allocated densely over the whole domain
(8x the base) for static shapes; deeper hierarchies use the block-sparse
storage of core.amr_sparse.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import MH, MHE, PSI
from .state import FieldState, GridGeometry, make_state


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AMRState:
    """Two-level nested state.

    base: FieldState on (n,n,n); fine: FieldState on (2n,2n,2n);
    refined: (n,n,n) bool — where the fine level is valid.
    Base cells under refined regions hold the restriction (average) of
    their children, mirroring the reference's parent-copy semantics
    (placeCellProjectWithVelocity, equiSources.f90:1884-1909).
    """
    base: FieldState
    fine: FieldState
    refined: jax.Array

    @property
    def n(self) -> int:
        return self.base.rho.shape[0]

    def leaf_mask_base(self) -> jax.Array:
        return ~self.refined

    def leaf_mask_fine(self) -> jax.Array:
        return prolong_mask(self.refined)

    def n_leaves(self) -> int:
        nb = int(jnp.sum(~self.refined))
        nf = 8 * int(jnp.sum(self.refined))
        return nb + nf


def restrict(fine_field: jax.Array) -> jax.Array:
    """Average 2x2x2 children onto the parent grid."""
    n2 = fine_field.shape[0]
    n = n2 // 2
    return fine_field.reshape(n, 2, n, 2, n, 2).mean(axis=(1, 3, 5))


def prolong(base_field: jax.Array) -> jax.Array:
    """Copy parents into their 2x2x2 children (the reference's refine-time
    copy, equiSources.f90:1892-1896)."""
    return jnp.repeat(jnp.repeat(jnp.repeat(base_field, 2, 0), 2, 1), 2, 2)


def prolong_mask(refined: jax.Array) -> jax.Array:
    return prolong(refined)


def make_amr_state(base: FieldState, refined, fine: FieldState | None = None
                   ) -> AMRState:
    """Build an AMRState; absent fine data is prolonged from the base."""
    refined = jnp.asarray(refined, bool)
    if fine is None:
        fine = jax.tree_util.tree_map(
            lambda x: (prolong(x) if x.ndim == 3 else
                       jnp.stack([prolong(x[i]) for i in range(x.shape[0])])),
            base)
    return AMRState(base=base, fine=fine, refined=refined)


def sync_restriction(state: AMRState) -> AMRState:
    """Write the restriction of fine leaves into their base parents so
    base-level fields are consistent for diagnostics and coarse transport."""
    def rs(b, f):
        if b.ndim == 3:
            return jnp.where(state.refined, restrict(f), b)
        return jnp.stack([jnp.where(state.refined, restrict(f[i]), b[i])
                          for i in range(b.shape[0])])
    base = jax.tree_util.tree_map(rs, state.base, state.fine)
    return dataclasses.replace(state, base=base)


# ---------------------------------------------------------------------------
# L-level nested grids (VERDICT r1 item 7)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MultiLevelState:
    """L-level nested state: level l is a dense FieldState on (n*2^l)^3.

    refined[l] (l = 0..L-2) marks level-l cells refined into level l+1;
    properly nested (refined[l] implies all ancestors refined) and 2:1
    face-balanced (enforce_balance).  The reference's fully-threaded octree
    (definitionsModule.f90:163-180, insertion recursion
    equiSources.f90:1870-1974) nests arbitrarily deep; this is its dense
    per-level analog (SURVEY.md §7.1).
    """
    levels: tuple
    refined: tuple

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def n(self) -> int:
        return self.levels[0].rho.shape[0]

    def cover_masks(self):
        """cover[l]: the cell exists at level l (all ancestors refined)."""
        masks = [jnp.ones(self.levels[0].rho.shape, bool)]
        for r in self.refined:
            masks.append(prolong(r & masks[-1]))
        return masks

    def leaf_masks(self):
        cover = self.cover_masks()
        out = []
        for ell, c in enumerate(cover):
            if ell < len(self.refined):
                out.append(c & ~self.refined[ell])
            else:
                out.append(c)
        return out

    def n_leaves(self) -> int:
        return sum(int(jnp.sum(m)) for m in self.leaf_masks())


def _dilate_faces(mask: np.ndarray) -> np.ndarray:
    """6-neighborhood (face) dilation of a bool volume."""
    out = mask.copy()
    for ax in range(3):
        out |= np.roll(mask, 1, ax) & (np.arange(mask.shape[ax]) != 0
                                       ).reshape([-1 if a == ax else 1
                                                  for a in range(3)])
        out |= np.roll(mask, -1, ax) & (np.arange(mask.shape[ax])
                                        != mask.shape[ax] - 1
                                        ).reshape([-1 if a == ax else 1
                                                   for a in range(3)])
    return out


def restrict_any(mask: np.ndarray) -> np.ndarray:
    n = mask.shape[0] // 2
    return mask.reshape(n, 2, n, 2, n, 2).any(axis=(1, 3, 5))


def enforce_balance(refined: list[np.ndarray]) -> list[np.ndarray]:
    """Make refinement maps properly nested and 2:1 face-balanced.

    Where a level-(l+1) refined cell's face neighbor would jump two levels,
    the neighbor's parent is refined too (its children fill by prolongation,
    the reference's refine-time parent copy, equiSources.f90:1892-1896).
    """
    refined = [np.asarray(r, bool).copy() for r in refined]
    for ell in range(len(refined) - 1, 0, -1):
        # proper nesting: a refined cell must itself be covered
        refined[ell - 1] |= restrict_any(refined[ell])
        # 2:1 face balance: face neighbors of refined cells must exist
        refined[ell - 1] |= restrict_any(_dilate_faces(refined[ell]))
    return refined


def check_balance(refined) -> bool:
    refined = [np.asarray(r, bool) for r in refined]
    for ell in range(1, len(refined)):
        need = restrict_any(_dilate_faces(refined[ell]))
        if not np.all(refined[ell - 1] | ~need):
            return False
    return True


def make_multilevel_state(base: FieldState, refined,
                          fines: list[FieldState] | None = None
                          ) -> MultiLevelState:
    """Build an L-level state; absent fine data prolongs from the base."""
    refined = tuple(jnp.asarray(r, bool) for r in refined)
    levels = [base]
    for ell in range(len(refined)):
        if fines is not None and ell < len(fines):
            levels.append(fines[ell])
        else:
            levels.append(jax.tree_util.tree_map(
                lambda x: (prolong(x) if x.ndim == 3 else
                           jnp.stack([prolong(x[i])
                                      for i in range(x.shape[0])])),
                levels[-1]))
    return MultiLevelState(levels=tuple(levels), refined=refined)


def sync_restriction_multi(state: MultiLevelState) -> MultiLevelState:
    """Propagate fine-leaf restrictions down to every coarser ancestor."""
    levels = list(state.levels)
    for ell in range(len(levels) - 2, -1, -1):
        r = state.refined[ell]

        def rs(b, f):
            if b.ndim == 3:
                return jnp.where(r, restrict(f), b)
            return jnp.stack([jnp.where(r, restrict(f[i]), b[i])
                              for i in range(b.shape[0])])
        levels[ell] = jax.tree_util.tree_map(rs, levels[ell], levels[ell + 1])
    return MultiLevelState(levels=tuple(levels), refined=state.refined)


def multilevel_from_levels(level_lists, read_metals: bool, dtype=None,
                           smooth_metals: bool = True, max_depth: int = 4):
    """MultiLevelState from ingested level lists, keeping every level up to
    max_depth dense (deeper ones conservatively averaged onto the deepest
    kept level).  Replaces the two-level amr_from_levels averaging for
    >=3-level reference grids (equiSources.f90:580-618)."""
    from ..io import grid_io
    dtype = dtype or jnp.float32
    level_lists, box = grid_io.normalize_coordinates(level_lists)
    n = round(level_lists[0].ncell ** (1.0 / 3.0))
    geom = GridGeometry(n, n, n, box)
    depth = min(len(level_lists), max_depth)

    dense = [grid_io.levels_to_dense(level_lists[:1], n, read_metals)]
    for ell in range(1, depth):
        n_ell = n * 2 ** ell
        # the deepest kept level absorbs (averages) anything deeper
        lists = level_lists[ell:] if ell == depth - 1 else level_lists[ell:ell + 1]
        dense.append(grid_io.levels_to_dense(
            [grid_io.LevelData(pos=lv.pos, lT=lv.lT, lnH=lv.lnH, lx=lv.lx,
                               vel=lv.vel, abun=lv.abun) for lv in lists],
            n_ell, read_metals))

    refined = []
    for ell in range(1, depth):
        n_par = n * 2 ** (ell - 1)
        r = np.zeros((n_par, n_par, n_par), bool)
        idx = np.clip((level_lists[ell].pos * n_par).astype(int), 0, n_par - 1)
        r[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        refined.append(r)
    refined = enforce_balance(refined)

    has_vel = any("velx" in d for d in dense)
    states = []
    for ell in range(depth):
        d = dense[ell]
        abun2 = d["abun2"]
        if ell == 0 and read_metals and smooth_metals:
            abun2 = grid_io.smooth_metallicity(abun2)
        keys = ["nh", "tgas", "xneu", "abun2"]
        if has_vel:
            keys += ["velx", "vely", "velz"]
            for k in ("velx", "vely", "velz"):
                d.setdefault(k, np.zeros_like(d["nh"]))
        if ell > 0:
            # fill cells without data (unrefined regions + balance-added
            # refinement) by prolongation from the level below; kinematics
            # prolong with the rest (placeCellProjectWithVelocity,
            # equiSources.f90:1870-1974 carries vel at every level)
            pb = {k: np.repeat(np.repeat(np.repeat(
                filled_prev[k], 2, 0), 2, 1), 2, 2) for k in keys}
            got = d["nh"] > 0
            d = {k: np.where(d[k] > 0 if k not in ("abun2", "velx", "vely",
                                                   "velz") else got,
                             d[k], pb[k]) for k in pb}
            abun2 = d["abun2"]
        filled_prev = {k: (abun2 if k == "abun2" else d[k]) for k in keys}
        vel = (np.stack([d["velx"], d["vely"], d["velz"]])
               if has_vel else None)
        states.append(make_state(d["nh"] * MH / PSI, d["tgas"],
                                 d["nh"] * d["xneu"], abun2=abun2,
                                 dtype=dtype, vel=vel))

    state = MultiLevelState(levels=tuple(states),
                            refined=tuple(jnp.asarray(r) for r in refined))
    return sync_restriction_multi(state), geom


def two_level_view(state: MultiLevelState) -> AMRState:
    """The L=2 special case as an AMRState (for the optimized 2-level path)."""
    assert state.n_levels == 2
    return AMRState(base=state.levels[0], fine=state.levels[1],
                    refined=state.refined[0])


def amr_from_levels(levels, read_metals: bool, dtype=None,
                    smooth_metals: bool = True):
    """Two-level AMRState from ingested level lists (grid construction,
    equiSources.f90:580-618).

    Level-1 cells define the base grid; level-2 cells mark their parents
    refined and fill the fine grid (deeper levels are conservatively
    averaged onto level 2 until deeper dense levels land).
    """
    import jax.numpy as jnp
    from ..io import grid_io
    dtype = dtype or jnp.float32
    levels, box = grid_io.normalize_coordinates(levels)
    n = round(levels[0].ncell ** (1.0 / 3.0))
    geom = GridGeometry(n, n, n, box)

    base_dense = grid_io.levels_to_dense(levels[:1], n, read_metals)
    abun2 = base_dense["abun2"]
    if read_metals and smooth_metals:
        abun2 = grid_io.smooth_metallicity(abun2)
    has_vel = "velx" in base_dense
    vel0 = (np.stack([base_dense["velx"], base_dense["vely"],
                      base_dense["velz"]]) if has_vel else None)
    base = make_state(base_dense["nh"] * MH / PSI, base_dense["tgas"],
                      base_dense["nh"] * base_dense["xneu"],
                      abun2=abun2, dtype=dtype, vel=vel0)

    refined = np.zeros((n, n, n), bool)
    if len(levels) > 1 and levels[1].ncell > 0:
        fine_dense = grid_io.levels_to_dense(
            [grid_io.LevelData(pos=lv.pos, lT=lv.lT, lnH=lv.lnH, lx=lv.lx,
                               vel=lv.vel, abun=lv.abun)
             for lv in levels[1:]], 2 * n, read_metals)
        idx = np.clip((levels[1].pos * n).astype(int), 0, n - 1)
        refined[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        # fill unrefined fine regions by prolongation so the dense fine
        # fields are everywhere defined
        filled = {}
        ref_f = np.repeat(np.repeat(np.repeat(refined, 2, 0), 2, 1), 2, 2)
        keys = ["nh", "tgas", "xneu", "abun2"]
        if has_vel:
            keys += ["velx", "vely", "velz"]
            for k in ("velx", "vely", "velz"):
                fine_dense.setdefault(k, np.zeros_like(fine_dense["nh"]))
        got_f = fine_dense["nh"] > 0
        for k in keys:
            pb = np.repeat(np.repeat(np.repeat(base_dense.get(
                k, np.zeros_like(base_dense["nh"])), 2, 0), 2, 1), 2, 2)
            mask = (fine_dense[k] > 0 if k not in ("abun2", "velx", "vely",
                                                   "velz") else got_f)
            filled[k] = np.where(ref_f & mask, fine_dense[k], pb)
        velf = (np.stack([filled["velx"], filled["vely"], filled["velz"]])
                if has_vel else None)
        fine = make_state(filled["nh"] * MH / PSI, filled["tgas"],
                          filled["nh"] * filled["xneu"],
                          abun2=filled["abun2"], dtype=dtype, vel=velf)
    else:
        fine = None

    state = make_amr_state(base, jnp.asarray(refined), fine)
    return sync_restriction(state), geom
