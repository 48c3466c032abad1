"""radiativetransfer_tpu — a cosmological radiative-transfer framework
(JAX/XLA rebuild of the FTTE's capabilities).

Public API:

    from radiativetransfer_tpu import RunConfig, RTModel, GridGeometry
    model = RTModel.setup(cfg, geom)
    state = model.initialize_equilibrium(state)
    step = model.make_step()
"""

__version__ = "0.1.0"

from .config import RunConfig, load_config, save_config
from .core.state import FieldState, GridGeometry, make_state, uniform_state

__all__ = [
    "RunConfig", "load_config", "save_config",
    "FieldState", "GridGeometry", "make_state", "uniform_state",
    "RTModel", "StellarContext", "AMRModel", "AMRState",
    "MultiLevelModel", "MultiLevelState",
]


def __getattr__(name):
    # heavier modules import jax at module load; expose them lazily
    if name in ("RTModel", "StellarContext"):
        from .core import step as _step
        return getattr(_step, {"RTModel": "RTModel",
                               "StellarContext": "StellarContext"}[name])
    if name in ("AMRModel", "MultiLevelModel"):
        from .core import step_amr
        return getattr(step_amr, name)
    if name in ("AMRState", "MultiLevelState"):
        from .core import amr
        return getattr(amr, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
