"""Utilities. Lazy re-exports (PEP 562): importing `utils.cache` to set the
JAX config must not drag in the compute modules — `config.py` imports the
frontend/pipeline stack, which creates jax constants at import and so
initializes the backend."""

_LAZY = {
    "StageTimer": ".timing",
    "TicToc": ".timing",
    "SequenceConfig": ".config",
    "kitti_sequence_config": ".config",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name], __name__), name)
    raise AttributeError(name)
