"""Training of the torch port: checkpoints with exact resume
(``checkpoint``), recovery primitives (``resilience``), the supervised
loop (``supervisor``), deterministic fault schedules (``chaos``), and the
LM substrate's AdamW (``optim``) and training loop (``loop``). Each is
imported by name, and the reference's exports (AdamW's) with their module
on first use, so that this package's import stays torch-free."""
import importlib

_EXPORTS = {
    "AdamWConfig": "repro_torch.train.optim",
    "AdamWState": "repro_torch.train.optim",
    "adamw_init": "repro_torch.train.optim",
    "adamw_update": "repro_torch.train.optim",
    "lr_schedule": "repro_torch.train.optim",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    """Import the module that defines an exported name on its first use."""
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value
