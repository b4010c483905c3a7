"""SGNS window math, the training session and quality metrics (torch).

sgns.py      — canonical shared-negative window math
window.py    — ring-buffer lifetime state machine (reference + analysis)
baselines.py — accSGNS-like / pWord2Vec-like comparison implementations
trainer.py   — streaming ``TrainSession``: LR decay, Hogwild mesh
               averaging, checkpoint/resume, metrics callbacks
quality.py   — planted-cluster embedding quality metrics (numpy copy)

The reference's exports, each imported with its module on first use.
"""
import importlib

_EXPORTS = {
    "pair_delta": "repro_torch.core.sgns",
    "stable_sigmoid": "repro_torch.core.sgns",
    "window_delta": "repro_torch.core.sgns",
    "StepMetrics": "repro_torch.core.trainer",
    "TrainSession": "repro_torch.core.trainer",
    "TrainState": "repro_torch.core.trainer",
    "W2VTrainer": "repro_torch.core.trainer",
    "init_state": "repro_torch.core.trainer",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    """Import the module that defines an exported name on its first use."""
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value
