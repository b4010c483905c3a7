"""Configs of the torch port: the LM substrate's architecture configs
(``base.py`` and the 10 arch presets, copies of the reference's) and
``W2VConfig`` (``w2v.py``, a verbatim copy). Pure dataclasses: importing
this package loads neither torch nor jax."""
from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    InputShape,
    MoEConfig,
    SSMConfig,
    cells,
    get_arch,
    get_smoke,
    list_archs,
)
from repro_torch.configs.w2v import W2VConfig

__all__ = [
    "SHAPES", "ArchConfig", "InputShape", "MoEConfig", "SSMConfig",
    "cells", "get_arch", "get_smoke", "list_archs", "W2VConfig",
]
