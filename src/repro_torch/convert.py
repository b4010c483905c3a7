"""Start the port from the reference's tables.

The reference draws its init with ``jax.random`` and the port with a
``torch.Generator``: the same seed gives different numbers. Handing the
reference's ``TrainState.params()`` over as numpy arrays lets both packages
train from identical tables, which is what parity runs need.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.trainer import TrainState

_REPLICATED = ("w_in", "w_out")
_SPLIT = ("hot_in", "hot_out", "cold_in", "cold_out")


def params_from_reference(params: Mapping[str, np.ndarray],
                          device) -> TrainState:
    """A fresh :class:`TrainState` on ``device`` holding copies of the
    reference's f32 tables (progress counters at zero): the replicated
    tree ``{"w_in", "w_out"}`` or the vocab-sharded split tree
    ``{"hot_in", "hot_out", "cold_in", "cold_out"}``."""
    names = _SPLIT if "hot_in" in params else _REPLICATED
    missing = set(names) - set(params)
    if missing:
        raise ValueError(
            f"params lacks {sorted(missing)}; expected the reference's "
            f"TrainState.params(): {{{', '.join(_REPLICATED)}}} "
            f"(replicated) or {{{', '.join(_SPLIT)}}} (vocab-sharded)")
    arrays = [np.asarray(params[k]) for k in names]
    if any(a.dtype != np.float32 for a in arrays):
        raise ValueError(f"expected float32 tables, got "
                         f"{[str(a.dtype) for a in arrays]}")
    pairs = list(zip(arrays[0::2], arrays[1::2]))   # (in, out) per table
    if any(a.ndim != 2 or a.shape != b.shape for a, b in pairs) or \
            len({a.shape[1] for a in arrays}) != 1:
        raise ValueError(f"expected (rows, d) in/out pairs of one d, got "
                         f"{[a.shape for a in arrays]}")
    put = [torch.tensor(a, dtype=torch.float32, device=device)
           for a in arrays]
    if names == _REPLICATED:
        return TrainState(w_in=put[0], w_out=put[1])
    return TrainState(w_in=put[0], w_out=put[1], cold_in=put[2],
                      cold_out=put[3])
