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


def params_from_reference(params: Mapping[str, np.ndarray],
                          device) -> TrainState:
    """A fresh :class:`TrainState` on ``device`` holding copies of the
    reference's replicated f32 tables ``{"w_in", "w_out"}`` (progress
    counters at zero)."""
    missing = {"w_in", "w_out"} - set(params)
    if missing:
        raise ValueError(
            f"params lacks {sorted(missing)}; expected the reference's "
            f"replicated TrainState.params() (vocab-sharded tables arrive "
            f"with a later slice of the torch port)")
    w_in, w_out = (np.asarray(params[k]) for k in ("w_in", "w_out"))
    if w_in.dtype != np.float32 or w_out.dtype != np.float32:
        raise ValueError(f"expected float32 tables, got {w_in.dtype} and "
                         f"{w_out.dtype}")
    if w_in.ndim != 2 or w_in.shape != w_out.shape:
        raise ValueError(f"expected two (V, d) tables, got {w_in.shape} and "
                         f"{w_out.shape}")
    return TrainState(
        w_in=torch.tensor(w_in, dtype=torch.float32, device=device),
        w_out=torch.tensor(w_out, dtype=torch.float32, device=device))
