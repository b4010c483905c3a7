"""Start the port from the reference's tables (and the LM substrate from
the reference's parameter tree and optimizer state).

The reference draws its init with ``jax.random`` and the port with a
``torch.Generator``: the same seed gives different numbers. Handing the
reference's ``TrainState.params()`` over as numpy arrays lets both packages
train from identical tables, which is what parity runs need. Mixed-
precision states cross with their storage bits: bf16 tables as bf16, int8
cold tails with their f32 scales.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.core.trainer import TrainState, resolve_device
from repro_torch.tree import tree_map

_REPLICATED = ("w_in", "w_out")
_SPLIT = ("hot_in", "hot_out", "cold_in", "cold_out")
_SCALES = ("scale_in", "scale_out")


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    """A copy of one leaf on ``device`` in its storage dtype. A bf16 leaf
    (numpy dtype name ``bfloat16``, from ``ml_dtypes``) crosses as its
    16-bit pattern, without importing ``ml_dtypes``."""
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.tensor(bits, device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_reference(params: Mapping[str, np.ndarray],
                          device, mesh=None) -> TrainState:
    """A fresh :class:`TrainState` on ``device`` holding copies of the
    reference's tables, storage bits unchanged (progress counters at
    zero): the replicated tree ``{"w_in", "w_out"}`` (float32 or
    bfloat16) or the vocab-sharded split tree ``{"hot_in", "hot_out",
    "cold_in", "cold_out"}`` (a float32 or bfloat16 head, a float32,
    bfloat16 or int8 tail; an int8 tail adds ``{"scale_in",
    "scale_out"}``, float32 per-row scales). The split tree of an
    N-device reference session holds the whole shard-major tail
    ``(cold_pad, d)``; under a ``mesh`` of N ranks
    (``repro_torch.launch.mesh.DataMesh``) rank r keeps stripe r, the
    rows of its shard."""
    names = _SPLIT if "hot_in" in params else _REPLICATED
    missing = set(names) - set(params)
    if missing:
        raise ValueError(
            f"params lacks {sorted(missing)}; expected the reference's "
            f"TrainState.params(): {{{', '.join(_REPLICATED)}}} "
            f"(replicated) or {{{', '.join(_SPLIT)}}} (vocab-sharded)")
    arrays = [np.asarray(params[k]) for k in names]
    dts = [a.dtype.name for a in arrays]
    if dts[0] not in ("float32", "bfloat16") or dts[1] != dts[0] or (
            names == _SPLIT and (dts[2] not in ("float32", "bfloat16", "int8")
                                 or dts[3] != dts[2])):
        raise ValueError(
            f"expected float32 or bfloat16 {names[0]}/{names[1]} and a "
            f"float32, bfloat16 or int8 cold pair of one dtype each, got "
            f"{dict(zip(names, dts))}")
    pairs = list(zip(arrays[0::2], arrays[1::2]))   # (in, out) per table
    if any(a.ndim != 2 or a.shape != b.shape for a, b in pairs) or \
            len({a.shape[1] for a in arrays}) != 1:
        raise ValueError(f"expected (rows, d) in/out pairs of one d, got "
                         f"{[a.shape for a in arrays]}")
    if names == _SPLIT and mesh is not None and mesh.size > 1:
        if arrays[2].shape[0] % mesh.size:
            raise ValueError(
                f"a cold tail of {arrays[2].shape[0]} rows does not stripe "
                f"over {mesh.size} ranks")
        cps = arrays[2].shape[0] // mesh.size
        rows = slice(mesh.rank * cps, (mesh.rank + 1) * cps)
        params = {k: (np.asarray(v)[rows] if k in _SPLIT[2:] + _SCALES
                      else v) for k, v in params.items()}
        arrays[2:] = [np.asarray(params[k]) for k in _SPLIT[2:]]
    int8 = names == _SPLIT and dts[2] == "int8"
    if int8 != any(k in params for k in _SCALES):
        raise ValueError(
            f"an int8 cold tail needs its {_SCALES} leaves and no other "
            f"tail takes them; got a {dts[-1]} tail and "
            f"{sorted(k for k in _SCALES if k in params)}")
    put = [_tensor(a, device) for a in arrays]
    if names == _REPLICATED:
        return TrainState(w_in=put[0], w_out=put[1])
    scales = [None, None]
    if int8:
        scales = [np.asarray(params[k]) for k in _SCALES]
        if any(s.dtype != np.float32 or s.shape != (arrays[2].shape[0],)
               for s in scales):
            raise ValueError(
                f"int8 scales must be float32 of shape "
                f"({arrays[2].shape[0]},), got "
                f"{[(s.dtype.name, s.shape) for s in scales]}")
        scales = [_tensor(s, device) for s in scales]
    return TrainState(w_in=put[0], w_out=put[1], cold_in=put[2],
                      cold_out=put[3], scale_in=scales[0],
                      scale_out=scales[1])


_LM_KEYS = {"embed", "blocks", "final_norm"}


def lm_params_from_reference(params: Mapping, device=None) -> dict:
    """The reference's LM parameter tree (``repro.models.lm.init_params``:
    ``embed``, the ``blocks`` tuple of per-position stacks, ``final_norm``
    and ``unembed`` unless tied), given as numpy arrays, as the port's tree
    on ``device`` (the GPU unless the caller asks for the CPU): the same
    keys, shapes and storage bits (a bf16 leaf as its bits). The packages
    draw different numbers from one seed, so parity runs start both from
    this tree."""
    missing = _LM_KEYS - set(params)
    extra = set(params) - _LM_KEYS - {"unembed"}
    if missing or extra:
        raise ValueError(
            f"expected the reference's LM tree {{embed, blocks, final_norm"
            f"[, unembed]}}; missing {sorted(missing)}, unexpected "
            f"{sorted(extra)}")
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(np.asarray(a), device), dict(params))


def adamw_state_from_reference(state, device=None):
    """The reference's ``AdamWState`` (``step``, ``m``, ``v``; jax or
    numpy leaves) as the port's ``repro_torch.train.optim.AdamWState`` on
    ``device`` (the GPU unless the caller asks for the CPU): the step as a
    0-d int32 tensor, the moments as trees of the same keys and bits.
    With ``lm_params_from_reference`` a parity run starts both packages
    from the same parameters and optimizer state."""
    from repro_torch.train.optim import AdamWState

    step, m, v = state
    device = resolve_device(device)
    step = np.asarray(step)
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"expected a scalar int32 step, got "
                         f"{step.dtype} {step.shape}")

    def moments(tree):
        return tree_map(lambda a: _tensor(np.asarray(a), device),
                        tree if isinstance(tree, dict) else dict(tree))

    return AdamWState(step=_tensor(step, device), m=moments(m),
                      v=moments(v))
