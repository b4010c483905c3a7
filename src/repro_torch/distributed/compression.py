"""Int8 error-feedback gradient/delta compression for cross-node sync.

The port's counterpart of ``repro.distributed.compression``: deltas are
compressed to int8 with one symmetric scale per tensor and an
error-feedback accumulator (the residual re-enters the next round, so the
scheme is unbiased in the long run — standard EF-SGD). Trees are nested
dicts, tuples and lists of tensors; the int8 bytes and scales are the
reference's bit for bit on the same inputs, on the CPU and on the GPU.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_pick


class EFState(NamedTuple):
    residual: Any    # tree like the compressed tree (f32)


def ef_init(tree: Any) -> EFState:
    return EFState(residual=tree_map(
        lambda x: torch.zeros(x.shape, dtype=torch.float32,
                              device=x.device), tree))


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (int8, scale). Symmetric per-tensor scaling, rounding half
    to even. The divisor is a tensor, as in ``kernels.quant.int8_scale``:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which rounds unlike the reference's true division."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(tree: Any, ef: EFState) -> Tuple[Any, Any, EFState]:
    """Returns (quantized tree, scales tree, new EF state).

    The value transmitted is quantize(x + residual); the quantization error
    is carried into the next round's residual."""
    def one(x, r):
        target = x.to(torch.float32) + r
        q, s = quantize(target)
        return q, s, target - dequantize(q, s)

    trip = tree_map(one, tree, ef.residual)
    return (tree_pick(trip, tree, 0), tree_pick(trip, tree, 1),
            EFState(residual=tree_pick(trip, tree, 2)))


def decompress_tree(qtree: Any, stree: Any) -> Any:
    return tree_map(dequantize, qtree, stree)


def compressed_mean_bytes(tree: Any) -> Tuple[int, int]:
    """(raw f32 bytes, compressed bytes) — reported by benchmarks."""
    leaves = tree_leaves(tree)
    raw = sum(x.numel() * 4 for x in leaves)
    comp = sum(x.numel() * 1 + 4 for x in leaves)
    return raw, comp
