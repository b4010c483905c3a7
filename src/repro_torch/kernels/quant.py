"""Quantized table storage primitives (DESIGN.md §11).

The port's counterpart of ``repro.kernels.quant``: the same storage codecs
with the same bits. ``bfloat16`` halves and ``int8`` (per-row absmax
scales) quarters the bytes of a table row, while the update math stays
f32. Two rounding modes, at different seams:

* **Nearest** (deterministic): initialization, checkpoint restore and the
  transport leg of the exact exchange's write-back.
* **Stochastic** (keyed): the storage seam after each update. The noise
  comes from ``jax.random``'s threefry2x32 stream, rebuilt here in torch
  (:func:`bits`, :func:`uniform`, :func:`fold_in`), so a key gives the
  reference's noise bit for bit and both packages store the same bytes for
  the same f32 values.

Keys are host values: :func:`round_key` derives a batch's ``uint32[2]``
key from ``(seed, epoch, batch_index)`` with numpy, and :func:`fold_in`
runs threefry on Python ints, so keying a step costs no device sync. Only
the counter stream over a table's shape runs on the table's device, in
int64 tensors masked to 32 bits (torch's ``uint32`` covers few ops), in
chunks that bound its temporaries.

int8 rows carry a per-row f32 scale ``max|row| / 127``; the row's absmax
element encodes to exactly ±127 (``floor(127 + u) = 127`` for ``u`` in
[0, 1)), so decode → re-encode of an untouched row is a fixed point.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

# domain-separation tags, disjoint from data/batching.py's subsample
# (0x5B5A) and negatives (0x4E45) tags
_ROUND_TAG = 0x5254          # "RT" — round-to-storage key family
TAG_HOT_IN, TAG_HOT_OUT = 0, 1
TAG_COLD_IN, TAG_COLD_OUT = 2, 3
TAG_FULL_IN, TAG_FULL_OUT = 4, 5     # master-copy / replicated full tables

STORAGE_DTYPES = ("float32", "bfloat16", "int8")
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# int64 temporaries of the counter stream stay under ~1 GB per chunk
# (about six tensors of 8 bytes an element live at once)
_CHUNK = 1 << 24

Key = Tuple[int, int]


def round_key(seed: int, epoch: int, batch_index: int) -> np.ndarray:
    """uint32[2] threefry key for one batch's storage rounding — a pure
    function of the same counters that key subsampling and negatives, so
    the rounding noise replays bit-identically across worker counts and
    recoveries."""
    ss = np.random.SeedSequence([seed, _ROUND_TAG, epoch, batch_index])
    return ss.generate_state(2, np.uint32)


def _key(key) -> Key:
    """A key as two Python ints (from a ``uint32[2]`` array or a pair)."""
    k0, k1 = (int(k) for k in key)
    return k0 & _M32, k1 & _M32


# ---------------------------------------------------------------------------
# threefry2x32, as jax.random runs it (jax_threefry_partitionable)
# ---------------------------------------------------------------------------

def _threefry2x32(key: Key, x0, x1):
    """The 20-round threefry2x32 block on counter words ``(x0, x1)``:
    Python ints or int64 tensors holding values below 2**32."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key, data: int) -> Key:
    """``jax.random.fold_in``: threefry of the counter ``(0, data)``, both
    output words kept as the new key. Host-side, on Python ints."""
    return _threefry2x32(_key(key), 0, int(data) & _M32)


def bits(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in
    [0, 2**32): element ``j`` of the flattened shape is ``out0 ^ out1`` of
    threefry on the counter ``(j >> 32, j & 0xFFFFFFFF)``."""
    key = _key(key)
    n = int(np.prod(shape, dtype=np.int64))
    out = torch.empty(n, dtype=torch.int64, device=device)
    for start in range(0, n, _CHUNK):
        j = torch.arange(start, min(n, start + _CHUNK), dtype=torch.int64,
                         device=device)
        y0, y1 = _threefry2x32(key, j >> 32, j & _M32)
        out[start:start + j.numel()] = y0 ^ y1
    return out.view(tuple(shape))


def uniform(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): the top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    b = (bits(key, shape, device) >> 9) | 0x3F800000
    return torch.clamp_min(b.to(torch.int32).view(torch.float32) - 1.0, 0.0)


# ---------------------------------------------------------------------------
# bfloat16: truncate-with-random-carry stochastic rounding
# ---------------------------------------------------------------------------

def bf16_nearest(x: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even f32 → bf16 (init / restore / transport)."""
    return x.to(torch.bfloat16)


def bf16_stochastic(x: torch.Tensor, key) -> torch.Tensor:
    """Stochastically round f32 → bf16: add uniform noise to the 16 bits
    about to be truncated, then truncate. P(round up) equals the truncated
    fraction, so E[result] = x; values exact in bf16 (low bits zero) stay
    fixed. The sum wraps mod 2**32, as the reference's uint32 sum does."""
    x = x.to(torch.float32).contiguous()
    f = x.view(torch.int32).to(torch.int64) & _M32
    noise = bits(key, x.shape, x.device) & 0xFFFF
    hi = ((f + noise) & _M32) >> 16
    hi = torch.where(hi >= 0x8000, hi - 0x10000, hi)      # uint16 -> int16
    return hi.to(torch.int16).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# int8 with per-row scales
# ---------------------------------------------------------------------------

def int8_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row absmax scale ``max|row| / 127`` (all-zero rows get 1.0 so
    decode stays a plain multiply)."""
    amax = x.abs().amax(dim=-1)
    # the divisor is a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds unlike the reference's
    # (and the CPU's) true division
    scale = amax / torch.full_like(amax, 127.0)
    return torch.where(amax > 0, scale,
                       torch.ones_like(amax)).to(torch.float32)


def int8_nearest(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic f32 → (int8, scale) encode, round half to even."""
    if scale is None:
        scale = int8_scale(x)
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def int8_stochastic(x: torch.Tensor, key,
                    scale: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic f32 → (int8, scale) encode: ``floor(x/scale + u)`` with
    ``u ~ U[0, 1)`` rounds up with probability equal to the fractional
    part — unbiased in expectation over keyed draws."""
    if scale is None:
        scale = int8_scale(x)
    u = uniform(key, x.shape, x.device)
    q = torch.clamp(torch.floor(x / scale[..., None] + u), -127, 127)
    return q.to(torch.int8), scale


def int8_decode(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8, per-row scale) → f32."""
    return q.to(torch.float32) * scale[..., None]


# ---------------------------------------------------------------------------
# dtype-generic storage codec (the seam ops.step and the trainer use)
# ---------------------------------------------------------------------------

def decode(payload: torch.Tensor, scale: Optional[torch.Tensor],
           dtype: str) -> torch.Tensor:
    """Storage → f32 working values (an f32 payload is returned as is)."""
    if dtype == "int8":
        return int8_decode(payload, scale)
    if dtype == "float32":
        return payload
    return payload.to(torch.float32)


def encode_nearest(x: torch.Tensor, dtype: str
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 → (payload, scale-or-None), deterministic nearest rounding."""
    if dtype == "float32":
        return x, None
    if dtype == "bfloat16":
        return bf16_nearest(x), None
    return int8_nearest(x)


def encode_stochastic(x: torch.Tensor, dtype: str, key, tag: int
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 → (payload, scale-or-None), keyed stochastic rounding; ``tag``
    domain-separates the tables sharing one batch key (TAG_*)."""
    if dtype == "float32":
        return x, None
    k = fold_in(key, tag)
    if dtype == "bfloat16":
        return bf16_stochastic(x, k), None
    return int8_stochastic(x, k)
