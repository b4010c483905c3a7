"""Canonical SGNS (skip-gram negative sampling) window math, in torch.

The port's counterpart of ``repro.core.sgns``: the same semantics every
implementation here (plain versions, CUDA kernels) must agree on. Within
one context window every (context word x output row) pairing is computed
from the *pre-window* values and the accumulated deltas are applied at
window end, which makes the window update two small matrix products.

Window update, given
  C_in  : (K, d)    context-word input rows (K = 2·W_f, masked at edges)
  M_out : (N+1, d)  output rows: [target, negative_1 .. negative_N]
  label : (N+1,)    [1, 0, ..., 0]
is
  corr  = C_in @ M_out^T                  (K, N+1)
  g     = lr * (label - sigmoid(corr))    (K, N+1), zeroed where ctx invalid
  dC_in = g @ M_out                       (K, d)
  dM_out= g^T @ C_in                      (N+1, d)
"""
from __future__ import annotations

from typing import Tuple

import torch


def stable_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable logistic, spelled out with the same two-branch
    formula the CUDA kernels use (``expf`` in both branches)."""
    return torch.where(
        x >= 0,
        1.0 / (1.0 + torch.exp(-x)),
        torch.exp(x) / (1.0 + torch.exp(x)),
    )


def window_delta(
    ctx: torch.Tensor,        # (K, d) f32 — pre-window context input rows
    out_rows: torch.Tensor,   # (N+1, d) f32 — pre-window output rows
    ctx_mask: torch.Tensor,   # (K,) bool — which context slots are real words
    lr: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (d_ctx (K,d), d_out (N+1,d)) for one shared-negative window.

    The label vector is implicit: ``out_rows[0]`` is the positive target,
    the rest are negatives.
    """
    label = torch.zeros(out_rows.shape[0], dtype=ctx.dtype,
                        device=ctx.device)
    label[0] = 1.0
    corr = ctx @ out_rows.T                                   # (K, N+1)
    g = lr * (label[None, :] - stable_sigmoid(corr))          # (K, N+1)
    g = torch.where(ctx_mask[:, None], g, torch.zeros_like(g))
    d_ctx = g @ out_rows                                      # (K, d)
    d_out = g.T @ ctx                                         # (N+1, d)
    return d_ctx, d_out



def window_context_positions(t: int, w_f: int, length: int) -> list:
    """Python helper (tests): context positions of window t."""
    return [p for p in range(t - w_f, t + w_f + 1)
            if p != t and 0 <= p < length]


def pair_delta(
    in_vec: torch.Tensor,    # (d,)
    out_vec: torch.Tensor,   # (d,)
    label: float,            # 0 or 1
    lr: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single (input, output) pairing — building block of the naive
    (accSGNS-style) baseline."""
    f = stable_sigmoid(in_vec @ out_vec)
    g = lr * (label - f)
    return g * out_vec, g * in_vec
