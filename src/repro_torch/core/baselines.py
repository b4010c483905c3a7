"""Baseline SGNS implementations the paper compares against, in torch.

The port's counterpart of ``repro.core.baselines``:

* :func:`naive_sgns`  — accSGNS/Mikolov-style: one (context, target) pair at
  a time, immediate read-modify-write of every row against the table; no
  sharing, no lifetime reuse. Highest memory traffic (paper Table 4,
  accSGNS row).
* :func:`matrix_sgns` — pWord2Vec-style: shared negatives per window as two
  small matrix products, but context rows are re-read from and re-written
  to the table every window (no cross-window ring buffer). Traffic ≈
  (2W_f+1)× FULL-W2V's for context rows (paper §3.2).

Both are semantics baselines: on sentences without short-range token
repeats, :func:`matrix_sgns` is mathematically identical to the FULL-W2V
ring-buffer pass (``kernels.ref.batch_sgns_ref``), differing only in
memory traffic — which is exactly the paper's claim.

The reference computes them with ``jax.numpy``, not with Pallas kernels, so
they stay plain torch here: Python loops over sentences, windows (and, for
the naive baseline, pairs) around small torch operations on the tables'
device, in the reference's order. They update ``w_in`` and ``w_out`` in
place and return them. Control flow reads the index arrays once on the
host; skipped (inactive) windows and pairs are the ones the reference
masks to zero deltas.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.sgns import pair_delta, window_delta
from repro_torch.kernels.ref import lr32


def _offsets(w_f: int, device) -> torch.Tensor:
    return torch.tensor([o for o in range(-w_f, w_f + 1) if o != 0],
                        dtype=torch.int64, device=device)


def matrix_sgns_sentence(w_in: torch.Tensor, w_out: torch.Tensor,
                         tokens: torch.Tensor, negs: torch.Tensor,
                         length: int, lr, w_f: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pWord2Vec-style shared-negative window updates of one sentence,
    straight to the table, in place."""
    L = tokens.shape[0]
    lr = lr32(lr)
    offsets = _offsets(w_f, w_in.device)
    toks = tokens.long()
    for t in range(int(length)):
        p = t + offsets
        mask = (p >= 0) & (p < length)
        ctx_idx = toks[p.clamp(0, L - 1)]
        out_idx = torch.cat([toks[t:t + 1], negs[t].long()])
        d_ctx, d_out = window_delta(w_in[ctx_idx], w_out[out_idx], mask, lr)
        w_in.index_add_(0, ctx_idx, d_ctx)        # table write per window
        w_out.index_add_(0, out_idx, d_out)
    return w_in, w_out


def matrix_sgns(w_in: torch.Tensor, w_out: torch.Tensor,
                tokens: torch.Tensor, negs: torch.Tensor,
                lengths: torch.Tensor, lr, w_f: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`matrix_sgns_sentence` over a batch, sentences in order."""
    for s, length in enumerate(lengths.tolist()):
        matrix_sgns_sentence(w_in, w_out, tokens[s], negs[s], length, lr,
                             w_f)
    return w_in, w_out


def naive_sgns_sentence(w_in: torch.Tensor, w_out: torch.Tensor,
                        tokens: torch.Tensor, negs: torch.Tensor,
                        length: int, lr, w_f: int,
                        tokens_host: Optional[list] = None,
                        negs_host: Optional[list] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """accSGNS-style: sequential per-pair updates, every pairing its own
    table read-modify-write (the window's negatives are reused per pair,
    mirroring the shared-negative batching all modern implementations
    use). Pairs run context offset-major, output row-minor, as the
    reference's ``j = off_idx * (N+1) + o_idx``."""
    lr = lr32(lr)
    toks = tokens_host if tokens_host is not None else tokens.tolist()
    ngs = negs_host if negs_host is not None else negs.tolist()
    offs = [o for o in range(-w_f, w_f + 1) if o != 0]
    for t in range(int(length)):
        outs = [toks[t]] + ngs[t]
        for off in offs:
            p = t + off
            if p < 0 or p >= length:
                continue
            c = toks[p]
            for o_idx, o in enumerate(outs):
                label = 1.0 if o_idx == 0 else 0.0
                d_in, d_out = pair_delta(w_in[c], w_out[o], label, lr)
                w_in[c] += d_in
                w_out[o] += d_out
    return w_in, w_out


def naive_sgns(w_in: torch.Tensor, w_out: torch.Tensor,
               tokens: torch.Tensor, negs: torch.Tensor,
               lengths: torch.Tensor, lr, w_f: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`naive_sgns_sentence` over a batch, sentences in order."""
    toks, ngs = tokens.tolist(), negs.tolist()
    for s, length in enumerate(lengths.tolist()):
        naive_sgns_sentence(w_in, w_out, tokens[s], negs[s], length, lr,
                            w_f, tokens_host=toks[s], negs_host=ngs[s])
    return w_in, w_out
