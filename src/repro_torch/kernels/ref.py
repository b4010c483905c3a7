"""Plain PyTorch versions of the FULL-W2V kernels.

The port's counterpart of ``repro.kernels.ref``: the same schedules, in
the same order, written as Python loops over sentences, tiles and windows
around small torch operations.

  preload positions 0..W_f-1
  for t in 0..len-1:
      q = t + W_f: store evicted position q - R (if any), load q
      process window t (shared-negative update, pre-window values)
  flush surviving positions in increasing order

``batch_sgns_ref`` is the plain version of the sequential kernels
(``cuda`` and ``cuda_pipelined``); ``batch_sgns_tiled_ref`` the plain
version of the window-tiled kernel (``cuda_tiled``), consuming the same
host tile plan (``repro_torch.data.batching.plan_tiles``). They are the
``torch`` and ``torch_tiled`` backends, what the CPU runs, and what the
kernels are held against on the card. ``batch_sgns_tiled_fused_ref`` is
the plain version of the split-table tiled kernel (K4,
``fullw2v_cuda_tiled_fused``); it serves the tests and ``chip_smoke.py``
(CPU sessions take the ``concat`` route of ``kernels.ops`` instead).

Both update ``w_in`` and ``w_out`` in place (the reference donates its
tables to the same effect) and return them. Control flow reads the index
arrays once on the host; every table operation stays on the tables'
device.

The frontend extensions of the reference (``static_ids``, ``bags``) arrive
with the frontends slice of the port and raise until then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.w2v import resolve_gemm_windows
from repro_torch.core.sgns import stable_sigmoid, window_delta


def _no_frontends(static_ids, bags) -> None:
    if static_ids is not None or bags is not None:
        raise NotImplementedError(
            "static_ids/bags (doc2vec and subword frontends) arrive with a "
            "later slice of the torch port")


def lr32(lr) -> float:
    """The learning rate as the f32 value the kernels receive."""
    return float(np.float32(float(lr)))


def _offsets(w_f: int, device) -> torch.Tensor:
    return torch.tensor([o for o in range(-w_f, w_f + 1) if o != 0],
                        dtype=torch.int64, device=device)


def sentence_sgns_ref(w_in: torch.Tensor, w_out: torch.Tensor,
                      tokens: torch.Tensor, negs: torch.Tensor, length: int,
                      lr: float, w_f: int,
                      tokens_host: Optional[list] = None) -> None:
    """One sentence of the sequential schedule, in place.

    ``tokens`` (L,) and ``negs`` (L, N) live on the tables' device;
    ``tokens_host`` is the same row as a Python list (read once by the
    batch loop, so control flow never waits on the device)."""
    L = tokens.shape[0]
    r = 2 * w_f + 1
    dev = w_in.device
    toks = tokens_host if tokens_host is not None else tokens.tolist()
    offsets = _offsets(w_f, dev)
    buf = torch.zeros((r, w_in.shape[1]), dtype=w_in.dtype, device=dev)

    for q in range(min(w_f, L)):                  # preload
        if q < length:
            buf[q % r] = w_in[toks[q]]

    for t in range(length):
        q = t + w_f                               # evict + load leading edge
        if q < length:
            if q - r >= 0:
                w_in[toks[q - r]] = buf[(q - r) % r]
            buf[q % r] = w_in[toks[q]]

        p = t + offsets                           # window t
        mask = (p >= 0) & (p < length)
        slots = torch.remainder(p, r)
        ctx = buf[slots]
        out_idx = torch.cat([tokens[t:t + 1].long(), negs[t].long()])
        d_ctx, d_out = window_delta(ctx, w_out[out_idx], mask, lr)
        buf.index_add_(0, slots, d_ctx)           # masked rows add zeros
        w_out.index_add_(0, out_idx, d_out)

    for k in range(r):                            # flush, increasing order
        p = length - r + k
        if p >= 0:
            w_in[toks[p]] = buf[p % r]


def batch_sgns_ref(
    w_in: torch.Tensor,      # (V, d) f32, updated in place
    w_out: torch.Tensor,     # (V, d) f32, updated in place
    tokens: torch.Tensor,    # (S, L) int32
    negs: torch.Tensor,      # (S, L, N) int32
    lengths: torch.Tensor,   # (S,) int32
    lr,                      # float or 0-d tensor
    w_f: int,
    static_ids=None,
    bags=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential pass over a batch, sentences strictly in order — the
    plain version of ``fullw2v_cuda`` (both forms)."""
    _no_frontends(static_ids, bags)
    lr = lr32(lr)
    toks_host = tokens.tolist()
    for s, length in enumerate(lengths.tolist()):
        sentence_sgns_ref(w_in, w_out, tokens[s], negs[s], length, lr, w_f,
                          tokens_host=toks_host[s])
    return w_in, w_out


# ---------------------------------------------------------------------------
# Tiled plain version (mirrors the reference's `_sentence_sgns_tiled`)
# ---------------------------------------------------------------------------

def _sentence_sgns_tiled(w_in, w_out, tokens, toks, negs, length, lr,
                         uniq, scatter, strict, *, w_f: int, tile: int,
                         gemm_windows: int) -> None:
    """One sentence of the tiled schedule, in place. ``tokens``/``negs``/
    ``uniq``/``scatter`` are device rows, ``toks``/``strict`` host lists
    (``ucount`` is implied by ``scatter``: the plain version reads only
    the columns the slots map to)."""
    G = gemm_windows
    L, N = negs.shape
    m = N + 1
    k = 2 * w_f
    rt = tile + 2 * w_f
    r_seq = 2 * w_f + 1            # sequential store distance
    dev = w_in.device
    offsets = _offsets(w_f, dev)
    buf = torch.zeros((rt, w_in.shape[1]), dtype=w_in.dtype, device=dev)

    for q in range(min(w_f, L)):                  # preload
        if q < length:
            buf[q % rt] = w_in[toks[q]]

    # ring advance pieces — slot modulus rt (rows stay resident for the
    # whole tile) but the sequential kernel's store schedule
    def store(t):
        q = t + w_f
        old = q - r_seq
        if t < length and q < length and old >= 0:
            w_in[toks[old]] = buf[old % rt]

    def load(t):
        q = t + w_f
        if t < length and q < length:
            buf[q % rt] = w_in[toks[q]]

    for i in range(len(strict)):
        t0 = i * tile
        if t0 >= length:
            break
        if strict[i]:
            # exact sequential replay (same math and ring-advance order as
            # the sequential schedule)
            for w in range(tile):
                t = t0 + w
                if t >= length:
                    break
                store(t)
                load(t)
                p = t + offsets
                mask = (p >= 0) & (p < length)
                slots = torch.remainder(p.clamp(0, L - 1), rt)
                out_idx = torch.cat([tokens[t:t + 1].long(), negs[t].long()])
                d_ctx, d_out = window_delta(buf[slots], w_out[out_idx], mask,
                                            lr)
                buf.index_add_(0, slots, d_ctx)
                w_out.index_add_(0, out_idx, d_out)
            continue

        # fused tile: GEMM groups of G windows over the tile's deduplicated
        # rows, read/written once per tile, deltas visible between groups
        cols = uniq[i].long()
        u_vals = w_out[cols]                                   # (M, d)
        u_orig = u_vals.clone()
        for b in range((tile + G - 1) // G):
            w0 = b * G
            wn = min(G, tile - w0)
            base = t0 + w0
            if base >= length:
                break
            # group ring advance: window 0 store-then-load (sequential
            # order), the other windows load here and store after the
            # group's update
            store(base)
            for w in range(wn):
                load(base + w)
            centers = base + torch.arange(wn, device=dev)
            p = (centers[:, None] + offsets[None, :]).reshape(-1)  # (wn*k,)
            p_ok = (p >= 0) & (p < length)
            slots = torch.remainder(p.clamp(0, L - 1), rt)
            ctx = torch.where(p_ok[:, None], buf[slots],
                              torch.zeros((), dtype=buf.dtype, device=dev))

            sc = scatter[i, w0 * m:(w0 + wn) * m].long()
            exp = u_vals[sc]                                   # (wn*m, d)

            win_r = torch.arange(wn * k, device=dev) // k
            win_c = torch.arange(wn * m, device=dev) // m
            row_valid = p_ok & (base + win_r < length)
            col_valid = base + win_c < length
            label = (torch.arange(wn * m, device=dev) % m == 0).to(ctx.dtype)
            mask = (row_valid[:, None] & col_valid[None, :]
                    & (win_r[:, None] == win_c[None, :]))

            corr = ctx @ exp.T                                 # (wn*k, wn*m)
            g = lr * (label[None, :] - stable_sigmoid(corr))
            g = torch.where(mask, g, torch.zeros_like(g))
            d_ctx = g @ exp                                    # (wn*k, d)
            d_out = g.T @ ctx                                  # (wn*m, d)

            buf.index_add_(0, slots, d_ctx)       # repeats accumulate
            u_vals.index_add_(0, sc, d_out)

            for w in range(1, wn):                # deferred group stores
                store(base + w)
        w_out.index_add_(0, cols, u_vals - u_orig)

    for kk in range(r_seq):                       # flush, increasing order
        p = length - r_seq + kk
        if p >= 0:
            w_in[toks[p]] = buf[p % rt]


def batch_sgns_tiled_ref(
    w_in: torch.Tensor,      # (V, d) f32, updated in place
    w_out: torch.Tensor,     # (V, d) f32, updated in place
    tokens: torch.Tensor,    # (S, L) int32
    negs: torch.Tensor,      # (S, L, N) int32
    lengths: torch.Tensor,   # (S,) int32
    lr,                      # float or 0-d tensor
    w_f: int,
    tile: int,
    uniq: torch.Tensor,      # (S, nt, T*(N+1)) int32 — from plan_tiles
    scatter: torch.Tensor,   # (S, nt, T*(N+1)) int32
    ucount: torch.Tensor,    # (S, nt) int32
    strict: torch.Tensor,    # (S, nt) int32
    gemm_windows: int = 0,   # windows per GEMM group; 0 -> min(tile, 4)
    static_ids=None,
    bags=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential pass over a batch with the tiled (T windows per step)
    semantics — the plain version of ``fullw2v_cuda_tiled``."""
    _no_frontends(static_ids, bags)
    G = resolve_gemm_windows(tile, gemm_windows)
    lr = lr32(lr)
    toks_host = tokens.tolist()
    strict_host = strict.tolist()
    for s, length in enumerate(lengths.tolist()):
        _sentence_sgns_tiled(w_in, w_out, tokens[s], toks_host[s], negs[s],
                             length, lr, uniq[s], scatter[s], strict_host[s],
                             w_f=w_f, tile=tile, gemm_windows=G)
    return w_in, w_out


def batch_sgns_tiled_fused_ref(
    hot_in: torch.Tensor,    # (hot, d) f32 — replicated hot head, in place
    hot_out: torch.Tensor,   # (hot, d) f32, in place
    got_in: torch.Tensor,    # (R, d) f32 — gathered cold block, in place
    got_out: torch.Tensor,   # (R, d) f32, in place
    tokens: torch.Tensor,    # (S, L) int32 — working-table ids (< hot + R)
    negs: torch.Tensor,      # (S, L, N) int32
    lengths: torch.Tensor,   # (S,) int32
    lr,                      # float or 0-d tensor
    w_f: int,
    tile: int,
    uniq: torch.Tensor,      # (S, nt, T*(N+1)) int32 — from plan_tiles
    scatter: torch.Tensor,   # (S, nt, T*(N+1)) int32
    ucount: torch.Tensor,    # (S, nt) int32
    strict: torch.Tensor,    # (S, nt) int32
    gemm_windows: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tiled pass on a split working table — the plain version of
    ``fullw2v_cuda_tiled_fused``. K4's stated semantics (the reference's
    ``fullw2v_pallas_tiled_fused``): :func:`batch_sgns_tiled_ref` on
    ``concat(hot, got)``, split back into the four tables."""
    hot = hot_in.shape[0]
    w_in = torch.cat([hot_in, got_in])
    w_out = torch.cat([hot_out, got_out])
    batch_sgns_tiled_ref(w_in, w_out, tokens, negs, lengths, lr, w_f, tile,
                         uniq, scatter, ucount, strict,
                         gemm_windows=gemm_windows)
    hot_in.copy_(w_in[:hot])
    hot_out.copy_(w_out[:hot])
    got_in.copy_(w_in[hot:])
    got_out.copy_(w_out[hot:])
    return hot_in, hot_out, got_in, got_out
