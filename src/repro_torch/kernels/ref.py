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

The frontend extensions of the reference run here too: ``static_ids``
(one table row per sentence, -1 for none: the doc2vec document row, an
extra context row of every window, loaded once per sentence and written
back once) and ``bags`` (per-position member rows, -1 padded: the subword
frontend's word row and hashed n-gram rows, loaded as their sum and stored
by adding the row's accumulated delta to every member). No CUDA kernel
consumes them, in this package or in the reference, so a frontend step
always runs these plain versions.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.w2v import resolve_gemm_windows
from repro_torch.core.sgns import stable_sigmoid, window_delta


def lr32(lr) -> float:
    """The learning rate as the f32 value the kernels receive."""
    return float(np.float32(float(lr)))


def _offsets(w_f: int, device) -> torch.Tensor:
    return torch.tensor([o for o in range(-w_f, w_f + 1) if o != 0],
                        dtype=torch.int64, device=device)


def check_frontends(tokens: torch.Tensor, static_ids, bags) -> None:
    """Raise unless ``static_ids`` is an integer ``(S,)`` tensor and
    ``bags`` an integer ``(S, L, B)`` tensor on the tokens' device (either
    may be ``None``)."""
    S, L = tokens.shape
    for name, t, shape in (("static_ids", static_ids, (S,)),
                           ("bags", bags, (S, L))):
        if t is None:
            continue
        if (not isinstance(t, torch.Tensor) or t.dtype not in (
                torch.int32, torch.int64) or t.device != tokens.device
                or tuple(t.shape[:len(shape)]) != shape
                or t.dim() != len(shape) + (name == "bags")):
            raise ValueError(
                f"{name} must be an int32 or int64 tensor of shape "
                f"{shape + (('B',) if name == 'bags' else ())} on "
                f"{tokens.device}, got "
                f"{getattr(t, 'dtype', type(t).__name__)} "
                f"{tuple(getattr(t, 'shape', ()))}")


class _Ring:
    """The input rows of one sentence's context ring, with the frontends'
    load and store rules: ``slots`` rows of ``buf``; with ``bags`` a
    load-time mirror ``buf0``, so a store adds the row's accumulated
    update ``buf - buf0`` to every member of the position's bag (the
    reference's ``_position_row``/``_bag_scatter``); without, a load
    copies the token's row and a store writes the row back. Every valid
    member of a bag receives the same delta, so the order in which
    repeated members add it cannot change the bits."""

    def __init__(self, w_in: torch.Tensor, toks: list, slots: int,
                 bags: Optional[torch.Tensor]):
        self.w_in, self.toks, self.slots, self.bags = w_in, toks, slots, bags
        shape = (slots, w_in.shape[1])
        self.buf = torch.zeros(shape, dtype=w_in.dtype, device=w_in.device)
        self.buf0 = None if bags is None else torch.zeros_like(self.buf)

    def load(self, q: int) -> None:
        s = q % self.slots
        if self.bags is None:
            self.buf[s] = self.w_in[self.toks[q]]
            return
        mem = self.bags[q]
        rows = self.w_in[mem.clamp(min=0).long()]                   # (B, d)
        row = torch.where((mem >= 0)[:, None], rows, 0.0).sum(0)
        self.buf[s] = row
        self.buf0[s] = row

    def store(self, p: int) -> None:
        s = p % self.slots
        if self.bags is None:
            self.w_in[self.toks[p]] = self.buf[s]
            return
        mem = self.bags[p]
        delta = self.buf[s] - self.buf0[s]
        self.w_in.index_add_(0, mem.clamp(min=0).long(), torch.where(
            (mem >= 0)[:, None], delta[None, :], 0.0))


class _Doc:
    """A sentence's static context row (doc2vec): its value at the
    sentence's start, the value the windows update, and the write-back of
    the accumulated update at the sentence's end. ``sid < 0``: none."""

    def __init__(self, w_in: torch.Tensor, sid: int):
        self.sid = sid
        self.on = sid >= 0
        if self.on:
            self.val0 = w_in[sid].clone()
            self.val = self.val0.clone()

    def write_back(self, w_in: torch.Tensor) -> None:
        if self.on:
            w_in[self.sid] += self.val - self.val0


def sentence_sgns_ref(w_in: torch.Tensor, w_out: torch.Tensor,
                      tokens: torch.Tensor, negs: torch.Tensor, length: int,
                      lr: float, w_f: int,
                      tokens_host: Optional[list] = None,
                      static_id: int = -1,
                      bags: Optional[torch.Tensor] = None) -> None:
    """One sentence of the sequential schedule, in place.

    ``tokens`` (L,) and ``negs`` (L, N) live on the tables' device;
    ``tokens_host`` is the same row as a Python list (read once by the
    batch loop, so control flow never waits on the device). ``static_id``
    (a table row, -1 for none) rides as one more context row of every
    window; ``bags`` (L, B) replaces each position's row with its bag."""
    r = 2 * w_f + 1
    dev = w_in.device
    toks = tokens_host if tokens_host is not None else tokens.tolist()
    offsets = _offsets(w_f, dev)
    ring = _Ring(w_in, toks, r, bags)
    buf = ring.buf
    doc = _Doc(w_in, static_id)

    for q in range(min(w_f, length)):             # preload
        ring.load(q)

    for t in range(length):
        q = t + w_f                               # evict + load leading edge
        if q < length:
            if q - r >= 0:
                ring.store(q - r)
            ring.load(q)

        p = t + offsets                           # window t
        mask = (p >= 0) & (p < length)
        slots = torch.remainder(p, r)
        ctx = buf[slots]
        out_idx = torch.cat([tokens[t:t + 1].long(), negs[t].long()])
        if doc.on:
            ctx = torch.cat([ctx, doc.val[None]])
            mask = torch.cat([mask, mask.new_ones(1)])
        d_ctx, d_out = window_delta(ctx, w_out[out_idx], mask, lr)
        if doc.on:
            doc.val += d_ctx[-1]
            d_ctx = d_ctx[:-1]
        buf.index_add_(0, slots, d_ctx)           # masked rows add zeros
        w_out.index_add_(0, out_idx, d_out)

    for k in range(r):                            # flush, increasing order
        p = length - r + k
        if p >= 0:
            ring.store(p)
    doc.write_back(w_in)


def batch_sgns_ref(
    w_in: torch.Tensor,      # (V, d) f32, updated in place
    w_out: torch.Tensor,     # (V, d) f32, updated in place
    tokens: torch.Tensor,    # (S, L) int32
    negs: torch.Tensor,      # (S, L, N) int32
    lengths: torch.Tensor,   # (S,) int32
    lr,                      # float or 0-d tensor
    w_f: int,
    static_ids: Optional[torch.Tensor] = None,   # (S,) int, -1 = none
    bags: Optional[torch.Tensor] = None,         # (S, L, B) int, -1 pad
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential pass over a batch, sentences strictly in order — the
    plain version of ``fullw2v_cuda`` (both forms)."""
    check_frontends(tokens, static_ids, bags)
    lr = lr32(lr)
    toks_host = tokens.tolist()
    sids = static_ids.tolist() if static_ids is not None else None
    for s, length in enumerate(lengths.tolist()):
        sentence_sgns_ref(w_in, w_out, tokens[s], negs[s], length, lr, w_f,
                          tokens_host=toks_host[s],
                          static_id=sids[s] if sids is not None else -1,
                          bags=bags[s] if bags is not None else None)
    return w_in, w_out


# ---------------------------------------------------------------------------
# Tiled plain version (mirrors the reference's `_sentence_sgns_tiled`)
# ---------------------------------------------------------------------------

def _sentence_sgns_tiled(w_in, w_out, tokens, toks, negs, length, lr,
                         uniq, scatter, strict, *, w_f: int, tile: int,
                         gemm_windows: int, static_id: int = -1,
                         bags: Optional[torch.Tensor] = None) -> None:
    """One sentence of the tiled schedule, in place. ``tokens``/``negs``/
    ``uniq``/``scatter``/``bags`` are device rows, ``toks``/``strict``
    host lists (``ucount`` is implied by ``scatter``: the plain version
    reads only the columns the slots map to). ``static_id``/``bags`` as in
    :func:`sentence_sgns_ref`; a fused group sees the doc row's value at
    the group's start in each of its windows (the same bounded staleness
    as the output rows)."""
    G = gemm_windows
    L, N = negs.shape
    m = N + 1
    k = 2 * w_f
    rt = tile + 2 * w_f
    r_seq = 2 * w_f + 1            # sequential store distance
    dev = w_in.device
    offsets = _offsets(w_f, dev)
    ring = _Ring(w_in, toks, rt, bags)
    buf = ring.buf
    doc = _Doc(w_in, static_id)

    for q in range(min(w_f, length)):             # preload
        ring.load(q)

    # ring advance pieces — slot modulus rt (rows stay resident for the
    # whole tile) but the sequential kernel's store schedule
    def store(t):
        q = t + w_f
        old = q - r_seq
        if t < length and q < length and old >= 0:
            ring.store(old)

    def load(t):
        q = t + w_f
        if t < length and q < length:
            ring.load(q)

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
                ctx = buf[slots]
                out_idx = torch.cat([tokens[t:t + 1].long(), negs[t].long()])
                if doc.on:
                    ctx = torch.cat([ctx, doc.val[None]])
                    mask = torch.cat([mask, mask.new_ones(1)])
                d_ctx, d_out = window_delta(ctx, w_out[out_idx], mask, lr)
                if doc.on:
                    doc.val += d_ctx[-1]
                    d_ctx = d_ctx[:-1]
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
            if doc.on:
                # one doc row per window of the group, after the position
                # rows, each holding the doc row's value at the group start
                wins = torch.arange(wn, device=dev)
                ctx = torch.cat([ctx, doc.val.expand(wn, -1)])
                win_r = torch.cat([win_r, wins])
                row_valid = torch.cat([row_valid, base + wins < length])
            label = (torch.arange(wn * m, device=dev) % m == 0).to(ctx.dtype)
            mask = (row_valid[:, None] & col_valid[None, :]
                    & (win_r[:, None] == win_c[None, :]))

            corr = ctx @ exp.T                                 # (rows, wn*m)
            g = lr * (label[None, :] - stable_sigmoid(corr))
            g = torch.where(mask, g, torch.zeros_like(g))
            d_ctx = g @ exp                                    # (rows, d)
            d_out = g.T @ ctx                                  # (wn*m, d)

            if doc.on:
                doc.val += d_ctx[wn * k:].sum(0)
                d_ctx = d_ctx[:wn * k]
            # repeats accumulate, one window at a time: a window's slots
            # and columns are distinct, so no launch adds two different
            # values to one row (CUDA's index_add_ adds repeated indices
            # with atomics, in no fixed order; the CPU adds in index order
            # either way)
            for w in range(wn):
                buf.index_add_(0, slots[w * k:(w + 1) * k],
                               d_ctx[w * k:(w + 1) * k])
                u_vals.index_add_(0, sc[w * m:(w + 1) * m],
                                  d_out[w * m:(w + 1) * m])

            for w in range(1, wn):                # deferred group stores
                store(base + w)
        w_out.index_add_(0, cols, u_vals - u_orig)

    for kk in range(r_seq):                       # flush, increasing order
        p = length - r_seq + kk
        if p >= 0:
            ring.store(p)
    doc.write_back(w_in)


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
    static_ids: Optional[torch.Tensor] = None,   # (S,) int, -1 = none
    bags: Optional[torch.Tensor] = None,         # (S, L, B) int, -1 pad
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential pass over a batch with the tiled (T windows per step)
    semantics — the plain version of ``fullw2v_cuda_tiled``."""
    check_frontends(tokens, static_ids, bags)
    G = resolve_gemm_windows(tile, gemm_windows)
    lr = lr32(lr)
    toks_host = tokens.tolist()
    strict_host = strict.tolist()
    sids = static_ids.tolist() if static_ids is not None else None
    for s, length in enumerate(lengths.tolist()):
        _sentence_sgns_tiled(w_in, w_out, tokens[s], toks_host[s], negs[s],
                             length, lr, uniq[s], scatter[s], strict_host[s],
                             w_f=w_f, tile=tile, gemm_windows=G,
                             static_id=sids[s] if sids is not None else -1,
                             bags=bags[s] if bags is not None else None)
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
