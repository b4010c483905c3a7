"""Batched nearest-neighbour / analogy top-k over sharded tables.

The port's counterpart of ``repro.serve.query``. The reference runs the
sharded path under ``shard_map``; here every rank of a
:class:`~repro_torch.launch.mesh.DataMesh` calls the same function on its
own cold block, and the collectives of
:mod:`repro_torch.distributed.collectives` take the place of
``jax.lax``'s (at one rank they are identities and touch no group):

1. **Query-row gather** — hot rows come from the local replica; each
   cold query row is contributed by its owner rank and ``psum``'d, so
   every rank holds the full ``(B, d)`` query block.
2. **Partial top-k** — each rank scores the candidates it is responsible
   for (rank 0 additionally scores the replicated hot head, so no
   candidate is scored twice) and ranks them. Rank 0 scores head and
   block in one product, as the reference does, so at one rank the
   scores are the bits :func:`dense_topk` computes on the merged table.
3. **Cross-shard merge** — the ``n·k`` partials are ``all_gather``'d and
   re-ranked by ``(score desc, id asc)``.

Ranking (:func:`_rank`) reproduces the reference's ``jnp.lexsort((ids,
-scores))`` exactly, ties and ``-inf`` (dead) entries included:
``torch.topk`` orders no ties, so each candidate gets one unique int64
key, the score's total-order bits (descending, ``-0.0`` below ``+0.0``
as in XLA's sort) in the high word and the id in the low word, and the
``k`` smallest keys are taken. Keys are unique per row, so the result
does not depend on the top-k algorithm.

Scores are ``q @ cand.T`` in full f32: on the GPU the product runs with
TF32 off whatever the process-wide flag says (:func:`_scores`), since
TF32's 10-bit mantissa moves scores by ~1e-3.

:func:`dense_topk` is the single-process oracle on a merged ``(V, d)``
table: the same gather math, exclusions and ranking.

Query encodings (ids are global vocabulary ids):

* ``mode="nn"``      — ``ids (B,)``: cosine neighbours of each word;
  the word itself is excluded from its candidates.
* ``mode="analogy"`` — ``ids (B, 3)`` rows ``(a, b, c)``: neighbours of
  the normalized ``a − b + c`` offset vector (3CosAdd); a, b, c are all
  excluded.
"""
from __future__ import annotations

import threading
from typing import Callable, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.vocab_placement import VocabPlacement

NEG_INF = float("-inf")
MODES = ("nn", "analogy")

_TF32_LOCK = threading.Lock()


def _scores(q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """``q @ cand.T`` in IEEE f32. On the GPU the TF32 flag is cleared
    around the call (under a lock, so two serving threads cannot restore
    each other's setting) and put back after it."""
    if not q.is_cuda:
        return q @ cand.T
    flags = torch.backends.cuda.matmul
    with _TF32_LOCK:
        saved = flags.allow_tf32
        flags.allow_tf32 = False
        try:
            return q @ cand.T
        finally:
            flags.allow_tf32 = saved


def _order_key(scores: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """One int64 per candidate that sorts ascending as ``(score desc, id
    asc)``: the high word is the bitwise complement of the score's
    total-order int32 image, the low word the (non-negative) id."""
    bits = scores.contiguous().view(torch.int32)
    total = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return ((~total).to(torch.int64) << 32) + ids.to(torch.int64)


def _rank(scores: torch.Tensor, ids: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k by ``(score desc, id asc)`` — the one ranking rule both the
    sharded merge and the dense oracle use, so ties cannot diverge.
    ``ids`` broadcasts against ``scores``; fewer than ``k`` candidates
    give them all, as the reference's slice does."""
    ids = torch.broadcast_to(ids, scores.shape)
    k = min(int(k), scores.shape[-1])
    _, order = torch.topk(_order_key(scores, ids), k, dim=-1,
                          largest=False, sorted=True)
    return (torch.take_along_dim(ids, order, dim=-1),
            torch.take_along_dim(scores, order, dim=-1))


def _kill(scores: torch.Tensor, cols: torch.Tensor,
          live: torch.Tensor) -> torch.Tensor:
    """Set ``scores[b, cols[b, e]]`` to ``-inf`` where ``live[b, e]``, in
    place. An ``amin`` scatter of ``-inf`` (and ``+inf`` where not live),
    so repeated or clipped columns cannot race."""
    src = torch.where(live, NEG_INF, float("inf")).to(scores.dtype)
    cols = cols.clamp(0, scores.shape[-1] - 1).to(torch.int64)
    return scores.scatter_reduce_(-1, cols, src, "amin")


def _joined(hot: torch.Tensor, cold: torch.Tensor) -> torch.Tensor:
    """``cat([hot, cold])``: a view when ``cold`` follows ``hot`` in one
    buffer, as :class:`~repro_torch.serve.index.EmbeddingIndex` stages
    them (no copy of the table per batch), else a new tensor."""
    if (hot.is_contiguous() and cold.is_contiguous()
            and hot.dtype == cold.dtype and hot.device == cold.device
            and hot.shape[1:] == cold.shape[1:]
            and hot.untyped_storage().data_ptr()
            == cold.untyped_storage().data_ptr()
            and cold.storage_offset()
            == hot.storage_offset() + hot.numel()):
        return hot.as_strided((hot.shape[0] + cold.shape[0],
                               *hot.shape[1:]), hot.stride())
    return torch.cat([hot, cold])


def _as_ids(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(ids, np.int32), device=device)


def _query_vectors(hot: torch.Tensor, cold: torch.Tensor,
                   flat_ids: torch.Tensor, placement: VocabPlacement,
                   mesh) -> torch.Tensor:
    """Gather normalized rows for global ids: hot rows from the local
    replica, cold rows ``psum``'d from their owner rank."""
    n, hot_n = placement.n_shards, placement.hot
    rank = 0 if mesh is None else mesh.rank
    is_hot = flat_ids < hot_n
    hot_part = torch.where(
        is_hot[:, None], hot[flat_ids.clamp(0, hot_n - 1).long()], 0.0)
    c = flat_ids - hot_n
    mine = (~is_hot) & (c % n == rank)
    local = (c // n).clamp(0, cold.shape[0] - 1).long()
    cold_part = torch.where(mine[:, None], cold[local], 0.0)
    return hot_part + coll.psum(cold_part, mesh)


def _combine(rows: torch.Tensor, ids: torch.Tensor, mode: str
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(query vectors (B, d), excluded ids (B, E)) for a query batch."""
    if mode == "nn":
        return rows, ids[:, None]
    if mode == "analogy":
        r = rows.reshape(ids.shape[0], 3, -1)
        q = r[:, 0] - r[:, 1] + r[:, 2]
        q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                            min=1e-12)
        return q, ids
    raise ValueError(f"unknown query mode {mode!r} (nn | analogy)")


def make_topk_fn(placement: VocabPlacement, mesh=None, mode: str = "nn",
                 k: int = 5) -> Callable:
    """Build the sharded top-k: ``fn(hot, cold, ids) -> (ids, scores)``,
    both ``(B, k)`` tensors on the tables' device (int32, f32). ``cold``
    is this rank's block (``cold_per_shard`` rows; the whole cold table at
    one rank); ``ids`` (numpy or a tensor) is ``(B,)`` for ``mode="nn"``,
    ``(B, 3)`` for ``mode="analogy"``. Out-of-range query slots are
    tolerated (clipped gathers). Under a mesh of several ranks every rank
    calls ``fn`` with the same ``ids``, in the same order: it runs a
    ``psum`` and an ``all_gather``.
    """
    n, hot_n, v = placement.n_shards, placement.hot, placement.vocab_size
    cps = placement.cold_per_shard
    if k > hot_n + cps:
        raise ValueError(
            f"k={k} exceeds per-shard candidate count {hot_n + cps} "
            f"(hot={hot_n} + cold_per_shard={cps})")
    if mode not in MODES:
        raise ValueError(f"unknown query mode {mode!r} (nn | analogy)")
    size = 1 if mesh is None else mesh.size
    if size != n:
        raise ValueError(f"placement has {n} shards, the mesh {size} ranks")
    s = 0 if mesh is None else mesh.rank
    # this rank's cold candidates: global ids hot + s + j·n; the rows past
    # the vocabulary (j >= live) are padding and stay dead
    live = max(0, -(-(placement.cold - s) // n))

    def fn(hot: torch.Tensor, cold: torch.Tensor, ids):
        dev = hot.device
        ids = _as_ids(ids, dev)
        rows = _query_vectors(hot, cold, ids.reshape(-1), placement, mesh)
        q, excl = _combine(rows, ids, mode)
        b = ids.shape[0]
        gids_c = (hot_n + s + torch.arange(cps, dtype=torch.int32,
                                           device=dev) * n)
        c = excl - hot_n
        if s == 0:
            # the hot head and the cold block in one product, as the
            # reference scores concat([hot, cold])
            sc = _scores(q, _joined(hot, cold))
            _kill(sc, excl, (excl >= 0) & (excl < hot_n))
            cand = torch.cat([torch.arange(hot_n, dtype=torch.int32,
                                           device=dev), gids_c])
            sc_c = sc[:, hot_n:]
        else:
            sc = sc_c = _scores(q, cold)
            cand = gids_c
        sc_c[:, live:] = NEG_INF
        _kill(sc_c, c // n, (excl >= hot_n) & (excl < v) & (c % n == s))
        ids_l, sc_l = _rank(sc, cand, k)
        if s != 0:
            # every hot row is dead here: the reference ranks them at -inf
            # by id, so the lowest hot ids join this rank's partial
            m = min(k, hot_n)
            ids_l, sc_l = _rank(
                torch.cat([sc_l, torch.full((b, m), NEG_INF, device=dev)],
                          dim=1),
                torch.cat([ids_l, torch.arange(m, dtype=torch.int32,
                                               device=dev).expand(b, m)],
                          dim=1), k)
        # cross-shard merge: n·k partials, re-ranked by the same rule
        g_sc = coll.all_gather(sc_l, mesh)                # (n, B, k)
        g_id = coll.all_gather(ids_l, mesh)
        g_sc = g_sc.movedim(0, 1).reshape(b, n * k)
        g_id = g_id.movedim(0, 1).reshape(b, n * k)
        return _rank(g_sc, g_id, k)

    return fn


def dense_topk(emb, ids, k: int = 5, mode: str = "nn",
               normalized: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Single-process oracle on a merged ``(V, d)`` table — the parity
    reference for the sharded path (same gather math, same exclusions,
    same ``(score desc, id asc)`` ranking). ``emb`` and ``ids`` are numpy
    or tensors; it runs on ``emb``'s device (the CPU for numpy) and
    returns numpy. ``normalized=False`` L2-normalizes rows first (e.g. a
    raw ``TrainSession.embeddings()`` table)."""
    if isinstance(emb, torch.Tensor):
        emb = emb.to(torch.float32)
    else:
        emb = torch.from_numpy(np.asarray(emb, np.float32))
    if not normalized:
        emb = emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                                min=1e-12)
    ids = _as_ids(ids, emb.device)
    rows = emb[ids.reshape(-1).long()]
    q, excl = _combine(rows, ids, mode)
    scores = _kill(_scores(q, emb), excl,
                   (excl >= 0) & (excl < emb.shape[0]))
    gids = torch.arange(emb.shape[0], dtype=torch.int32, device=emb.device)
    out_ids, out_sc = _rank(scores, gids, k)
    return out_ids.cpu().numpy(), out_sc.cpu().numpy()
