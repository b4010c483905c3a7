"""Vocabulary placement: replicated hot head + sharded cold tail.

The port's counterpart of ``repro.distributed.vocab_placement`` (numpy
only): placements and exchange plans are bit-identical to the
reference's for the same batch. Only the device lift
(:meth:`VocabExchange.step_inputs`) differs — it builds the port's torch
``StepInputs`` on an explicit device, for one rank of a mesh. The device
step that consumes the plans is ``repro_torch.kernels.ops``, one process
per shard.

FULL-W2V's reuse hierarchy keeps hot rows near the compute (registers /
shared memory in the paper; ring buffer / tile dedup here) and spills cold
rows to HBM. This module extends the same hierarchy one level up — across
the *mesh*: the Zipf-hot head of the vocabulary (top-K rows by corpus
frequency, covering ~90% of token occurrences) is replicated on every
device, while the cold tail is sharded over the ``data`` axis, so trainable
vocabulary scales with device count instead of being capped by one device's
HBM (DESIGN.md §8; the hybrid replicate/shard strategy of Ji et al.,
arXiv:1604.04661).

Two host-side artifacts:

* :class:`VocabPlacement` — the static placement: hot size, shard count,
  striped ownership of cold rows, and the split/merge permutations between
  the replicated ``(V, d)`` layout and the ``hot + sharded-cold`` layout.
* :func:`plan_exchange` — the per-batch exchange plan: for each mesh shard,
  the *distinct* cold rows its sentences touch (the same first-seen dedup
  rule ``plan_tiles`` applies per window tile, applied per shard —
  ``data.batching.first_seen_unique``) plus token/negative/plan index
  arrays remapped into the shard's compact working-table space. The device
  step then all-gathers O(distinct rows), never O(V).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# Default Zipf coverage of the replicated hot head: the smallest frequency-
# ranked prefix whose occurrence mass reaches this fraction is replicated.
VOCAB_HOT_COVERAGE = 0.9

# Per-shard exchange lists are padded up to a multiple of this, so a run
# sees a handful of request widths instead of one per batch (the
# reference's jit cache key; kept so the plans stay bit-identical).
_REQUEST_PAD = 64

# Per-owner capacity buckets are padded up to a multiple of this. Buckets
# are ~R/n_shards entries each (modulo striping balances them), so a finer
# granule than _REQUEST_PAD keeps the all_to_all padding overhead small
# while still bounding the number of distinct shapes.
_BUCKET_PAD = 8


@dataclasses.dataclass(frozen=True)
class VocabPlacement:
    """Static hot/cold placement of a ``(V, d)`` embedding table.

    Rows ``[0, hot)`` (the vocabulary is frequency-sorted by construction,
    ``data.vocab.Vocab.build``) are replicated on every shard. Cold rows
    ``[hot, V)`` are striped over ``n_shards``: cold index ``c = id - hot``
    lives on shard ``c % n_shards`` at local row ``c // n_shards`` — modulo
    striping, so the Zipf tail's residual skew spreads evenly instead of
    loading shard 0 with the warmest cold rows.
    """

    vocab_size: int
    hot: int
    n_shards: int

    def __post_init__(self):
        if not (1 <= self.hot <= self.vocab_size):
            raise ValueError(
                f"hot head must satisfy 1 <= hot <= V; got hot={self.hot}, "
                f"V={self.vocab_size}")
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    # -- derived sizes -------------------------------------------------------
    @property
    def cold(self) -> int:
        """Real cold rows (``V - hot``)."""
        return self.vocab_size - self.hot

    @property
    def cold_pad(self) -> int:
        """Cold rows padded up to a multiple of ``n_shards`` (>= n_shards,
        so the sharded table is never zero-sized)."""
        n = self.n_shards
        return max(n, -(-self.cold // n) * n)

    @property
    def cold_per_shard(self) -> int:
        """Local cold rows per shard."""
        return self.cold_pad // self.n_shards

    @property
    def rows_per_device(self) -> int:
        """Embedding rows resident per device: hot replica + cold shard."""
        return self.hot + self.cold_per_shard

    # -- construction --------------------------------------------------------
    @classmethod
    def plan(cls, counts: np.ndarray, n_shards: int,
             hot_frac: float = 0.0,
             coverage: float = VOCAB_HOT_COVERAGE) -> "VocabPlacement":
        """Choose the hot head for a frequency-sorted vocabulary.

        ``hot_frac > 0`` pins the head to ``round(hot_frac * V)`` rows;
        otherwise the head is the smallest prefix whose occurrence mass
        reaches ``coverage`` (under Zipf that is a small fraction of V
        covering ~90% of token traffic). The head is clamped to ``[1,
        V - 1]`` so there is always at least one cold row to shard.
        """
        counts = np.asarray(counts)
        v = int(counts.size)
        if v < 2:
            raise ValueError(f"vocab too small to shard (V={v})")
        if hot_frac > 0.0:
            hot = int(round(hot_frac * v))
        else:
            mass = np.cumsum(counts, dtype=np.float64)
            total = float(mass[-1]) or 1.0
            hot = int(np.searchsorted(mass, coverage * total) + 1)
        hot = max(1, min(hot, v - 1))
        return cls(vocab_size=v, hot=hot, n_shards=int(n_shards))

    # -- ownership -----------------------------------------------------------
    def owner_of(self, ids: np.ndarray) -> np.ndarray:
        """Owning shard per id (-1 for hot/replicated ids)."""
        ids = np.asarray(ids)
        return np.where(ids >= self.hot, (ids - self.hot) % self.n_shards,
                        -1)

    def local_row(self, ids: np.ndarray) -> np.ndarray:
        """Local row index on the owning shard (0 for hot ids)."""
        ids = np.asarray(ids)
        return np.where(ids >= self.hot, (ids - self.hot) // self.n_shards,
                        0)

    def _perm(self) -> np.ndarray:
        """Padded cold index -> position in the shard-major cold table."""
        ci = np.arange(self.cold_pad)
        return (ci % self.n_shards) * self.cold_per_shard + \
            (ci // self.n_shards)

    # -- layout conversion ---------------------------------------------------
    def split(self, full: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``(V, d)`` table -> (hot replica ``(hot, d)``, shard-major cold
        table ``(cold_pad, d)``; rows ``[i*cps, (i+1)*cps)`` belong to shard
        i). Padding rows are zero. Exact inverse of :meth:`merge`.

        Works on any trailing shape — including 1-D ``(V,)`` vectors, which
        is how int8 per-row scales colocate with their cold shards: split
        with the *same* row permutation as the cold rows themselves, so
        ``scale[i]`` always lives on the shard serving ``cold[i]``."""
        full = np.asarray(full)
        if full.shape[0] != self.vocab_size:
            raise ValueError(f"table has {full.shape[0]} rows, placement "
                             f"expects V={self.vocab_size}")
        cold_arr = np.zeros((self.cold_pad,) + full.shape[1:], full.dtype)
        ci = np.arange(self.cold)
        cold_arr[self._perm()[:self.cold]] = full[self.hot + ci]
        return full[:self.hot].copy(), cold_arr

    def merge(self, hot: np.ndarray, cold: np.ndarray) -> np.ndarray:
        """Reassemble the replicated ``(V, d)`` table from split parts."""
        hot, cold = np.asarray(hot), np.asarray(cold)
        if hot.shape[0] != self.hot or cold.shape[0] != self.cold_pad:
            raise ValueError(
                f"split shapes ({hot.shape[0]}, {cold.shape[0]}) do not "
                f"match placement (hot={self.hot}, cold_pad={self.cold_pad})")
        full = np.empty((self.vocab_size,) + hot.shape[1:], hot.dtype)
        full[:self.hot] = hot
        full[self.hot:] = cold[self._perm()[:self.cold]]
        return full

    # -- checkpoint metadata -------------------------------------------------
    def to_extra(self) -> Dict[str, int]:
        """Serializable placement metadata stored with split checkpoints."""
        return {"vocab_size": self.vocab_size, "hot": self.hot,
                "n_shards": self.n_shards}

    @classmethod
    def from_extra(cls, extra: Dict[str, Any]) -> "VocabPlacement":
        """Rebuild the placement a checkpoint was written under."""
        return cls(vocab_size=int(extra["vocab_size"]),
                   hot=int(extra["hot"]), n_shards=int(extra["n_shards"]))


@dataclasses.dataclass
class VocabExchange:
    """One batch's exchange plan: remapped index arrays + request lists.

    ``tokens``/``negs`` (and ``plan_uniq`` when the batch carries a window-
    tile plan) are rewritten into each shard's *working-table* index space:
    hot ids keep their global index (the hot head is the working table's
    prefix), and the shard's r-th distinct cold id maps to ``hot + r``. The
    device step reassembles exactly this working table — hot replica rows
    followed by the gathered cold rows, in request order — so the kernels
    run unchanged on a compact ``(hot + R, d)`` table.

    ``cold_ids[s]`` lists shard s's distinct cold ids (first-seen order,
    -1 padded to the common width R).

    ``bucket_ids``/``bucket_pos`` re-sort each request list into per-owner
    *capacity buckets* for the request-exact ``all_to_all`` exchange:
    ``bucket_ids[s, o]`` holds the subset of ``cold_ids[s]`` owned by shard
    ``o`` (-1 padded to the common capacity C), and ``bucket_pos[s, o]``
    each id's position within shard s's gathered working block (so the
    served rows scatter straight back into request order; pad slots point
    one past the end, R, and are dropped). Because ownership is a partition
    of the request list, ``sum_o count(s, o) == n_distinct[s]`` and the
    positions of a shard's valid slots are a permutation of
    ``range(n_distinct[s])``.
    """

    placement: VocabPlacement
    tokens: np.ndarray                     # (S, L) int32, remapped
    negs: np.ndarray                       # (S, L, N) int32, remapped
    lengths: np.ndarray                    # (S,) int32 (unchanged)
    cold_ids: np.ndarray                   # (n_shards, R) int32, -1 padded
    n_distinct: List[int]                  # real request count per shard
    bucket_ids: np.ndarray = None          # (n, n, C) int32, -1 padded
    bucket_pos: np.ndarray = None          # (n, n, C) int32, R padded
    plan_uniq: Optional[np.ndarray] = None     # remapped tile plan rows
    plan_scatter: Optional[np.ndarray] = None  # (unchanged)
    plan_ucount: Optional[np.ndarray] = None
    plan_strict: Optional[np.ndarray] = None
    # frontend extras (DESIGN.md §12), remapped like tokens/negs with -1
    # (no doc / bag pad) preserved. Extras occupy the zero-count table
    # tail, so they are always cold rows and always ride the exchange.
    docs: Optional[np.ndarray] = None          # (S,) static ctx rows
    bags: Optional[np.ndarray] = None          # (S, L, B) member rows

    @property
    def request_width(self) -> int:
        """R — padded distinct-cold-rows-per-shard this batch."""
        return int(self.cold_ids.shape[1])

    @property
    def bucket_capacity(self) -> int:
        """C — padded per-(requester, owner) bucket width this batch."""
        return int(self.bucket_ids.shape[2])

    @property
    def bucket_real(self) -> int:
        """Real (unpadded) bucket entries across all shards — equals
        ``sum(n_distinct)`` since ownership partitions each request list."""
        return int((self.bucket_ids >= 0).sum())

    @property
    def bucket_occupancy(self) -> float:
        """Fill fraction of the padded bucket tensor: real entries over
        ``n² · C`` slots. The complement is pure padding overhead that the
        all_to_all still moves; ``benchmarks/bench_memory.py`` tracks it."""
        return self.bucket_real / float(self.bucket_ids.size or 1)

    @staticmethod
    def row_bytes(dim: int, dtype: str = "float32") -> int:
        """Wire bytes per exchanged row in storage dtype ``dtype``
        (DESIGN.md §11): f32 ``4d``, bf16 ``2d``, int8 ``d + 4`` — the
        quantized payload plus its per-row f32 scale, which travels in a
        sibling ``all_to_all`` on the exact path."""
        itemsize = {"float32": 4, "bfloat16": 2, "int8": 1}[dtype]
        return dim * itemsize + (4 if dtype == "int8" else 0)

    def bytes_exchanged(self, dim: int, itemsize: int = 4,
                        dtype: Optional[str] = None) -> int:
        """Ideal per-step *payload* volume summed over the mesh: each
        distinct cold row crosses the interconnect twice per table (value
        gather + update write-back), for both ``w_in`` and ``w_out`` —
        O(distinct rows), never O(V). ``dtype`` prices the rows in their
        storage precision (overrides ``itemsize``)."""
        row = self.row_bytes(dim, dtype) if dtype else dim * itemsize
        return sum(self.n_distinct) * row * 2 * 2

    def bytes_device_dense(self, dim: int, itemsize: int = 4) -> int:
        """Per-device bytes the PR 5 *dense* exchange moved: all_gather +
        psum_scatter materialize every shard's full padded request list on
        every device — ``n · R`` rows per direction per table, an n-fold
        constant over the payload (DESIGN.md §8). Always f32: the dense
        reference path dequantizes *before* its collectives (psum_scatter
        must sum in f32), so quantized storage buys it nothing on the
        wire."""
        n = self.placement.n_shards
        return n * self.request_width * dim * itemsize * 2 * 2

    def bytes_device_exact(self, dim: int, itemsize: int = 4,
                           dtype: Optional[str] = None) -> int:
        """Per-device bytes of the request-exact bucketed ``all_to_all``:
        ``n · C ≈ R`` rows per direction per table (capacity padding is the
        only slack — bounded by ``bucket_occupancy``), so per-device
        traffic is O(distinct · d) regardless of mesh size. ``dtype``
        prices the rows in their storage precision — the exact path moves
        rows *quantized* (int8 payload + f32 scale, or bf16), which is
        where the §11 2×/4× exchange-byte reduction lands."""
        n = self.placement.n_shards
        row = self.row_bytes(dim, dtype) if dtype else dim * itemsize
        return n * self.bucket_capacity * row * 2 * 2

    def step_inputs(self, lr, device, put=None, mesh=None) -> "Any":
        """Lift onto ``device`` as a vocab-sharded ``StepInputs`` (the
        port's ``repro_torch.kernels.registry.StepInputs``). Under a
        ``mesh`` (``repro_torch.launch.mesh.DataMesh``, one rank per
        shard) only this rank's part: its block of sentences
        (``batching.rank_rows``) and its ``(1, ...)`` row of ``cold_ids``
        and ``bucket_*``; without one every row. ``put`` (numpy array ->
        device tensor) replaces the blocking copy, e.g. with the trainer's
        pinned, non_blocking one."""
        # local import: keeps this module torch-free until a step is built
        # (process prefetch workers import it and never torch)
        import torch

        from repro_torch.data.batching import rank_rows
        from repro_torch.kernels.registry import StepInputs, frontend_inputs
        n = self.placement.n_shards
        if mesh is not None and mesh.size != n:
            raise ValueError(f"an exchange planned for {n} shards lifts on "
                             f"a mesh of {n} ranks, got {mesh.size}")
        rows = rank_rows(self.tokens.shape[0], mesh)
        me = slice(0, n) if mesh is None else slice(mesh.rank,
                                                    mesh.rank + 1)
        if put is None:
            def put(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        kw = {}
        if self.plan_uniq is not None:
            kw = dict(plan_uniq=put(self.plan_uniq[rows]),
                      plan_scatter=put(self.plan_scatter[rows]),
                      plan_ucount=put(self.plan_ucount[rows]),
                      plan_strict=put(self.plan_strict[rows]))
        kw.update(frontend_inputs(self, rows, put))
        return StepInputs(tokens=put(self.tokens[rows]),
                          negs=put(self.negs[rows]),
                          lengths=put(self.lengths[rows]),
                          lr=torch.tensor(float(lr), dtype=torch.float32),
                          cold_ids=put(self.cold_ids[me]),
                          bucket_ids=put(self.bucket_ids[me]),
                          bucket_pos=put(self.bucket_pos[me]), **kw)


def plan_exchange(batch, placement: VocabPlacement) -> VocabExchange:
    """Build the per-shard row-exchange plan for one host batch.

    For each of the ``n_shards`` sentence shards (contiguous row blocks of
    the batch, matching the ``P("data")`` sharding the trainer applies),
    collect the distinct cold ids its tokens, negatives, and tile-plan rows
    touch — first-seen order, the ``plan_tiles`` dedup rule lifted from one
    window tile to a whole shard — and remap every index array into the
    shard's compact working-table space.
    """
    from repro_torch.data.batching import first_seen_unique

    n = placement.n_shards
    hot = placement.hot
    s_total = batch.tokens.shape[0]
    if s_total % n != 0:
        raise ValueError(
            f"batch of {s_total} sentences does not shard over {n} devices; "
            f"set cfg.sentences_per_batch to a multiple of the data axis")
    per = s_total // n

    tokens = batch.tokens.copy()
    negs = batch.negs.copy()
    plan = batch.plan
    uniq = plan.uniq.copy() if plan is not None else None
    docs = getattr(batch, "docs", None)
    docs = docs.copy() if docs is not None else None
    bags = getattr(batch, "bags", None)
    bags = bags.copy() if bags is not None else None

    lists: List[np.ndarray] = []
    for s in range(n):
        sl = slice(s * per, (s + 1) * per)
        parts = [tokens[sl].ravel(), negs[sl].ravel()]
        if uniq is not None:
            parts.append(uniq[sl].ravel())
        if docs is not None:
            parts.append(docs[sl].ravel())
        if bags is not None:
            parts.append(bags[sl].ravel())
        flat = np.concatenate(parts)
        # `>= hot` also drops the -1 pads docs/bags carry
        lists.append(first_seen_unique(flat[flat >= hot]).astype(np.int64))

    width = max(max((len(li) for li in lists), default=0), 1)
    width = -(-width // _REQUEST_PAD) * _REQUEST_PAD
    cold_ids = np.full((n, width), -1, dtype=np.int32)

    # one shared remap table, patched per shard with only that shard's
    # request list (O(distinct) per shard, not O(V)): hot ids map to
    # themselves; unseen cold ids map to 0 (a hot row) — they never occur
    # in the shard's arrays by construction, so any hit means a planner
    # bug, which the bit-parity tests would surface immediately
    remap = np.arange(placement.vocab_size, dtype=np.int32)
    remap[hot:] = 0
    for s, li in enumerate(lists):
        sl = slice(s * per, (s + 1) * per)
        cold_ids[s, :len(li)] = li
        remap[li] = hot + np.arange(len(li), dtype=np.int32)
        tokens[sl] = remap[tokens[sl]]
        negs[sl] = remap[negs[sl]]
        if uniq is not None:
            uniq[sl] = remap[uniq[sl]]
        if docs is not None:
            docs[sl] = _remap_masked(remap, docs[sl])
        if bags is not None:
            bags[sl] = _remap_masked(remap, bags[sl])
        remap[li] = 0   # restore for the next shard

    bucket_ids, bucket_pos = _plan_buckets(lists, placement, width)

    kw = {}
    if plan is not None:
        kw = dict(plan_uniq=uniq, plan_scatter=plan.scatter,
                  plan_ucount=plan.ucount, plan_strict=plan.strict)
    return VocabExchange(placement=placement, tokens=tokens, negs=negs,
                         lengths=batch.lengths, cold_ids=cold_ids,
                         n_distinct=[len(li) for li in lists],
                         bucket_ids=bucket_ids, bucket_pos=bucket_pos,
                         docs=docs, bags=bags, **kw)


def _remap_masked(remap: np.ndarray, arr: np.ndarray) -> np.ndarray:
    """Apply the working-table remap, preserving -1 sentinels (missing doc
    row / bag padding) instead of reading ``remap[-1]``."""
    return np.where(arr >= 0, remap[np.maximum(arr, 0)], -1)


def _plan_buckets(lists: List[np.ndarray], placement: VocabPlacement,
                  width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Re-sort per-shard request lists into per-owner capacity buckets.

    Returns ``(bucket_ids, bucket_pos)``, both ``(n, n, C)``:
    ``bucket_ids[s, o]`` is the sub-list of shard s's requests owned by
    shard o (-1 padded), ``bucket_pos[s, o]`` each id's first-seen position
    in shard s's request list (pad slots hold ``width`` — one past the
    gathered block — so a ``mode="drop"`` scatter discards them). C is the
    max per-owner count over all ``(s, o)`` pairs, rounded up to
    ``_BUCKET_PAD`` so shapes stay static across a run's typical batches.
    """
    n, hot = placement.n_shards, placement.hot
    owners = [((li - hot) % n).astype(np.int64) for li in lists]
    cap = max((int(np.max(np.bincount(ow, minlength=n), initial=0))
               for ow in owners if ow.size), default=0)
    cap = max(-(-max(cap, 1) // _BUCKET_PAD) * _BUCKET_PAD, _BUCKET_PAD)
    bucket_ids = np.full((n, n, cap), -1, dtype=np.int32)
    bucket_pos = np.full((n, n, cap), width, dtype=np.int32)
    for s, (li, ow) in enumerate(zip(lists, owners)):
        for o in range(n):
            pos = np.nonzero(ow == o)[0]
            bucket_ids[s, o, :len(pos)] = li[pos]
            bucket_pos[s, o, :len(pos)] = pos
    return bucket_ids, bucket_pos
