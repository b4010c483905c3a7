"""The CPU "batching" component of FULL-W2V (paper §4.1, Table 1).

A numpy copy of ``repro.data.batching``: batches and tile plans are
bit-identical to the reference's for the same (corpus, cfg, epoch, index).
Only the device lift (:meth:`Batch.step_inputs`) differs — it builds the
port's torch ``StepInputs``. Vocab-sharding exchange plans ride along
(``Batch.exchange``), and so do the frontends' doc rows (``Batch.docs``)
and subword bags (``Batch.bags``, materialized from the pipeline's
``bag_table``).

Responsibilities (all host-side, exactly as the paper assigns them):
  * encode + subsample sentences,
  * optionally ignore sentence delimiters (stream packing — paper §4.1:
    "<0.5% additional word pairings", better utilization),
  * pack sentences into fixed-shape (S, L) int32 batches + lengths,
  * pre-sample per-window negatives (S, L, N) with the distinctness
    invariant the kernel relies on,
  * conflict-aware window tiling (DESIGN.md §4): group T consecutive
    windows per kernel step, deduplicate the tile's T·(N+1) output rows
    into a compacted unique-row list + scatter map, and flag tiles whose
    output rows collide across windows (``strict``) so the kernel can
    fall back to the exact sequential path for them.

The device step consumes dense arrays only — no indirection on-device.

Randomness is *keyed*, not streamed (DESIGN.md §4.1): subsampling draws
depend only on ``(seed, epoch, sentence_block)`` and negative draws only on
``(seed, epoch, batch_index)``. Every batch is therefore a pure function of
``(corpus, cfg, epoch, batch_index)`` — which is what lets the async
pipeline (``data/prefetch.py``) farm finalization out to any number of
workers in any order and still emit a stream bit-identical to this
synchronous pipeline, and what makes mid-epoch resume exact
(``skip_batches`` skips work, not randomness).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import spans as spans_mod
from repro_torch.configs.w2v import W2VConfig, resolve_gemm_windows
from repro_torch.data.corpus import Corpus
from repro_torch.data.negatives import DrawTally, NegativeSampler
from repro_torch.data.vocab import Vocab

# Sentences per subsampling-rng key (and per async encode work unit). Fixed:
# changing it changes the subsample stream (it is part of the data layout,
# like sentences_per_batch), so it is a module constant, not a config knob.
ENCODE_BLOCK = 256

# Domain-separation tags so the subsample and negative streams never collide
# even where their (epoch, index) coordinates do.
_SUBSAMPLE_TAG = 0x5B5A
_NEGATIVES_TAG = 0x4E45


def subsample_rng(seed: int, epoch: int, block_index: int
                  ) -> np.random.Generator:
    """The keyed subsampling stream for one ENCODE_BLOCK of sentences."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, _SUBSAMPLE_TAG, epoch, block_index]))


def negatives_rng(seed: int, epoch: int, batch_index: int
                  ) -> np.random.Generator:
    """The keyed negative-sampling stream for one batch."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, _NEGATIVES_TAG, epoch, batch_index]))


def first_seen_unique(flat: np.ndarray) -> np.ndarray:
    """Distinct values of ``flat`` in first-occurrence order.

    The same dedup rule :func:`plan_tiles` applies to a window tile's
    output slots, exposed for callers that dedup at other granularities —
    the vocab-sharding exchange planner applies it per shard
    (``distributed.vocab_placement.plan_exchange``) so each shard's working
    table lays rows out in the order its sentences first touch them.
    """
    _, idx = np.unique(flat, return_index=True)
    return flat[np.sort(idx)]


def rank_rows(n_rows: int, mesh) -> slice:
    """This rank's block of a batch's ``n_rows`` sentences: rows ``[r·S/n,
    (r+1)·S/n)`` of rank ``r`` of ``mesh`` (every row without a mesh), as
    the reference's ``P("data")`` sharding cuts them."""
    if mesh is None:
        return slice(0, n_rows)
    n = mesh.size
    if n_rows % n != 0:
        raise ValueError(
            f"batch of {n_rows} sentences does not shard over {n} devices; "
            f"set cfg.sentences_per_batch to a multiple of the data axis")
    per = n_rows // n
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def encode_block(vocab: Vocab, sentences: Sequence[Sequence],
                 subsample_t: float, rng: np.random.Generator
                 ) -> List[np.ndarray]:
    """Encode + subsample one block of raw sentences. Pure given the
    rng."""
    return [vocab.subsample_ids(vocab.encode_ids(s), subsample_t, rng)
            for s in sentences]


@dataclasses.dataclass
class TilePlan:
    """Host-side schedule for the tiled kernel (`_kernel_tiled`).

    A *tile* is ``tile`` consecutive window positions of one sentence. Its
    output rows are the T targets + T·N negatives, laid out slot-major:
    slot ``w*(N+1) + 0`` is window ``t0+w``'s target, slots ``w*(N+1)+1..N``
    its negatives. The plan compacts those slots to unique vocab rows so the
    kernel fetches/writes each row exactly once per tile (write-once).

    Collision policy (DESIGN.md §4): a *negative* repeated across windows is
    fused — it is exactly pWord2Vec's shared-negative relaxation lifted from
    one window to T, and dedup keeps the fetch/write-once invariant. A
    repeat that touches a *target* slot (target/target, or target appearing
    as another window's negative) conflicts on the positive label and is
    where the pre-tile-value relaxation distorts most, so those tiles are
    marked ``strict`` and replayed sequentially by the kernel.
    """
    tile: int             # T — windows per tile
    uniq: np.ndarray      # (S, nt, T*(N+1)) int32 — unique rows, first-seen
                          # order; columns >= ucount are 0 (masked)
    scatter: np.ndarray   # (S, nt, T*(N+1)) int32 — slot -> column in uniq;
                          # slots of windows beyond the sentence map to 0
    ucount: np.ndarray    # (S, nt) int32 — number of valid uniq columns
    strict: np.ndarray    # (S, nt) int32 — 1 iff a repeated row involves a
                          # *target* slot (sequential fallback; see below)

    @property
    def n_tiles(self) -> int:
        return self.uniq.shape[1]


def plan_tiles(tokens: np.ndarray, negs: np.ndarray, lengths: np.ndarray,
               tile: int) -> TilePlan:
    """Build the conflict-aware tile schedule for a batch.

    Fully vectorised (no per-tile Python loop): first-seen-order dedup is
    computed with a stable argsort per tile row. First-seen order matters —
    it makes the T=1 plan lay rows out exactly as the sequential kernel
    ([target, neg_1..neg_N]), which is what makes `_kernel_tiled` at T=1
    bit-identical to `_kernel`.
    """
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    S, L = tokens.shape
    N = negs.shape[-1]
    m = N + 1
    nt = -(-L // tile)                    # ceil(L / tile)
    Lp = nt * tile
    M = tile * m                          # output slots per tile

    tk = np.pad(tokens, ((0, 0), (0, Lp - L))).astype(np.int64)
    ng = np.pad(negs, ((0, 0), (0, Lp - L), (0, 0))).astype(np.int64)
    slots = np.concatenate([tk[..., None], ng], axis=-1)   # (S, Lp, m)
    rows = slots.reshape(S * nt, M)
    valid = (np.arange(Lp)[None, :] < lengths[:, None])    # (S, Lp) windows
    valid = np.repeat(valid[..., None], m, axis=-1).reshape(S * nt, M)

    # Invalid slots (windows past the sentence end — always a suffix of the
    # tile) get one shared sentinel that first-occurs after every valid slot,
    # so its dedup group lands past the valid columns.
    sentinel = np.int64(1) << 40
    rows = np.where(valid, rows, sentinel)

    B = S * nt
    ar = np.arange(M)[None, :]
    order = np.argsort(rows, axis=1, kind="stable")        # (B, M)
    srt = np.take_along_axis(rows, order, axis=1)
    new = np.ones((B, M), dtype=bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    # index (sorted order) of each value's group start, forward-filled
    gstart = np.maximum.accumulate(np.where(new, ar, 0), axis=1)
    # original slot of each value's first occurrence (stable sort => min slot)
    first_sorted = np.take_along_axis(order, gstart, axis=1)
    fs = np.empty((B, M), dtype=np.int64)
    np.put_along_axis(fs, order, first_sorted, axis=1)     # per-slot first
    is_first = fs == ar
    ranks = np.cumsum(is_first, axis=1) - 1                # first-seen rank
    cols = np.take_along_axis(ranks, fs, axis=1)           # slot -> column

    ucount = (is_first & valid).sum(axis=1)
    # per-slot multiplicity of the slot's dedup group (valid slots only)
    occ = np.zeros((B, M), dtype=np.int32)
    np.add.at(occ, (np.arange(B)[:, None], cols), valid.astype(np.int32))
    slot_mult = np.take_along_axis(occ, cols, axis=1)
    is_target = (np.arange(M) % m == 0)[None, :]
    strict = ((slot_mult > 1) & is_target & valid).any(axis=1)
    strict = strict.astype(np.int32)

    uniq = np.zeros((B, M), dtype=np.int64)
    np.put_along_axis(uniq, cols, rows, axis=1)
    uniq[ar >= ucount[:, None]] = 0                        # mask padding
    scatter = np.where(valid, cols, 0)

    return TilePlan(
        tile=tile,
        uniq=uniq.reshape(S, nt, M).astype(np.int32),
        scatter=scatter.reshape(S, nt, M).astype(np.int32),
        ucount=ucount.reshape(S, nt).astype(np.int32),
        strict=strict.reshape(S, nt),
    )



def plan_costs(plan: TilePlan, lengths: np.ndarray, n_neg: int,
               gemm_windows: int = 0) -> dict:
    """Exact per-batch row traffic and GEMM count of the tiled kernel,
    replayed from the plan against the kernel's runtime guards (its
    control flow is a function of the plan); the T=1 numbers are the
    sequential kernel's. The reference's function, with its keys and
    values (the reference counts in a Python loop; this one with numpy).

    Counts. One "dma" is one table row of ``d`` f32 moved between the
    tables in global memory and the kernel's shared memory or registers:
    a load is one warp's 16-byte ``cp.async`` a lane at d=128 (4 bytes a
    thread on the runtime-shaped bodies), a store ``d`` 4-byte stores
    from the threads that update the row. The ring costs one load and
    one store a position; a fused tile loads and writes back each of its
    ``ucount`` unique rows once; a strict tile's windows load and store
    their N+1 output rows each. One "gemm" is one of a step's three
    products (the pair dot products ``corr``, ``d_ctx``, ``d_out``),
    computed on the card with f32 FMA chains and warp reductions, no
    tensor core: a fused tile takes one step of G windows a GEMM group,
    a strict tile one step a window, so ``gemms / 3`` is the number of
    steps the kernel walks.

    The CUDA kernels (``csrc/seq.cuh`` K1/K2, ``csrc/tiled.cuh`` K3/K4)
    load and store exactly these rows, and no other table row:
    * K2's ``cp.async`` prefetch of window t+1's rows and K3/K4's
      cross-tile prefetch of tile i+1's unique rows move loads earlier,
      not in number. A row of the next window or tile that this one
      writes (K2's hazard mask; K3's rejected columns, ``tiled.cuh``
      440-476) is loaded once, after the stores, instead of ahead.
    * The ring lives in shared memory: each sentence position is loaded
      once as it enters the window and stored once as it leaves (K1/K2
      store position t - w_f after window t, K3/K4 the positions a step
      completes), the last ones by the flush at the sentence's end.
    They differ from the count in traffic it leaves out: each sentence's
    indices (tokens, negatives, length; for K3/K4 also the plan's
    ``uniq``, ``scatter``, ``ucount``, ``strict``) are staged into shared
    memory once, ints not rows; a row counted twice in one batch may be
    served from the 50 MB L2, so HBM may see fewer bytes than the count;
    and K4's cold rows reach it through ``_VocabShardedRun``'s gather and
    write-back, index ops outside the kernel that the count does not
    hold.
    """
    m = n_neg + 1
    T = plan.tile
    G = resolve_gemm_windows(T, gemm_windows)
    lengths = np.asarray(lengths, dtype=np.int64)
    windows = int(lengths.sum())
    ring_dmas = 2 * windows            # each position: 1 load + 1 store
    # windows of tile i inside its sentence; tiles with none are skipped
    n_valid = np.clip(lengths[:, None] - np.arange(plan.n_tiles) * T, 0, T)
    live = n_valid > 0
    strict = (plan.strict != 0) & live
    fused = ~strict & live
    out_dmas = int((2 * m * n_valid)[strict].sum()
                   + (2 * plan.ucount.astype(np.int64))[fused].sum())
    gemms = int((3 * n_valid)[strict].sum()
                + (3 * (-(-n_valid // G)))[fused].sum())
    return {
        "windows": windows,
        "dma_total": ring_dmas + out_dmas,
        "dma_ring": ring_dmas,
        "dma_out_rows": out_dmas,
        "gemms": gemms,
        "dma_per_window": (ring_dmas + out_dmas) / max(windows, 1),
        "gemms_per_window": gemms / max(windows, 1),
    }


@dataclasses.dataclass
class BatchCounters(DrawTally):
    """What making one batch took, counted always and carried on the
    :class:`Batch` (a process worker returns them inside it), so they are
    the same in every pipeline mode. The negative draws (:class:`DrawTally`)
    and the produce (encode, subsample, pack) and finalize intervals as
    ``(start, end)`` from ``time.time_ns()`` with the native id of the
    thread that ran each. Counting changes no draw."""
    real_slots: int = 0           # drawn-array slots that serve real words
    produce_ns: Tuple[int, int] = (0, 0)
    produce_thread: int = 0
    finalize_ns: Tuple[int, int] = (0, 0)
    negatives_ns: Tuple[int, int] = (0, 0)    # inside finalize
    finalize_thread: int = 0

    @property
    def produce_seconds(self) -> float:
        return (self.produce_ns[1] - self.produce_ns[0]) / 1e9

    @property
    def finalize_seconds(self) -> float:
        return (self.finalize_ns[1] - self.finalize_ns[0]) / 1e9


@dataclasses.dataclass
class Batch:
    tokens: np.ndarray    # (S, L) int32
    negs: np.ndarray      # (S, L, N) int32
    lengths: np.ndarray   # (S,) int32
    n_words: int          # real (unpadded) words in the batch
    plan: Optional[TilePlan] = None   # set when cfg.tile_windows > 1
    # frontend extras (DESIGN.md §12): per-sentence static context row
    # (doc2vec — already mapped to table-extra space ``vocab.size + doc``,
    # -1 for none) and per-position bag members (fastText subwords —
    # (S, L, B) table rows, -1 padded; positions past the sentence length
    # are all -1 so exchange request lists stay exact)
    docs: Optional[np.ndarray] = None
    bags: Optional[np.ndarray] = None
    # vocab-sharding exchange plan (distributed.vocab_placement
    # .VocabExchange), attached when the pipeline carries a placement —
    # so request dedup + capacity bucketing run in the finalize workers,
    # off the training loop's critical path
    exchange: Optional[object] = None
    # position of this batch in the keyed-randomness counter space: the
    # same (epoch, index) pair that keyed its subsample/negative draws.
    # Consumers that need more per-batch keyed randomness (the trainer's
    # stochastic storage-rounding key) derive it from these counters so it
    # replays identically at any worker count
    epoch: int = 0
    index: int = 0
    counters: BatchCounters = dataclasses.field(
        default_factory=BatchCounters)

    def step_inputs(self, lr, device, put=None, mesh=None) -> "StepInputs":
        """Lift this host batch onto ``device`` as the engine API's
        ``repro_torch.kernels.registry.StepInputs``, tile plan included
        (``put``: see ``StepInputs.from_batch``); under a ``mesh`` only
        this rank's block of sentences (:func:`rank_rows`)."""
        # local import: keeps this module torch-free until a step is built
        # (process prefetch workers import it and never torch)
        from repro_torch.kernels.registry import StepInputs
        return StepInputs.from_batch(self, lr, device, put=put, mesh=mesh)


def _counted(batch: "Batch") -> Tuple[Tuple[str, int], ...]:
    """A batch's counts, under the names a SpanRecorder keeps them while a
    profiler runs: the negative draws and the positions, real
    (``sum(lengths)``) and padded (S x L)."""
    c = batch.counters
    return (("w2v.draw.rounds", c.draw_rounds),
            ("w2v.draw.slots", c.slots_drawn),
            ("w2v.draw.real_slots", c.real_slots),
            ("w2v.positions.real", batch.n_words),
            ("w2v.positions.padded", batch.tokens.size))


@dataclasses.dataclass
class BatchingStats:
    """Host batching throughput: the words and the busy seconds of every
    batch the consumer has taken, folded in from its
    :class:`BatchCounters` as it takes each, so they mean the same in the
    synchronous and the prefetching pipelines.

    ``seconds`` is the busy time of batching: each batch's produce and
    finalize intervals, summed. Pipeline construction (vocab and alias
    table) and time suspended waiting on the consumer never count, nor does
    a prefetch worker's wait for work. ``words_per_sec`` is therefore the
    Table-1 number — what one host core sustains — not an end-to-end
    figure diluted by set-up or spread over workers.
    """
    words: int = 0
    seconds: float = 0.0

    @property
    def words_per_sec(self) -> float:
        return self.words / self.seconds if self.seconds else float("inf")

    def fold(self, batch: "Batch") -> None:
        c = batch.counters
        self.words += batch.n_words
        self.seconds += c.produce_seconds + c.finalize_seconds


@dataclasses.dataclass
class PackedBatch:
    """Stage-2 output: an assembled (rows, L) token block, pre-negatives.
    ``index`` is the batch's position in the epoch stream — the key of its
    negative-sampling rng, and the unit the async pipeline shards over."""
    index: int
    tokens: np.ndarray    # (rows, L) int32, rows <= S for the final batch
    lengths: np.ndarray   # (rows,) int32
    pad_rows: int         # rows to pad back up to S at finalize time
    docs: Optional[np.ndarray] = None   # (rows,) int32 table rows, -1 none
    epoch: int = 0
    produce_ns: Tuple[int, int] = (0, 0)   # encode+subsample+pack, time_ns
    produce_thread: int = 0


def finalize_packed(packed: PackedBatch, cfg: W2VConfig,
                    sampler: NegativeSampler, epoch: int,
                    placement=None, bag_table=None) -> Batch:
    """Stage 3: negatives + tile plan (+ vocab-sharding exchange plan when
    ``placement`` is given; + bag materialization when the pipeline carries
    a ``bag_table``) for one packed batch. Pure given ``(packed, cfg,
    sampler table, epoch, placement, bag_table)`` — the keyed rng means any
    worker, in any order, produces the identical Batch, and
    ``plan_exchange`` is rng-free, so the attached exchange inherits the
    same determinism. The batch's :class:`BatchCounters` count its draws
    and time this call."""
    t_start = time.time_ns()
    count = BatchCounters(produce_ns=packed.produce_ns,
                          produce_thread=packed.produce_thread,
                          finalize_thread=threading.get_native_id())
    toks, lens = packed.tokens, packed.lengths
    docs = packed.docs
    rng = negatives_rng(cfg.seed, epoch, packed.index)
    t_neg = time.time_ns()
    if cfg.tile_windows > 1:
        # tile-shared negatives (Ji et al. HogBatch): one N-set per T
        # consecutive windows — the dedup win of the tiled kernel
        negs = sampler.sample_batch_tiled(
            toks, cfg.negatives, cfg.tile_windows, lens, rng=rng,
            tally=count)
        real_sets = int((-(-lens.astype(np.int64) // cfg.tile_windows)).sum())
    else:
        negs = sampler.sample_batch(toks, cfg.negatives, rng=rng,
                                    tally=count)
        real_sets = int(lens.sum())
    count.negatives_ns = (t_neg, time.time_ns())
    count.real_slots = real_sets * cfg.negatives
    if packed.pad_rows:
        toks = np.pad(toks, ((0, packed.pad_rows), (0, 0)))
        negs = np.pad(negs, ((0, packed.pad_rows), (0, 0), (0, 0)))
        lens = np.pad(lens, (0, packed.pad_rows))
        if docs is not None:
            docs = np.pad(docs, (0, packed.pad_rows), constant_values=-1)
    n_words = int(lens.sum())
    plan = None
    if cfg.tile_windows > 1:
        plan = plan_tiles(toks, negs, lens, cfg.tile_windows)
    bags = None
    if bag_table is not None:
        # (S, L, B) member rows per token position; positions past the
        # sentence length masked to -1 so sharded request lists only carry
        # rows the kernel actually touches
        pos = np.arange(toks.shape[1])[None, :] < lens[:, None]
        bags = np.where(pos[..., None], bag_table[toks], -1).astype(np.int32)
    batch = Batch(tokens=toks, negs=negs, lengths=lens, n_words=n_words,
                  plan=plan, docs=docs, bags=bags, epoch=epoch,
                  index=packed.index, counters=count)
    if placement is not None:
        # local import: the planner imports this module (first_seen_unique)
        from repro_torch.distributed.vocab_placement import plan_exchange
        batch.exchange = plan_exchange(batch, placement)
    count.finalize_ns = (t_start, time.time_ns())
    return batch


class BatchingPipeline:
    def __init__(self, corpus: Corpus, cfg: W2VConfig,
                 vocab: Optional[Vocab] = None):
        self.cfg = cfg
        self.corpus = corpus
        self.vocab = vocab or Vocab.build(corpus.sentences,
                                          min_count=cfg.min_count)
        self.sampler = NegativeSampler(self.vocab.unigram_weights(),
                                       seed=cfg.seed + 1)
        self.stats = BatchingStats()
        # the span recorder; a TrainSession deposits its own here
        self.spans = spans_mod.SpanRecorder()
        # vocab-sharding placement: a sharded TrainSession deposits its
        # VocabPlacement here so finalize plans the row exchange per batch
        # (None => batches carry no exchange and the trainer plans inline)
        self.placement = None
        # frontend state (DESIGN.md §12), attached by a workload's
        # prepare(): table rows past the vocabulary (doc rows / n-gram
        # buckets, appended at [vocab.size, table_rows)), the per-word
        # bag-membership table ((V, B) int32, -1 padded; member 0 is the
        # word row itself), and the kernel features batches will carry
        self.extra_rows = 0
        self.bag_table: Optional[np.ndarray] = None
        self.frontend_features: tuple = ()
        # epoch key when batches() is called without one: each call is the
        # next epoch, mirroring TrainSession's per-epoch iteration
        self._auto_epoch = 0

    @property
    def table_rows(self) -> int:
        """Embedding-table rows the trainer must allocate: vocabulary plus
        frontend extras (doc rows, n-gram buckets)."""
        return self.vocab.size + self.extra_rows

    def table_counts(self) -> np.ndarray:
        """Occurrence counts over the full table. Frontend extras count
        zero, so ``VocabPlacement.plan`` always stripes them into the
        sharded cold tail and the negative sampler (built from the vocab's
        unigram weights alone) can never draw them."""
        if not self.extra_rows:
            return self.vocab.counts
        return np.concatenate(
            [self.vocab.counts, np.zeros(self.extra_rows, np.int64)])

    def _resolve_epoch(self, epoch: Optional[int]) -> int:
        if epoch is None:
            epoch = self._auto_epoch
        self._auto_epoch = epoch + 1
        return epoch

    # -- stage 1: encode + subsample ----------------------------------------
    def _encoded_blocks(self, epoch: int) -> Iterator[List[List[int]]]:
        """ENCODE_BLOCK-sized blocks of encoded+subsampled sentences, each
        drawn from its own keyed rng."""
        sents = self.corpus.sentences
        for start in range(0, len(sents), ENCODE_BLOCK):
            rng = subsample_rng(self.cfg.seed, epoch, start // ENCODE_BLOCK)
            yield encode_block(self.vocab, sents[start:start + ENCODE_BLOCK],
                               self.cfg.subsample_t, rng)

    def _encoded_stream(self, epoch: int
                        ) -> Iterator[Tuple[List[int], int]]:
        """Yield ``(encoded_chunk, doc)`` pairs; ``doc`` is the raw
        per-sentence document id, -1 when the corpus carries none."""
        cfg = self.cfg
        doc_ids = getattr(self.corpus, "doc_ids", None)
        n_seen = 0
        if cfg.ignore_delimiters:
            # stream-packing mode: concatenate the corpus and re-split into
            # max-length pseudo-sentences (paper §4.1)
            buf: List[int] = []
            cur = -1
            for block in self._encoded_blocks(epoch):
                for enc in block:
                    doc = doc_ids[n_seen] if doc_ids is not None else -1
                    n_seen += 1
                    if doc_ids is not None and doc != cur and buf:
                        # document boundary: flush the packing buffer. A
                        # pseudo-sentence spliced across documents would
                        # let windows near the join borrow context from
                        # the neighbouring document — exactly what the
                        # injected static doc row makes visible (and
                        # wrong: one row, two documents)
                        if len(buf) > 1:
                            yield buf, cur
                        buf = []
                    cur = doc
                    buf.extend(enc)
                    while len(buf) >= cfg.max_sentence_len:
                        yield buf[:cfg.max_sentence_len], cur
                        buf = buf[cfg.max_sentence_len:]
            if len(buf) > 1:
                yield buf, cur
        else:
            for block in self._encoded_blocks(epoch):
                for enc in block:
                    doc = doc_ids[n_seen] if doc_ids is not None else -1
                    n_seen += 1
                    for i in range(0, len(enc), cfg.max_sentence_len):
                        chunk = enc[i:i + cfg.max_sentence_len]
                        if len(chunk) > 1:
                            yield chunk, doc

    # -- stage 2: pack into fixed-shape blocks ------------------------------
    def _packed(self, pad_len: Optional[int], epoch: int
                ) -> Iterator[PackedBatch]:
        """Assemble the epoch's encoded stream into indexed (S, L) token
        blocks. Deterministic given (corpus, cfg, epoch) — both pipelines
        share it, so their batch indexing agrees by construction. Each
        block carries its produce interval: this generator's running time
        since it last yielded (encode, subsample, pack), never the time it
        sat suspended."""
        cfg = self.cfg
        L = pad_len or cfg.max_sentence_len
        S = cfg.sentences_per_batch
        with_docs = getattr(self.corpus, "doc_ids", None) is not None
        V = self.vocab.size
        toks = np.zeros((S, L), np.int32)
        lens = np.zeros((S,), np.int32)
        docs = np.full((S,), -1, np.int32)
        row = 0
        index = 0
        thread = threading.get_native_id()
        t0 = time.time_ns()
        for sent, doc in self._encoded_stream(epoch):
            chunks = [sent[i:i + L] for i in range(0, len(sent), L)]
            for chunk in chunks:
                if len(chunk) < 2:
                    continue
                toks[row, :len(chunk)] = chunk
                lens[row] = len(chunk)
                # doc rows live in table-extra space, past the vocabulary
                docs[row] = V + doc if doc >= 0 else -1
                row += 1
                if row == S:
                    yield PackedBatch(index, toks, lens, 0,
                                      docs=docs if with_docs else None,
                                      epoch=epoch,
                                      produce_ns=(t0, time.time_ns()),
                                      produce_thread=thread)
                    t0 = time.time_ns()
                    index += 1
                    toks = np.zeros((S, L), np.int32)
                    lens = np.zeros((S,), np.int32)
                    docs = np.full((S,), -1, np.int32)
                    row = 0
        if row:
            yield PackedBatch(index, toks[:row], lens[:row], S - row,
                              docs=docs[:row] if with_docs else None,
                              epoch=epoch, produce_ns=(t0, time.time_ns()),
                              produce_thread=thread)

    # -- batches ------------------------------------------------------------
    def batches(self, pad_len: Optional[int] = None,
                epoch: Optional[int] = None,
                skip_batches: int = 0) -> Iterator[Batch]:
        """One epoch of (S, L) batches. `pad_len` fixes L (jit shape reuse);
        default = cfg.max_sentence_len. Sentences longer than L are split
        into L-sized rows (dropping trailing single-word chunks, which have
        no window) — no tokens are silently truncated.

        `epoch` keys this epoch's randomness (default: one more than the
        previous call). `skip_batches` fast-forwards past the epoch's first
        k batches without finalizing them — because randomness is keyed by
        batch index, the remaining stream is bit-identical to the suffix of
        a full epoch (exact mid-epoch resume)."""
        epoch = self._resolve_epoch(epoch)
        for packed in self._packed(pad_len, epoch):
            if packed.index < skip_batches:
                continue
            batch = finalize_packed(packed, self.cfg, self.sampler, epoch,
                                    self.placement, self.bag_table)
            self._took(batch)
            yield batch

    def _took(self, batch: Batch) -> None:
        """The consumer takes ``batch``: its counters fold into
        :attr:`stats` and, under a profiler, into :attr:`spans`, its
        timings as spans keyed by the batch (``w2v.produce``;
        ``w2v.finalize`` with its child ``w2v.negatives``)."""
        self.stats.fold(batch)
        if not spans_mod.recording():
            return
        c, spans = batch.counters, self.spans
        spans.add("w2v.produce", *c.produce_ns, of=batch,
                  thread=c.produce_thread)
        fin = spans.add("w2v.finalize", *c.finalize_ns, of=batch,
                        thread=c.finalize_thread)
        spans.add("w2v.negatives", *c.negatives_ns, of=batch,
                  thread=c.finalize_thread, parent=fin)
        for name, n in _counted(batch):
            spans.count(name, n)

    @property
    def epoch_words(self) -> int:
        """Approximate trainable words per epoch (post min-count)."""
        return self.vocab.total
