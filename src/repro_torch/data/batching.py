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
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.corpus import Corpus
from repro_torch.data.negatives import NegativeSampler
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

    def step_inputs(self, lr, device, put=None, mesh=None) -> "StepInputs":
        """Lift this host batch onto ``device`` as the engine API's
        ``repro_torch.kernels.registry.StepInputs``, tile plan included
        (``put``: see ``StepInputs.from_batch``); under a ``mesh`` only
        this rank's block of sentences (:func:`rank_rows`)."""
        # local import: keeps this module torch-free until a step is built
        # (process prefetch workers import it and never torch)
        from repro_torch.kernels.registry import StepInputs
        return StepInputs.from_batch(self, lr, device, put=put, mesh=mesh)


@dataclasses.dataclass
class BatchingStats:
    """Host batching throughput counters.

    ``seconds`` measures *steady-state batching only*: the clock starts when
    the first batch begins to be produced, so pipeline construction (vocab
    build, alias-table build) and time spent suspended waiting on the
    consumer never count. ``words_per_sec`` is therefore the Table-1 number
    — what the host stage can sustain — not an end-to-end figure diluted by
    one-time setup.
    """
    words: int = 0
    seconds: float = 0.0

    @property
    def words_per_sec(self) -> float:
        return self.words / self.seconds if self.seconds else float("inf")


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


def finalize_packed(packed: PackedBatch, cfg: W2VConfig,
                    sampler: NegativeSampler, epoch: int,
                    placement=None, bag_table=None) -> Batch:
    """Stage 3: negatives + tile plan (+ vocab-sharding exchange plan when
    ``placement`` is given; + bag materialization when the pipeline carries
    a ``bag_table``) for one packed batch. Pure given ``(packed, cfg,
    sampler table, epoch, placement, bag_table)`` — the keyed rng means any
    worker, in any order, produces the identical Batch, and
    ``plan_exchange`` is rng-free, so the attached exchange inherits the
    same determinism."""
    toks, lens = packed.tokens, packed.lengths
    docs = packed.docs
    rng = negatives_rng(cfg.seed, epoch, packed.index)
    if cfg.tile_windows > 1:
        # tile-shared negatives (Ji et al. HogBatch): one N-set per T
        # consecutive windows — the dedup win of the tiled kernel
        negs = sampler.sample_batch_tiled(
            toks, cfg.negatives, cfg.tile_windows, lens, rng=rng)
    else:
        negs = sampler.sample_batch(toks, cfg.negatives, rng=rng)
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
                  index=packed.index)
    if placement is not None:
        # local import: the planner imports this module (first_seen_unique)
        from repro_torch.distributed.vocab_placement import plan_exchange
        batch.exchange = plan_exchange(batch, placement)
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
    def _packed(self, pad_len: Optional[int], epoch: int,
                timed: bool = True) -> Iterator[PackedBatch]:
        """Assemble the epoch's encoded stream into indexed (S, L) token
        blocks. Deterministic given (corpus, cfg, epoch) — both pipelines
        share it, so their batch indexing agrees by construction."""
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
        stream = self._encoded_stream(epoch)
        while True:
            t0 = time.perf_counter()
            item = next(stream, None)
            if timed:   # encode+subsample time counts as batching work
                self.stats.seconds += time.perf_counter() - t0
            if item is None:
                break
            sent, doc = item
            t0 = time.perf_counter()
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
                    if timed:
                        self.stats.seconds += time.perf_counter() - t0
                    yield PackedBatch(index, toks, lens, 0,
                                      docs=docs if with_docs else None)
                    index += 1
                    toks = np.zeros((S, L), np.int32)
                    lens = np.zeros((S,), np.int32)
                    docs = np.full((S,), -1, np.int32)
                    row = 0
                    t0 = time.perf_counter()
            if timed:
                self.stats.seconds += time.perf_counter() - t0
        if row:
            yield PackedBatch(index, toks[:row], lens[:row], S - row,
                              docs=docs[:row] if with_docs else None)

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
            t0 = time.perf_counter()
            batch = finalize_packed(packed, self.cfg, self.sampler, epoch,
                                    self.placement, self.bag_table)
            self.stats.seconds += time.perf_counter() - t0
            self.stats.words += batch.n_words
            yield batch

    @property
    def epoch_words(self) -> int:
        """Approximate trainable words per epoch (post min-count)."""
        return self.vocab.total
