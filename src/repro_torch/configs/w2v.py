"""Word2Vec (FULL-W2V) hyperparameter config — the paper's own workload.

Defaults follow the paper's evaluation setup (§5.1): d=128, N=5, W=5
(=> fixed W_f = ceil(W/2) = 3), lr=0.025 linear decay, subsample t=1e-4,
min_count=5, max sentence length 1000, S=10k sentences per batch.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class W2VConfig:
    dim: int = 128
    window: int = 5                 # W; the kernel uses fixed W_f = ceil(W/2)
    negatives: int = 5              # N
    lr: float = 0.025
    min_lr_frac: float = 1e-4       # linear decay floor (fraction of lr)
    epochs: int = 20
    min_count: int = 5
    subsample_t: float = 1e-4
    max_sentence_len: int = 1000
    sentences_per_batch: int = 10_000  # S (paper §4.2)
    ignore_delimiters: bool = False    # paper §4.1 stream-packing mode
    neg_table_size: int = 1 << 20
    tile_windows: int = 1              # T — windows fused per kernel step
                                       # (DESIGN.md §4; T=1 == sequential)
    tile_gemm_windows: int = 4         # G — windows per GEMM group inside a
                                       # tile (bounds value staleness)
    pad_len: int = 0                   # L — padded sentence length per batch
                                       # (jit shape reuse); 0 -> derived, see
                                       # `resolved_pad_len`
    prefetch_workers: int = 0          # host pipeline workers (0 = fully
                                       # synchronous batching, DESIGN.md §4.1)
    prefetch_depth: int = 2            # bounded queue: finalized batches in
                                       # flight ahead of the device step
    prefetch_mode: str = "thread"      # "thread" (GIL-releasing numpy
                                       # finalize) or "process" (python-heavy
                                       # encode workloads)
    vocab_shard: bool = False          # shard the cold vocabulary tail over
                                       # the mesh data axis; the Zipf-hot
                                       # head stays replicated (DESIGN.md §8)
    hot_vocab_frac: float = 0.0        # replicated head as a fraction of V;
                                       # 0 -> smallest prefix covering
                                       # VOCAB_HOT_COVERAGE (~90%) of corpus
                                       # occurrences
    tables: str = ""                   # table storage spec, e.g.
                                       # "hot=bf16:frac=0.1,cold=int8" —
                                       # parsed by kernels.tables.parse into
                                       # the session TableSpec (DESIGN.md
                                       # §11); "" -> f32 tables from the
                                       # legacy vocab_shard/hot_vocab_frac
                                       # knobs above
    seed: int = 0

    @property
    def fixed_window(self) -> int:
        """W_f = ceil(W/2) — FULL-W2V's fixed context width (§3.2)."""
        return (self.window + 1) // 2

    @property
    def resolved_pad_len(self) -> int:
        """The padded batch length the training session uses: ``pad_len``
        when set, else ``min(max_sentence_len, 1024)`` (the jit shape-reuse
        cap long sentences are chunked into)."""
        return self.pad_len if self.pad_len > 0 else min(
            self.max_sentence_len, 1024)


def resolve_gemm_windows(tile: int, gemm_windows: int = 0) -> int:
    """Resolve the G knob (windows per GEMM group, DESIGN.md §4): 0 means
    the default min(tile, 4); always clamped to the tile size. Single source
    of truth for kernel, oracle, cost model, and benchmarks."""
    g = gemm_windows if gemm_windows > 0 else min(tile, 4)
    return max(1, min(g, tile))


# Reduced config for CPU tests / examples.
def smoke(**kw) -> W2VConfig:
    base = dict(dim=32, window=3, negatives=3, epochs=1,
                min_count=1, sentences_per_batch=64, max_sentence_len=64,
                subsample_t=0.0)  # tiny corpora: every word is "frequent"
    base.update(kw)
    return W2VConfig(**base)
