"""Corpus sources.

Text8 / One-Billion-Words are not redistributable in this offline container
(DESIGN.md §7); we generate synthetic corpora that match their statistical
profile for throughput work (Zipf-distributed unigrams) and add *planted
cluster structure* for embedding-quality measurement (the Table-7 analogue:
words in the same latent topic co-occur, so a correct SGNS implementation
must embed them nearby).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Corpus:
    """A corpus is a list of sentences; each sentence a list of raw tokens
    (strings or ints — the vocab maps them)."""
    sentences: List[List[int]]
    vocab_size: int
    # ground-truth cluster id per word (synthetic corpora only)
    clusters: Optional[np.ndarray] = None
    # per-sentence document id (doc2vec frontend, DESIGN.md §12): when set,
    # len(doc_ids) == len(sentences) and the batching pipeline threads each
    # sentence's doc through to ``Batch.docs`` as an always-in-window static
    # context row. Stream packing (ignore_delimiters) flushes at document
    # boundaries so no pseudo-sentence spans two documents.
    doc_ids: Optional[List[int]] = None

    def __post_init__(self):
        if (self.doc_ids is not None
                and len(self.doc_ids) != len(self.sentences)):
            raise ValueError(
                f"doc_ids has {len(self.doc_ids)} entries for "
                f"{len(self.sentences)} sentences")

    @property
    def n_words(self) -> int:
        return sum(len(s) for s in self.sentences)


def synthetic_zipf_corpus(
    vocab_size: int = 10_000,
    n_sentences: int = 2_000,
    mean_len: int = 20,
    zipf_a: float = 1.2,
    seed: int = 0,
) -> Corpus:
    """Zipf-distributed token stream, shaped like Text8's frequency profile."""
    rng = np.random.default_rng(seed)
    lens = np.maximum(2, rng.poisson(mean_len, n_sentences))
    ranks = rng.zipf(zipf_a, size=int(lens.sum()))
    toks = np.minimum(ranks - 1, vocab_size - 1).astype(np.int64)
    out, i = [], 0
    for ln in lens:
        out.append(toks[i:i + ln].tolist())
        i += ln
    return Corpus(out, vocab_size)


def synthetic_cluster_corpus(
    n_clusters: int = 16,
    words_per_cluster: int = 32,
    n_sentences: int = 4_000,
    mean_len: int = 16,
    purity: float = 0.9,
    seed: int = 0,
) -> Corpus:
    """Planted-topic corpus: each sentence draws ~`purity` of its words from
    one latent cluster, the rest uniformly. SGNS must embed same-cluster
    words closer than cross-cluster words — `core.quality` measures it."""
    rng = np.random.default_rng(seed)
    v = n_clusters * words_per_cluster
    clusters = np.repeat(np.arange(n_clusters), words_per_cluster)
    sentences = []
    for _ in range(n_sentences):
        ln = max(4, rng.poisson(mean_len))
        c = rng.integers(n_clusters)
        in_cluster = rng.random(ln) < purity
        words = np.where(
            in_cluster,
            c * words_per_cluster + rng.integers(0, words_per_cluster, ln),
            rng.integers(0, v, ln),
        )
        sentences.append(words.astype(np.int64).tolist())
    return Corpus(sentences, v, clusters=clusters)

