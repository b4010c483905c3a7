"""doc2vec (PV-DM) frontend: a document id as an extra context row.

Le & Mikolov's distributed-memory paragraph vectors extend each context
window with a paragraph (document) row that is *always in window*. Here
that is the engine's ``static_ctx`` feature: the corpus carries a
per-sentence ``doc_ids`` list, the batching pipeline threads each
sentence's doc through as ``Batch.docs`` (already mapped into table-extra
space ``vocab.size + doc``), and the plain versions (``kernels/ref.py``;
no CUDA kernel consumes the row) append the doc row as one more context
row to every window of the sentence — loaded once per sentence, written
back once, bit-identically in the sequential and the T=1 tiled paths.

Doc rows live past the vocabulary in the embedding table
(``pipeline.extra_rows = n_docs``) with zero occurrence counts, so under
vocab sharding they always stripe into the cold tail and ride the
request-exact exchange, and negative sampling (word unigrams) can never
draw them. Stream packing (``cfg.ignore_delimiters``) flushes at document
boundaries — no pseudo-sentence ever spans two documents.

The port's copy of ``repro.frontends.doc2vec``: the same corpora, bit for
bit.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.corpus import Corpus
from repro_torch.frontends.registry import FrontendSpec, Workload, register


def document_corpus(n_docs: int = 64, sents_per_doc: int = 24,
                    n_clusters: int = 16, words_per_cluster: int = 32,
                    mean_len: int = 16, purity: float = 0.9,
                    seed: int = 0) -> Corpus:
    """Planted-topic *document* corpus: document d draws ~``purity`` of its
    words from cluster ``d % n_clusters``, so same-topic documents share
    vocabulary — a correct PV-DM run embeds their doc vectors nearby (and
    word vectors still cluster, so ``core.quality`` applies unchanged)."""
    rng = np.random.default_rng(seed)
    v = n_clusters * words_per_cluster
    clusters = np.repeat(np.arange(n_clusters), words_per_cluster)
    sentences: List[List[int]] = []
    doc_ids: List[int] = []
    for d in range(n_docs):
        c = d % n_clusters
        for _ in range(sents_per_doc):
            ln = max(4, rng.poisson(mean_len))
            in_cluster = rng.random(ln) < purity
            words = np.where(
                in_cluster,
                c * words_per_cluster + rng.integers(
                    0, words_per_cluster, ln),
                rng.integers(0, v, ln),
            )
            sentences.append(words.astype(np.int64).tolist())
            doc_ids.append(d)
    return Corpus(sentences=sentences, vocab_size=v, clusters=clusters,
                  doc_ids=doc_ids)


def _build(cfg: W2VConfig, *, docs: int = 64, sents_per_doc: int = 24,
           clusters: int = 16, words_per_cluster: int = 32,
           mean_len: int = 16, seed: int = 0, **_ignored) -> Workload:
    corpus = document_corpus(
        n_docs=docs, sents_per_doc=sents_per_doc, n_clusters=clusters,
        words_per_cluster=words_per_cluster, mean_len=mean_len, seed=seed)
    n_docs = int(max(corpus.doc_ids)) + 1
    # min_count=1: a dropped word would not shift doc ids, but tiny test
    # corpora should not silently lose vocabulary either
    cfg = dataclasses.replace(cfg, min_count=1)

    def prepare(pipeline) -> None:
        # one table row per document, appended past the vocabulary
        pipeline.extra_rows = n_docs

    return Workload(name="doc2vec", corpus=corpus, cfg=cfg,
                    features=("static_ctx",), prepare=prepare)


register(FrontendSpec(
    name="doc2vec",
    description="PV-DM: per-document row injected into every window",
    corpus="documents (sentences + doc ids)",
    features=("static_ctx",),
    build=_build))
