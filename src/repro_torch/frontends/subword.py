"""fastText-style subword frontend: hashed n-gram bags per word.

Bojanowski et al. represent a word's input vector as the sum of its row
and the rows of its character n-grams, hashed into a fixed bucket table.
Here that is the engine's ``bags`` feature: ``prepare`` builds a
``(V, B)`` membership table from the vocabulary — member 0 is the word's
own row, the rest are ``vocab.size + (fnv1a(ngram) % buckets)``, -1
padded — and ``finalize_packed`` materializes ``Batch.bags`` per token
position. The plain versions (``kernels/ref.py``; no CUDA kernel
consumes bags) then *load* each center row as the masked
gather-sum of its members and *store* by scattering the row's delta to
every member (duplicated buckets accumulate — faithful fastText
semantics; see the buf0 delta mirror in ``kernels/ref.py``).

Bucket rows live past the vocabulary with zero counts: always in the
vocab-sharded cold tail (the bag members stress the request-exact
exchange and the mixed-precision int8 cold path), never drawn as
negatives.

The n-gram hash is FNV-1a over the UTF-8 bytes of the ``<word>``-bounded
n-gram — deterministic across processes (no PYTHONHASHSEED exposure).

The port's copy of ``repro.frontends.subword``: the same bag tables, byte
for byte.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from repro_torch.configs.w2v import W2VConfig
from repro_torch.frontends.registry import FrontendSpec, Workload, register

_FNV_OFFSET = 0x811C9DC5
_FNV_PRIME = 0x01000193


def fnv1a(data: bytes) -> int:
    """32-bit FNV-1a — the deterministic bucket hash."""
    h = _FNV_OFFSET
    for b in data:
        h = ((h ^ b) * _FNV_PRIME) & 0xFFFFFFFF
    return h


def word_ngrams(word: str, minn: int = 3, maxn: int = 5) -> List[str]:
    """Character n-grams of ``<word>`` (angle brackets mark boundaries,
    as in fastText — "<wh" and "he>" are distinct from interior "he")."""
    w = f"<{word}>"
    return [w[i:i + n]
            for n in range(minn, maxn + 1)
            for i in range(len(w) - n + 1)]


def ngram_bucket(ngram: str, buckets: int) -> int:
    """The hash bucket of one n-gram."""
    return fnv1a(ngram.encode("utf-8")) % buckets


def build_bag_table(vocab, buckets: int, minn: int = 3, maxn: int = 5,
                    max_members: int = 0) -> np.ndarray:
    """The ``(V, B)`` membership table for a built vocabulary: member 0 is
    the word row itself, members 1.. its n-gram buckets mapped past the
    vocabulary (``vocab.size + bucket``), -1 padded. ``max_members``
    truncates pathological long words (0 = no cap). Duplicate buckets
    within a word are kept — their updates accumulate, like fastText's."""
    V = vocab.size
    bags: List[List[int]] = []
    for w, i in sorted(vocab.ids.items(), key=lambda kv: kv[1]):
        grams = word_ngrams(str(w), minn, maxn)
        members = [i] + [V + ngram_bucket(g, buckets) for g in grams]
        if max_members:
            members = members[:max_members]
        bags.append(members)
    width = max(len(m) for m in bags) if bags else 1
    table = np.full((V, width), -1, dtype=np.int32)
    for i, members in enumerate(bags):
        table[i, :len(members)] = members
    return table


def _build(cfg: W2VConfig, *, vocab: int = 2048, clusters: int = 32,
           sentences: int = 8_000, mean_len: int = 20,
           buckets: int = 4096, minn: int = 3, maxn: int = 5,
           max_members: int = 0, seed: int = 0, **_ignored) -> Workload:
    from repro_torch.data.corpus import synthetic_cluster_corpus
    corpus = synthetic_cluster_corpus(
        n_clusters=clusters, words_per_cluster=max(vocab // clusters, 1),
        n_sentences=sentences, mean_len=mean_len, seed=seed)
    cfg = dataclasses.replace(cfg, min_count=1)

    def prepare(pipeline) -> None:
        pipeline.extra_rows = buckets
        pipeline.bag_table = build_bag_table(
            pipeline.vocab, buckets, minn=minn, maxn=maxn,
            max_members=max_members)

    return Workload(name="subword", corpus=corpus, cfg=cfg,
                    features=("bags",), prepare=prepare)


register(FrontendSpec(
    name="subword",
    description="fastText bags: hashed char n-grams summed into the center",
    corpus="words → `<word>` n-gram buckets",
    features=("bags",),
    build=_build))
