"""A frozen copy of the host batching rules the program follows: Mikolov
subsampling, packing into ``(S, L)`` rows, and the unigram^0.75 negative
draws with the alias method, every draw keyed by ``(seed, epoch, block or
batch index)``.

It works the batches of one epoch out again from the corpus, the read
vocabulary and the seed, so that the benchmark can hold the program's
batches to them element for element. Written from the batching contract
(keyed streams, per-window distinct negatives, rejection resampling) and
kept here so that a change to the program cannot move it. NumPy only.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

ENCODE_BLOCK = 256          # sentences per subsampling key
SUBSAMPLE_TAG = 0x5B5A
NEGATIVES_TAG = 0x4E45
RESAMPLE_ROUNDS = 16


def keep_probs(counts: np.ndarray, t: float) -> np.ndarray:
    """P(keep) of each word id: ``min(1, sqrt(t / f))``."""
    f = counts / max(int(counts.sum()), 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.sqrt(t / f)
    return np.clip(p, 0.0, 1.0)


class Alias:
    """Walker's alias method over unnormalised weights, built with the
    small/large worklists popped from the end."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, dtype=np.float64)
        n = len(w)
        p = (w * n / w.sum()).tolist()
        prob = [1.0] * n
        alias = list(range(n))
        small = [i for i in range(n) if p[i] < 1.0]
        large = [i for i in range(n) if p[i] >= 1.0]
        while small and large:
            s, big = small.pop(), large.pop()
            prob[s] = p[s]
            alias[s] = big
            p[big] = p[big] + p[s] - 1.0
            (small if p[big] < 1.0 else large).append(big)
        for rest in (small, large):
            for i in rest:
                prob[i] = 1.0
        self.n = n
        self.prob = np.array(prob, np.float64)
        self.alias = np.array(alias, np.int64)

    def sample(self, shape, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, self.n, size=shape)
        accept = rng.random(size=shape) < self.prob[idx]
        return np.where(accept, idx, self.alias[idx])


def _conflicts(targets: np.ndarray, negs: np.ndarray) -> np.ndarray:
    """A negative that equals its window's target or an earlier negative
    of the same window."""
    bad = negs == targets[:, :, None]
    for j in range(1, negs.shape[-1]):
        bad[:, :, j] |= (negs[:, :, j:j + 1] == negs[:, :, :j]).any(-1)
    return bad


def negatives(alias: Alias, targets: np.ndarray, n_neg: int,
              rng: np.random.Generator) -> np.ndarray:
    """``(S, L, N)`` int32 negatives for every position of ``targets``
    (padding included, as the draw stream counts it): a full redraw of
    the array up to ``RESAMPLE_ROUNDS`` times, keeping the slots that
    conflict no more, then a walk upward through the ids."""
    shape = targets.shape + (n_neg,)
    negs = alias.sample(shape, rng).astype(np.int32)
    for _ in range(RESAMPLE_ROUNDS):
        bad = _conflicts(targets, negs)
        if not bad.any():
            return negs
        negs = np.where(bad, alias.sample(shape, rng).astype(np.int32),
                        negs)
    bad = _conflicts(targets, negs)
    while bad.any():
        negs = np.where(bad, (negs + 1) % alias.n, negs)
        bad = _conflicts(targets, negs)
    return negs


def _encoded(sentences: Sequence[np.ndarray], keep: np.ndarray, t: float,
             seed: int, epoch: int, max_len: int) -> Iterator[np.ndarray]:
    """Subsampled sentences cut into ``max_len`` chunks of 2 words or
    more. Word ids are the corpus's own (every word is in the read
    vocabulary)."""
    for start in range(0, len(sentences), ENCODE_BLOCK):
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed, SUBSAMPLE_TAG, epoch, start // ENCODE_BLOCK]))
        for s in sentences[start:start + ENCODE_BLOCK]:
            ids = np.asarray(s, np.int32)
            if t > 0 and ids.size:
                ids = ids[rng.random(ids.shape[0]) < keep[ids]]
            for i in range(0, len(ids), max_len):
                chunk = ids[i:i + max_len]
                if len(chunk) > 1:
                    yield chunk


def batches(sentences: Sequence[np.ndarray], counts: np.ndarray, *,
            seed: int, epoch: int, n_batches: int, rows: int, pad_len: int,
            max_len: int, subsample_t: float, n_neg: int
            ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The epoch's first ``n_batches`` batches as ``(tokens (S, L) int32,
    negs (S, L, N) int32, lengths (S,) int32)``, rows padded with zeros
    past each sentence."""
    keep = keep_probs(counts, subsample_t)
    alias = Alias(counts.astype(np.float64) ** 0.75)
    out = []
    toks = np.zeros((rows, pad_len), np.int32)
    lens = np.zeros(rows, np.int32)
    row = 0
    for sent in _encoded(sentences, keep, subsample_t, seed, epoch,
                         max_len):
        for i in range(0, len(sent), pad_len):
            chunk = sent[i:i + pad_len]
            if len(chunk) < 2:
                continue
            toks[row, :len(chunk)] = chunk
            lens[row] = len(chunk)
            row += 1
            if row == rows:
                rng = np.random.default_rng(np.random.SeedSequence(
                    [seed, NEGATIVES_TAG, epoch, len(out)]))
                out.append((toks, negatives(alias, toks, n_neg, rng), lens))
                if len(out) == n_batches:
                    return out
                toks = np.zeros((rows, pad_len), np.int32)
                lens = np.zeros(rows, np.int32)
                row = 0
    raise ValueError(f"the corpus holds fewer than {n_batches} full batches")
