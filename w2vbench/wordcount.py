"""Corpus words of the batches a window completed, counted the way
word2vec.c counts them: every word of the sentences handed in, before
subsampling drops any.

A batch takes the rows of consecutive sentences, so a batch ends at the
sentence whose row fills it. Which sentences give a row depends on the
keyed subsampling draws, so the count replays them with the frozen rule
of ``reference.batching`` (the same keys, one draw per word): a sentence
of ``n`` words keeps ``m`` and gives one row for each ``max_len`` chunk of
two words or more. Rows longer than the padded length do not occur here
(``pad_len == max_len``).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

from w2vbench.reference import batching as ref


def kept(sentences: Sequence[np.ndarray], keep: np.ndarray, *, seed: int,
         epoch: int, subsample_t: float) -> Iterator[Tuple[int, int]]:
    """``(words, kept words)`` of each sentence of the epoch, in order."""
    for start in range(0, len(sentences), ref.ENCODE_BLOCK):
        rng = np.random.default_rng(np.random.SeedSequence(
            [seed, ref.SUBSAMPLE_TAG, epoch, start // ref.ENCODE_BLOCK]))
        for s in sentences[start:start + ref.ENCODE_BLOCK]:
            n = int(s.shape[0])
            m = n
            if subsample_t > 0 and n:
                m = int(np.count_nonzero(rng.random(n) < keep[s]))
            yield n, m


def batch_ends(sentences: Sequence[np.ndarray], keep: np.ndarray, *,
               seed: int, epoch: int, n_batches: int, rows: int,
               max_len: int, subsample_t: float) -> List[int]:
    """Corpus words through the end of each of the epoch's first
    ``n_batches`` batches; the epoch's last (partial) batch, and any
    index past it, ends with the corpus."""
    ends: List[int] = []
    words = filled = 0
    for n, m in kept(sentences, keep, seed=seed, epoch=epoch,
                     subsample_t=subsample_t):
        words += n
        filled += m // max_len + (1 if m % max_len > 1 else 0)
        while filled >= rows and len(ends) < n_batches:
            ends.append(words)
            filled -= rows
        if len(ends) == n_batches:
            return ends
    return ends + [words] * (n_batches - len(ends))


def window_words(sentences: Sequence[np.ndarray], counts: np.ndarray,
                 steps: Sequence[Tuple[int, int]], *, seed: int, rows: int,
                 max_len: int, subsample_t: float) -> int:
    """Corpus words of the batches ``steps`` lists as ``(epoch, index in
    the epoch)``, each batch counted from the end of the one before it."""
    keep = ref.keep_probs(counts, subsample_t)
    by_epoch: Dict[int, List[int]] = {}
    for epoch, index in steps:
        by_epoch.setdefault(epoch, []).append(index)
    total = 0
    for epoch, idx in by_epoch.items():
        ends = [0] + batch_ends(sentences, keep, seed=seed, epoch=epoch,
                                n_batches=max(idx) + 1, rows=rows,
                                max_len=max_len, subsample_t=subsample_t)
        total += sum(ends[i + 1] - ends[i] for i in idx)
    return total
