"""Operations and bytes the benchmark's work needs, counted from its
inputs, whatever kernel computes them: the numerators of the roofline
and MFU shares.

An SGNS window pairs each of its context rows with its N + 1 output rows
(the target and N negatives); a pair costs three length-d products (the
score, the context row's update, the output row's update): ``6 d``
operations. A sentence of n words has ``2 * sum_{o=1..W_f} max(n - o, 0)``
(context, window) pairs. The least bytes read every touched row of each
table once and write it once, and read the batch's ids once.
"""
from __future__ import annotations

import numpy as np

from w2vbench import peaks


def context_pairs(lengths: np.ndarray, w_f: int) -> int:
    lens = np.asarray(lengths, np.int64)
    return int(sum(2 * np.maximum(lens - o, 0).sum()
                   for o in range(1, w_f + 1)))


def sgns_flops(lengths: np.ndarray, w_f: int, n_neg: int, dim: int) -> float:
    return 6.0 * dim * (n_neg + 1) * context_pairs(lengths, w_f)


def sgns_bytes(tokens: np.ndarray, negs: np.ndarray, lengths: np.ndarray,
               vocab: int, dim: int) -> float:
    """Touched rows of ``w_in`` (the context words) and ``w_out`` (targets
    and negatives) read and written once in f32, and the ids of the batch's
    real positions (tokens, negatives, lengths) read once."""
    valid = np.arange(tokens.shape[1])[None, :] < np.asarray(lengths)[:, None]
    words = tokens[valid]
    rows_in = int(np.count_nonzero(np.bincount(words, minlength=vocab)))
    outs = np.concatenate([words, negs[valid].ravel()])
    rows_out = int(np.count_nonzero(np.bincount(outs, minlength=vocab)))
    ids = 4.0 * (outs.size + len(lengths))
    return 2.0 * (rows_in + rows_out) * dim * 4 + ids


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the f32
    operations bound and the bytes bound."""
    return max(flops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
