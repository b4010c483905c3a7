"""Plain NumPy SGNS: the sequential FULL-W2V schedule, sentence by
sentence and window by window, in float64.

This is the arithmetic the benchmark holds a training step to: the
schedule of the paper's sequential kernel, in which each sentence keeps
its context rows in a ring of ``R = 2·W_f + 1`` rows:

  preload positions 0..W_f-1 into the ring
  for t in 0..len-1:
      q = t + W_f: store the ring row of position q - R (if any) to w_in,
                   load position q from w_in
      window t: context = the ring rows of t-W_f..t+W_f (t excluded,
      clipped to the sentence), outputs = [target t, its N negatives],
      read from w_out; every (context, output) pair from the pre-window
      values:
          corr = C @ M.T, g = lr * (label - sigmoid(corr)) (rows of
          positions outside the sentence zeroed)
          C += g @ M (in the ring), w_out[outputs] += g.T @ C
  store the ring rows of the last R positions, in increasing order

A position holds one ring row from its load to its store and no two live
positions share one, so the ring is kept here as one row per position
(``buf``) and a window's context is a slice of it. A word held twice in
one ring is two rows, and the later store wins, as in the kernel.
Sentences run strictly in order. Nothing here imports the program.
"""
from __future__ import annotations

import numpy as np


def sentence_step(w_in: np.ndarray, w_out: np.ndarray, toks: np.ndarray,
                  negs: np.ndarray, lr: float, w_f: int) -> None:
    """One sentence, in place. ``toks`` (n,) and ``negs`` (n, N) hold the
    sentence's real positions only; the N negatives of a window are
    distinct and differ from its target."""
    n = int(toks.shape[0])
    r = 2 * w_f + 1
    dt = w_in.dtype
    buf = np.zeros((n + 2 * w_f, w_in.shape[1]), dt)   # row w_f + p: p
    outs = np.concatenate([toks[:, None], negs], axis=1).astype(np.int64)
    toks = toks.astype(np.int64)
    # g = lr * (label - sigmoid(x)) = a - b * tanh(x / 2)
    label = np.zeros(outs.shape[1], dt)
    label[0] = 1.0
    a = lr * (label - 0.5)
    b = 0.5 * lr
    keep = np.ones((r, 1), dt)
    keep[w_f] = 0.0                                   # the target's own row
    edge = [keep * ((np.arange(t - w_f, t + w_f + 1) >= 0)
                    & (np.arange(t - w_f, t + w_f + 1) < n))[:, None]
            for t in range(n)]
    take, dot, tanh = np.take, np.dot, np.tanh
    for q in range(min(w_f, n)):
        buf[w_f + q] = w_in[toks[q]]
    for t in range(n):
        q = t + w_f
        if q < n:
            if q >= r:
                w_in[toks[q - r]] = buf[w_f + q - r]
            buf[w_f + q] = w_in[toks[q]]
        c = buf[t:t + r]                              # positions t-w_f..t+w_f
        o = outs[t]
        m = take(w_out, o, axis=0)
        g = dot(c, m.T)
        g *= 0.5
        tanh(g, out=g)
        g *= -b
        g += a
        g *= keep if w_f <= t < n - w_f else edge[t]
        w_out[o] = m + dot(g.T, c)
        c += dot(g, m)
    for p in range(max(0, n - r), n):
        w_in[toks[p]] = buf[w_f + p]


def batch_step(w_in: np.ndarray, w_out: np.ndarray, tokens: np.ndarray,
               negs: np.ndarray, lengths: np.ndarray, lr: float,
               w_f: int) -> None:
    """A batch ``(S, L)`` of padded sentences, in order, in place."""
    for s in range(tokens.shape[0]):
        n = int(lengths[s])
        if n > 0:
            sentence_step(w_in, w_out, tokens[s, :n], negs[s, :n], lr, w_f)
