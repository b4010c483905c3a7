"""Embedding quality metrics — the offline analogue of paper Table 7.

WS-353/SimLex/analogy sets are external data; on the planted-cluster
synthetic corpus (`data.corpus.synthetic_cluster_corpus`) the ground-truth
similarity structure is known exactly, so we measure:

* `spearman_vs_truth` — Spearman rank correlation between embedding cosine
  similarity and ground-truth (same-cluster) similarity over sampled pairs —
  the WS-353/SimLex analogue;
* `cluster_separation` — mean intra-cluster minus mean inter-cluster cosine;
* `nn_purity` — fraction of words whose nearest neighbour shares the cluster
  (the analogy-reconstruction analogue).

The paper's claim being reproduced: FULL-W2V's reuse scheme gives quality
statistically equal to pWord2Vec/Wombat — i.e. all implementations here
must score the same within noise.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _rankdata(x: np.ndarray) -> np.ndarray:
    """Average-tie ranks (scipy.stats.rankdata('average') equivalent)."""
    order = np.argsort(x, kind="mergesort")
    ranks = np.empty(len(x), float)
    sx = x[order]
    i = 0
    while i < len(x):
        j = i
        while j + 1 < len(x) and sx[j + 1] == sx[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return ranks


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    ra, rb = _rankdata(a), _rankdata(b)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra * ra).sum() * (rb * rb).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


def _normalize(emb: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(emb, axis=1, keepdims=True)
    return emb / np.maximum(n, 1e-12)


def evaluate(emb: np.ndarray, clusters: np.ndarray,
             n_pairs: int = 20_000, seed: int = 0) -> Dict[str, float]:
    rng = np.random.default_rng(seed)
    v = emb.shape[0]
    e = _normalize(np.asarray(emb, np.float64))

    i = rng.integers(0, v, n_pairs)
    j = rng.integers(0, v, n_pairs)
    keep = i != j
    i, j = i[keep], j[keep]
    cos = (e[i] * e[j]).sum(1)
    truth = (clusters[i] == clusters[j]).astype(float)

    intra = cos[truth == 1.0]
    inter = cos[truth == 0.0]
    sep = float(intra.mean() - inter.mean()) if len(intra) and len(inter) else 0.0

    # nearest-neighbour purity on a sample of words
    sample = rng.choice(v, size=min(v, 512), replace=False)
    sims = e[sample] @ e.T
    sims[np.arange(len(sample)), sample] = -np.inf
    nn = sims.argmax(1)
    purity = float((clusters[sample] == clusters[nn]).mean())

    return {
        "spearman": spearman(cos, truth),
        "separation": sep,
        "nn_purity": purity,
    }
