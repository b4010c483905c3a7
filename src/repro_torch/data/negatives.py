"""Unigram^0.75 negative pre-sampler (the CPU side of the paper's §4.1
coordination: "batching is precomputation, random sampling, and assembly of
data into a format friendly for GPU").

Uses the alias method for O(1) draws. Guarantees the FULL-W2V kernel's
per-window invariant: the N negatives of a window are distinct from each
other and from the target word (classic word2vec also rejects
negative == target).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class AliasTable:
    """Walker alias method over an unnormalized weight vector."""

    def __init__(self, weights: np.ndarray):
        w = np.asarray(weights, dtype=np.float64)
        assert w.ndim == 1 and (w >= 0).all() and w.sum() > 0
        n = len(w)
        p = w * n / w.sum()
        self.n = n
        self.prob = np.ones(n)
        self.alias = np.arange(n)
        small = [i for i in range(n) if p[i] < 1.0]
        large = [i for i in range(n) if p[i] >= 1.0]
        p = p.copy()
        while small and large:
            s, l = small.pop(), large.pop()
            self.prob[s] = p[s]
            self.alias[s] = l
            p[l] = p[l] + p[s] - 1.0
            (small if p[l] < 1.0 else large).append(l)
        for rest in (small, large):
            for i in rest:
                self.prob[i] = 1.0

    def sample(self, shape, rng: np.random.Generator) -> np.ndarray:
        idx = rng.integers(0, self.n, size=shape)
        accept = rng.random(size=shape) < self.prob[idx]
        return np.where(accept, idx, self.alias[idx])


class NegativeSampler:
    def __init__(self, weights: np.ndarray, seed: int = 0):
        self.table = AliasTable(weights)
        self.rng = np.random.default_rng(seed)
        self.vocab = len(weights)

    def sample_batch(self, targets: np.ndarray, n_neg: int,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Negatives for every window of a (S, L) target batch -> (S, L, N).

        Per-window distinctness (incl. vs target) via bounded rejection
        resampling; falls back to a deterministic fill in the (vanishingly
        unlikely) case rejection does not converge.

        `rng` overrides the sampler's own stream — the keyed-randomness hook
        the batching pipelines use so every batch's draws depend only on
        ``(seed, epoch, batch_index)``, never on who sampled before
        (DESIGN.md §4.1: worker-count-invariant async batching).
        """
        if rng is None:
            rng = self.rng
        S, L = targets.shape
        negs = self.table.sample((S, L, n_neg), rng).astype(np.int32)
        for _ in range(16):
            bad = self._conflicts(targets, negs)
            if not bad.any():
                return negs
            resampled = self.table.sample(negs.shape, rng).astype(np.int32)
            negs = np.where(bad, resampled, negs)
        # deterministic fallback: walk ids upward until conflict-free
        bad = self._conflicts(targets, negs)
        while bad.any():
            negs = np.where(bad, (negs + 1) % self.vocab, negs)
            bad = self._conflicts(targets, negs)
        return negs

    def sample_batch_tiled(self, targets: np.ndarray, n_neg: int,
                           tile: int,
                           lengths: Optional[np.ndarray] = None,
                           rng: Optional[np.random.Generator] = None
                           ) -> np.ndarray:
        """One shared N-set per *tile* of ``tile`` consecutive windows,
        broadcast to every window of the tile -> (S, L, N).

        This is Ji et al.'s (1604.04661) shared-negative batching lifted to
        the tile granularity of `_kernel_tiled` (DESIGN.md §4): the tile's
        output block shrinks from T·(N+1) rows to ~T+N, which is what makes
        the tiled kernel's batched fetch ≥2× smaller per window. Each set is
        distinct internally and from *all* T targets of its tile, so the
        per-window invariant (negatives ≠ target, pairwise distinct) still
        holds for every window and the tile scheduler never sees a
        target-as-negative collision.

        `rng` overrides the sampler's stream (see :meth:`sample_batch`).
        """
        if rng is None:
            rng = self.rng
        S, L = targets.shape
        nt = -(-L // tile)
        Lp = nt * tile
        tg = np.full((S, Lp), -1, dtype=np.int64)
        tg[:, :L] = targets
        if lengths is not None:
            tg[np.arange(Lp)[None, :] >= np.asarray(lengths)[:, None]] = -1
        tg = tg.reshape(S, nt, tile)
        negs = self.table.sample((S, nt, n_neg), rng).astype(np.int32)
        for _ in range(16):
            bad = self._tile_conflicts(tg, negs)
            if not bad.any():
                break
            resampled = self.table.sample(negs.shape,
                                          rng).astype(np.int32)
            negs = np.where(bad, resampled, negs)
        bad = self._tile_conflicts(tg, negs)
        # deterministic fallback: each pass advances every conflicted slot,
        # so `vocab` passes visit every id — if conflicts persist past that,
        # some tile has fewer than n_neg non-target ids (infeasible config)
        for _ in range(self.vocab):
            if not bad.any():
                break
            negs = np.where(bad, (negs + 1) % self.vocab, negs)
            bad = self._tile_conflicts(tg, negs)
        if bad.any():
            raise ValueError(
                f"cannot draw {n_neg} negatives distinct from all targets "
                f"of a {tile}-window tile with vocab={self.vocab}; reduce "
                f"tile_windows or negatives, or grow the vocabulary")
        out = np.repeat(negs[:, :, None, :], tile, axis=2).reshape(S, Lp,
                                                                   n_neg)
        return np.ascontiguousarray(out[:, :L])

    @staticmethod
    def _tile_conflicts(tile_targets: np.ndarray,
                        negs: np.ndarray) -> np.ndarray:
        """(S, nt, N) bool — negative equals any target of its tile or an
        earlier negative of the same set."""
        bad = (negs[..., None] == tile_targets[:, :, None, :]).any(-1)
        n = negs.shape[-1]
        for j in range(1, n):
            dup = (negs[:, :, j:j + 1] == negs[:, :, :j]).any(-1)
            bad[:, :, j] |= dup
        return bad

    @staticmethod
    def _conflicts(targets: np.ndarray, negs: np.ndarray) -> np.ndarray:
        """(S, L, N) bool — negative equals target or an earlier negative in
        the same window."""
        bad = negs == targets[:, :, None]
        n = negs.shape[-1]
        for j in range(1, n):
            dup = (negs[:, :, j:j + 1] == negs[:, :, :j]).any(-1)
            bad[:, :, j] |= dup
        return bad
