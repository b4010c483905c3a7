"""Vocabulary construction, min-count filtering, and frequency subsampling.

Follows Mikolov et al.: words with fewer than `min_count` occurrences are
dropped (paper Table 3: min 5); frequent words are randomly discarded with
probability 1 - sqrt(t/f(w)) (t = subsample threshold, default 1e-4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class Vocab:
    ids: Dict[Hashable, int]          # raw token -> dense id
    counts: np.ndarray                # (V,) occurrence counts
    total: int                        # total kept-word occurrences
    # lazy caches (not part of the value): int-token lookup table (with a
    # memoized not-LUT-able verdict) and per-threshold keep probabilities —
    # the vectorized encode/subsample fast path the host pipeline's hot
    # loop runs on
    _lut: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False)
    _lut_checked: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    _keep_cache: Dict[float, np.ndarray] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def size(self) -> int:
        return len(self.counts)

    @classmethod
    def build(cls, sentences: Iterable[Sequence[Hashable]],
              min_count: int = 5) -> "Vocab":
        raw: Dict[Hashable, int] = {}
        for s in sentences:
            for w in s:
                raw[w] = raw.get(w, 0) + 1
        kept = sorted((w for w, c in raw.items() if c >= min_count),
                      key=lambda w: (-raw[w], str(w)))
        ids = {w: i for i, w in enumerate(kept)}
        counts = np.array([raw[w] for w in kept], dtype=np.int64)
        return cls(ids=ids, counts=counts, total=int(counts.sum()))

    # -- encode: LUT fast path for int-token corpora -------------------------
    def _int_lut(self) -> Optional[np.ndarray]:
        """raw int token -> dense id (or -1), when every raw token is a
        smallish non-negative int (synthetic corpora, pre-tokenized text).
        None when the vocabulary is not LUT-able (string tokens) — the
        verdict is memoized either way, so the check is paid once, not per
        sentence."""
        if not self._lut_checked:
            self._lut_checked = True
            keys = list(self.ids)
            ok = (bool(keys)
                  and all(isinstance(k, (int, np.integer)) for k in keys)
                  and min(keys) >= 0 and max(keys) < 1 << 24)
            if ok:
                lut = np.full(int(max(keys)) + 1, -1, dtype=np.int32)
                for k, i in self.ids.items():
                    lut[int(k)] = i
                self._lut = lut
        return self._lut

    def encode(self, sentence: Sequence[Hashable]) -> List[int]:
        return [self.ids[w] for w in sentence if w in self.ids]

    def encode_ids(self, sentence: Sequence[Hashable]) -> np.ndarray:
        """Vectorized :meth:`encode` -> int32 array. Identical output (OOV
        dropped — including negative or non-int tokens — order kept); the
        batching hot loop runs on this."""
        lut = self._int_lut()
        if lut is not None:
            try:
                raw = np.asarray(sentence)
            except ValueError:   # ragged input
                raw = None
            # ints only: float/str/object sentences take the scalar path,
            # which drops them as OOV rather than silently truncating
            if raw is not None and raw.dtype.kind in "iu" and raw.ndim == 1:
                raw = raw.astype(np.int64)
                if raw.size == 0:
                    return raw.astype(np.int32)
                in_range = (raw >= 0) & (raw < len(lut))
                enc = lut[np.where(in_range, raw, 0)]
                enc = np.where(in_range, enc, -1)
                return enc[enc >= 0].astype(np.int32)
        return np.asarray(self.encode(sentence), dtype=np.int32)

    def keep_probs(self, subsample_t: float) -> np.ndarray:
        """P(keep) per word id under Mikolov subsampling (cached per t)."""
        p = self._keep_cache.get(subsample_t)
        if p is None:
            f = self.counts / max(self.total, 1)
            with np.errstate(divide="ignore", invalid="ignore"):
                p = np.sqrt(subsample_t / f)
            p = np.clip(p, 0.0, 1.0)
            self._keep_cache[subsample_t] = p
        return p

    def subsample_ids(self, ids: np.ndarray, subsample_t: float,
                      rng: np.random.Generator) -> np.ndarray:
        """Mikolov subsampling of one encoded sentence: one ``rng.random``
        draw per word, kept where it falls below the word's keep
        probability (the reference's draw stream, draw for draw)."""
        if subsample_t <= 0 or ids.size == 0:
            return ids
        keep = self.keep_probs(subsample_t)
        return ids[rng.random(ids.shape[0]) < keep[ids]]

    def unigram_weights(self, power: float = 0.75) -> np.ndarray:
        """The negative-sampling distribution weights f(w)^0.75."""
        return self.counts.astype(np.float64) ** power
