"""Corpora with the published shapes of text8 and the One Billion Word
Benchmark, generated from the seed.

The real files are not in the repository, so a configuration states the
shape instead: a vocabulary of ``vocab_size`` words whose counts follow a
Zipf law of exponent ``zipf_exponent`` over ``published_words`` words
(the read vocabulary, as word2vec.c's ``-read-vocab`` or gensim's
``build_vocab_from_freq`` hand it to training), and the sentence lengths
(``corpus``). Word ``i`` is the ``i``-th most frequent.

Every seed gets the same multiset of words and of sentence lengths, in an
order of its own, so seeds change the order of the work and not its
amount. Everything here is NumPy; the program receives the sentences as
arrays and the vocabulary counts.
"""
from __future__ import annotations

import numpy as np

# stream tags: the corpus order and the per-seed draws never share a stream
_TOKENS_TAG = 0xC0_5E
_LENGTHS_TAG = 0x1E_47


def zipf_counts(vocab_size: int, total: int, exponent: float) -> np.ndarray:
    """Integer counts, non-increasing in rank, summing to ``total``:
    ``total * r^-exponent / H`` rounded by largest remainder."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    share = ranks ** -float(exponent)
    exact = share / share.sum() * total
    counts = np.floor(exact).astype(np.int64)
    short = int(total - counts.sum())
    if short:
        order = np.argsort(-(exact - counts), kind="stable")[:short]
        counts[order] += 1
    # largest remainders may break monotonicity by one between equal
    # floors; restore the rank order the vocabulary promises
    return np.sort(counts)[::-1].copy()


def vocab_counts(cfg: dict) -> np.ndarray:
    """The read vocabulary's counts over the published corpus."""
    return zipf_counts(cfg["vocab_size"], cfg["published_words"],
                       zipf_exponent(cfg))


def zipf_exponent(cfg: dict) -> float:
    return float(cfg["assumed"]["zipf_exponent"])


def sentence_lengths(cfg: dict) -> np.ndarray:
    """The run corpus's sentence lengths (int64), before the seed's
    order."""
    c = cfg["corpus"]
    if c["kind"] == "stream":
        n, ln = int(c["words"]), int(c["sentence_len"])
        lens = np.full(n // ln, ln, np.int64)
        return np.append(lens, n % ln) if n % ln else lens
    if c["kind"] == "sentences":
        rng = np.random.default_rng(int(c["lengths_seed"]))
        sigma = float(c["len_sigma"])
        mu = np.log(float(c["mean_len"])) - sigma * sigma / 2
        lens = np.rint(rng.lognormal(mu, sigma, int(c["sentences"])))
        return np.clip(lens, int(c["min_len"]), int(c["max_len"])).astype(
            np.int64)
    raise ValueError(f"unknown corpus kind {c['kind']!r}")


def generate(cfg: dict, seed: int):
    """``(sentences, lengths)``: the run corpus in this seed's order, as a
    list of int32 arrays (views of one buffer), and their lengths."""
    lens = sentence_lengths(cfg)
    rng = np.random.default_rng([int(seed), _LENGTHS_TAG])
    lens = lens[rng.permutation(lens.shape[0])]
    n_words = int(lens.sum())
    counts = zipf_counts(cfg["vocab_size"], n_words, zipf_exponent(cfg))
    tokens = np.repeat(np.arange(cfg["vocab_size"], dtype=np.int32), counts)
    np.random.default_rng([int(seed), _TOKENS_TAG]).shuffle(tokens)
    ends = np.cumsum(lens)
    starts = ends - lens
    sentences = [tokens[a:b] for a, b in zip(starts.tolist(), ends.tolist())]
    return sentences, lens
