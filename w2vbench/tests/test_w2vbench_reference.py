"""The plain reference at tiny sizes: SGNS by hand, and the
frozen batching, initialisation and update rules against the program
they were written to hold (tests may import the program; the reference
itself never does)."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from w2vbench import check, corpus, wordcount
from w2vbench.reference import batching as ref_batching
from w2vbench.reference import init as ref_init
from w2vbench.reference import sgns as ref_sgns

from .conftest import tiny_config


def _sigmoid(x):
    return 1.0 / (1.0 + math.exp(-x))


def test_sgns_two_word_sentence_by_hand():
    # w_f = 1, N = 1: window 0 pairs context word 1 with (target 0, neg 2),
    # window 1 pairs context word 0 with (target 1, neg 3)
    rng = np.random.default_rng(1)
    w_in = rng.standard_normal((4, 3))
    w_out = rng.standard_normal((4, 3))
    lr = 0.1
    want_in, want_out = w_in.copy(), w_out.copy()
    c = {0: w_in[0].copy(), 1: w_in[1].copy()}        # the ring's rows
    for t, ctx, neg in ((0, 1, 2), (1, 0, 3)):
        m = [want_out[t].copy(), want_out[neg].copy()]
        g = [lr * (1 - _sigmoid(c[ctx] @ m[0])),
             lr * (0 - _sigmoid(c[ctx] @ m[1]))]
        want_out[t] += g[0] * c[ctx]
        want_out[neg] += g[1] * c[ctx]
        c[ctx] = c[ctx] + g[0] * m[0] + g[1] * m[1]
    want_in[0], want_in[1] = c[0], c[1]
    ref_sgns.sentence_step(w_in, w_out, np.array([0, 1]),
                           np.array([[2], [3]]), lr, 1)
    np.testing.assert_allclose(w_in, want_in, rtol=1e-12)
    np.testing.assert_allclose(w_out, want_out, rtol=1e-12)


def test_sgns_repeated_word_later_store_wins():
    # word 5 at positions 0 and 1 of one ring: two rows, the later stored
    w_in = np.zeros((8, 2))
    w_in[5] = [0.5, -0.5]
    w_out = np.ones((8, 2))
    ref_sgns.sentence_step(w_in, w_out, np.array([5, 5]),
                           np.array([[1], [2]]), 0.1, 1)
    # position 1's row took window 0's update; position 0's took window 1's
    g_target = 0.1 * (1 - _sigmoid(0.0))
    g_neg = 0.1 * (0 - _sigmoid(0.0))
    pos1 = np.array([0.5, -0.5]) + g_target * 1 + g_neg * 1
    np.testing.assert_allclose(w_in[5], pos1, rtol=1e-12)


def test_sgns_matches_the_programs_plain_version():
    from repro_torch.kernels.ref import batch_sgns_ref

    rng = np.random.default_rng(3)
    V, d, S, L, N = 60, 8, 5, 20, 3
    tokens = rng.integers(0, V, (S, L)).astype(np.int32)
    negs = np.stack([[rng.choice(np.setdiff1d(np.arange(V), [tokens[s, t]]),
                                 N, replace=False) for t in range(L)]
                     for s in range(S)]).astype(np.int32)
    lengths = np.array([20, 1, 7, 2, 13], np.int32)
    w_in = ((rng.random((V, d)) - 0.5) / d).astype(np.float32)
    w_out = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    got_in, got_out = w_in.astype(np.float64), w_out.astype(np.float64)
    ref_sgns.batch_step(got_in, got_out, tokens, negs, lengths, 0.025, 3)
    t_in, t_out = torch.from_numpy(w_in.copy()), torch.from_numpy(
        w_out.copy())
    batch_sgns_ref(t_in, t_out, torch.from_numpy(tokens),
                   torch.from_numpy(negs), torch.from_numpy(lengths),
                   0.025, 3)
    np.testing.assert_allclose(t_in.numpy(), got_in, atol=2e-6)
    np.testing.assert_allclose(t_out.numpy(), got_out, atol=2e-6)


def test_batching_matches_the_programs_pipeline():
    from repro_torch.data.corpus import Corpus
    from repro_torch.data.prefetch import make_pipeline
    from w2vbench.drivers import train

    cfg = tiny_config()
    seed = 2**31 + 5
    sentences, _ = corpus.generate(cfg, seed)
    vocab, counts = train.read_vocab(cfg)
    want = ref_batching.batches(
        sentences, counts, seed=seed, epoch=0, n_batches=3,
        rows=cfg["sentences_per_batch"], pad_len=cfg["max_sentence_len"],
        max_len=cfg["max_sentence_len"], subsample_t=cfg["subsample_t"],
        n_neg=cfg["negatives"])
    # the pipeline's stream is the same whatever its depth and workers
    for workers, depth in ((2, 2), (4, 4), (1, 3)):
        traffic = {"prefetch_workers": workers, "prefetch_depth": depth,
                   "prefetch_mode": "thread"}
        pcfg = train.program_config(cfg, traffic, seed)
        pipe = make_pipeline(Corpus(sentences, cfg["vocab_size"]), pcfg,
                             vocab)
        got = []
        gen = pipe.batches(pad_len=pcfg.resolved_pad_len, epoch=0)
        for b in gen:
            got.append((b.tokens, b.negs, b.lengths))
            if len(got) == 3:
                break
        gen.close()
        assert check.batch_mismatches(got, want) == 0
        for g, w in zip(got, want):       # padding included
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def _batch():
    tokens = np.array([[1, 2, 0], [3, 4, 5]], np.int32)
    negs = np.arange(18, dtype=np.int32).reshape(2, 3, 3)
    return tokens, negs, np.array([2, 3], np.int32)


def _wider(b, cols=4, value=9):
    t, n, lens = b
    return (np.pad(t, ((0, 0), (0, cols)), constant_values=value),
            np.pad(n, ((0, 0), (0, cols), (0, 0)), constant_values=value),
            lens)


def _set(b, which, index, value):
    arrays = [a.copy() for a in b]
    arrays[which][index] = value
    return tuple(arrays)


@pytest.mark.parametrize("got, want, n", [
    ([_batch()], [_batch()], 0),
    # padding to another width, or other values in the padding: no fault
    ([_wider(_batch())], [_batch()], 0),
    ([_set(_batch(), 0, (0, 2), 7)], [_batch()], 0),
    ([_set(_batch(), 1, (0, 2, 1), 99)], [_batch()], 0),
    # a row of padding after the real rows: no fault
    ([tuple(np.concatenate([a, np.zeros((1,) + a.shape[1:], a.dtype)])
            for a in _batch())], [_batch()], 0),
    # real positions
    ([_set(_batch(), 0, (0, 1), 7)], [_batch()], 1),
    ([_set(_batch(), 1, (1, 2, 0), 99)], [_batch()], 1),
    ([_set(_batch(), 0, (0, 1), 7)], [_wider(_batch())], 1),
    # a length that differs: every real position of the batch
    ([_set(_batch(), 2, 0, 3)], [_batch()], 2 + 6 + 18),
    ([], [_batch()], 2 + 5 + 15),
    ([_batch(), _batch()], [_batch()], 2 + 5 + 15),
])
def test_batch_mismatch_compares_real_positions_only(got, want, n):
    assert check.batch_mismatches(got, want) == n


def test_alias_matches_the_programs():
    from repro_torch.data.negatives import AliasTable

    w = corpus.zipf_counts(500, 10_000, 1.0).astype(np.float64) ** 0.75
    a, b = ref_batching.Alias(w), AliasTable(w)
    np.testing.assert_array_equal(a.prob, b.prob)
    np.testing.assert_array_equal(a.alias, b.alias)


def test_init_matches_the_programs():
    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.core.trainer import init_state

    seed = 2**31 + 11
    st = init_state(50, W2VConfig(dim=8, seed=seed), seed, "cpu")
    w_in, w_out = ref_init.tables(50, 8, seed)
    np.testing.assert_array_equal(st.w_in.numpy(), w_in)
    np.testing.assert_array_equal(st.w_out.numpy(), w_out)


def test_lr_schedule():
    cfg = {"lr": 0.025, "epochs": 2, "min_lr_frac": 1e-4}
    assert ref_init.lr_at(cfg, 0, 100) == pytest.approx(0.025)
    assert ref_init.lr_at(cfg, 100, 100) == pytest.approx(0.0125)
    assert ref_init.lr_at(cfg, 10**6, 100) == pytest.approx(2.5e-6)


def test_train_numbers():
    w0 = {"a": np.zeros(4), "b": np.ones(4)}
    ref = {"a": np.full(4, 0.1), "b": np.full(4, 1.2)}
    same, _ = check.train_numbers(w0, 0.1, ref, ref, ref, ref)
    assert same == {"grad1_gap": 0, "change_gap": 0, "diff_rel": 0}
    frozen, _ = check.train_numbers(w0, 0.1, w0, ref, w0, ref)
    assert frozen["grad1_gap"] == pytest.approx(1.0)
    assert frozen["change_gap"] == pytest.approx(1.0)


def test_wordcount_without_subsampling_by_hand():
    sentences = [np.array([0, 1, 2]), np.array([3]), np.array([4, 5]),
                 np.array([6, 7, 8, 9]), np.array([1, 2])]
    keep = np.ones(10)
    ends = wordcount.batch_ends(sentences, keep, seed=0, epoch=0,
                                n_batches=3, rows=2, max_len=3,
                                subsample_t=0.0)
    # rows: [0,1,2], (a 1-word sentence gives none), [4,5] | [6,7,8], then
    # the single word 9 gives none, [1,2] | and the corpus ends
    assert ends == [3 + 1 + 2, 12, 12]


def test_wordcount_replays_the_programs_subsampling():
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import Corpus
    from w2vbench.drivers import train

    cfg = tiny_config()
    seed = 99
    sentences, lens = corpus.generate(cfg, seed)
    vocab, counts = train.read_vocab(cfg)
    pcfg = train.program_config(cfg, {"prefetch_workers": 0,
                                      "prefetch_depth": 2,
                                      "prefetch_mode": "thread"}, seed)
    pipe = BatchingPipeline(Corpus(sentences, cfg["vocab_size"]), pcfg,
                            vocab)
    batches = list(pipe.batches(pad_len=40, epoch=1))
    rows = np.concatenate([b.lengths for b in batches])
    keep = ref_batching.keep_probs(counts, cfg["subsample_t"])
    replay = [m for _, m in wordcount.kept(sentences, keep, seed=seed,
                                           epoch=1, subsample_t=1e-3)]
    # sentences of 40 words or fewer: one row each when two or more stay
    np.testing.assert_array_equal(rows[rows > 0],
                                  [m for m in replay if m > 1])
    ends = wordcount.batch_ends(sentences, keep, seed=seed, epoch=1,
                                n_batches=len(batches), rows=8, max_len=40,
                                subsample_t=1e-3)
    assert ends[-1] == int(lens.sum()) and ends == sorted(ends)
    steps = [(1, i) for i in range(len(batches))]
    assert wordcount.window_words(sentences, counts, steps, seed=seed,
                                  rows=8, max_len=40,
                                  subsample_t=1e-3) == int(lens.sum())
