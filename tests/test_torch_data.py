"""The port's host pipeline (numpy copies) is bit-identical to the
reference's: vocabularies, negative draws, batches and tile plans for the
same (corpus, cfg, epoch, index)."""
import numpy as np
import pytest

import repro.data.batching as ref_batching
import repro.data.corpus as ref_corpus
from repro.configs.w2v import smoke as ref_smoke
from repro_torch.configs.w2v import smoke
from repro_torch.data import batching
from repro_torch.data.corpus import (synthetic_cluster_corpus,
                                     synthetic_zipf_corpus)
from repro_torch.data.negatives import NegativeSampler
from tests.conftest import make_distinct_negs


def _batches(mod, corpus, cfg, epoch):
    pipe = mod.BatchingPipeline(corpus, cfg)
    return pipe, list(pipe.batches(pad_len=cfg.resolved_pad_len,
                                   epoch=epoch))


@pytest.mark.parametrize("tile", [1, 8])
@pytest.mark.parametrize("packing", [False, True])
def test_batches_and_plans_bit_identical(tile, packing):
    kw = dict(sentences_per_batch=8, max_sentence_len=20, tile_windows=tile,
              negatives=5, window=5, ignore_delimiters=packing,
              subsample_t=1e-3, seed=3)
    corpus = ref_corpus.synthetic_cluster_corpus(
        n_clusters=6, words_per_cluster=12, n_sentences=150, mean_len=9,
        seed=1)
    port_corpus = synthetic_cluster_corpus(
        n_clusters=6, words_per_cluster=12, n_sentences=150, mean_len=9,
        seed=1)
    assert port_corpus.sentences == corpus.sentences
    assert (port_corpus.clusters == corpus.clusters).all()
    for epoch in (0, 1):
        rp, ref = _batches(ref_batching, corpus, ref_smoke(**kw), epoch)
        pp, port = _batches(batching, corpus, smoke(**kw), epoch)
        assert pp.vocab.ids == rp.vocab.ids
        assert (pp.vocab.counts == rp.vocab.counts).all()
        assert len(port) == len(ref) >= 3
        for a, b in zip(port, ref):
            assert (a.epoch, a.index, a.n_words) == (b.epoch, b.index,
                                                     b.n_words)
            for f in ("tokens", "negs", "lengths"):
                x, y = getattr(a, f), getattr(b, f)
                assert x.dtype == y.dtype and np.array_equal(x, y), f
            assert (a.plan is None) == (b.plan is None) == (tile == 1)
            if tile > 1:
                for f in ("uniq", "scatter", "ucount", "strict"):
                    x, y = getattr(a.plan, f), getattr(b.plan, f)
                    assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("tile", [1, 3, 8])
def test_plan_tiles_bit_identical(rng, tile):
    V, S, L, N = 40, 5, 19, 3
    tokens = rng.integers(0, V, size=(S, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    lengths = np.array([19, 0, 1, 7, 12], np.int32)
    a = batching.plan_tiles(tokens, negs, lengths, tile)
    b = ref_batching.plan_tiles(tokens, negs, lengths, tile)
    for f in ("uniq", "scatter", "ucount", "strict"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_negative_sampler_draws_bit_identical():
    from repro.data.negatives import NegativeSampler as RefSampler
    w = np.random.default_rng(5).random(300) ** 2
    tg = np.random.default_rng(6).integers(0, 300, size=(4, 33))
    port, ref = NegativeSampler(w, seed=2), RefSampler(w, seed=2)
    assert np.array_equal(port.table.prob, ref.table.prob)
    assert np.array_equal(port.table.alias, ref.table.alias)
    assert np.array_equal(port.sample_batch(tg, 5), ref.sample_batch(tg, 5))
    lens = np.array([33, 10, 0, 5])
    assert np.array_equal(port.sample_batch_tiled(tg, 5, 8, lens),
                          ref.sample_batch_tiled(tg, 5, 8, lens))


def test_zipf_corpus_bit_identical():
    a = synthetic_zipf_corpus(vocab_size=500, n_sentences=50, seed=4)
    b = ref_corpus.synthetic_zipf_corpus(vocab_size=500, n_sentences=50,
                                         seed=4)
    assert a.sentences == b.sentences


def test_later_slice_branches_raise():
    corpus = synthetic_cluster_corpus(n_clusters=2, words_per_cluster=8,
                                      n_sentences=20, seed=0)
    pipe = batching.BatchingPipeline(corpus, smoke())
    packed = next(pipe._packed(None, 0))
    # a placement no longer waits for a later slice: it attaches the plan
    from repro_torch.distributed.vocab_placement import VocabPlacement
    placement = VocabPlacement.plan(pipe.vocab.counts, 1)
    batch = batching.finalize_packed(packed, pipe.cfg, pipe.sampler, 0,
                                     placement=placement)
    assert batch.exchange is not None
    assert batch.exchange.placement == placement
    # nor does a subword bag table: it materializes the batch's bags as the
    # reference does (the frontends' parity is in test_torch_frontends.py)
    table = np.arange(pipe.vocab.size * 3, dtype=np.int32).reshape(-1, 3)
    batch = batching.finalize_packed(packed, pipe.cfg, pipe.sampler, 0,
                                     bag_table=table)
    ref_pipe = ref_batching.BatchingPipeline(
        ref_corpus.synthetic_cluster_corpus(n_clusters=2, words_per_cluster=8,
                                            n_sentences=20, seed=0),
        ref_smoke())
    want = ref_batching.finalize_packed(
        next(ref_pipe._packed(None, 0)), ref_pipe.cfg, ref_pipe.sampler, 0,
        bag_table=table)
    assert batch.bags.tobytes() == want.bags.tobytes()
    assert batch.bags.shape == batch.tokens.shape + (3,)
