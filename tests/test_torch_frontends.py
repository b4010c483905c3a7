"""The port's workload frontends (``repro_torch.frontends``: node2vec,
doc2vec, subword) against the reference's, in one process, from the same
seeded inputs:

* graphs, walks (p/q extremes, sinks, self-loops, isolated nodes, an empty
  graph), FNV-1a known answers, n-grams, buckets, bag tables, document
  corpora and each workload's built state: equal to the reference's, byte
  for byte;
* packed batches (``tokens``, ``negs``, ``lengths``, ``docs``, ``bags``,
  tile plans, exchange plans) of every workload: byte-equal to the
  reference's synchronous stream, synchronously and with 2 thread and 2
  process prefetch workers;
* the plain versions with ``static_ids``/``bags`` against the reference's
  ``batch_sgns_ref``/``batch_sgns_tiled_ref`` (atol 2e-5 / rtol 1e-4), and
  the port's T=1 tiled path bit-identical to its sequential path;
* the registry: frontend steps resolve to the plain versions on both
  platforms and a CUDA backend named for them raises, as the reference's
  Pallas backends do;
* ``TrainSession`` per workload against the reference's jnp session from
  the same tables, replicated and at one shard; one shard bit-identical to
  replicated; subword on ``hot=bf16:frac=0.25,cold=int8,shards=1`` stays
  finite with every n-gram row in the int8 tail; a doc2vec checkpoint
  resumed mid-epoch bit for bit;
* the CLI for every registered workload, its ``final_digest`` the same
  with 2 prefetch workers;
* doc vectors queryable through the port's serving index, as the
  reference's ``test_doc_vectors_queryable_via_embedding_index``.

Multi-rank runs are in ``test_torch_frontends_mesh.py``."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.batching as ref_batching
from repro import frontends as ref_frontends
from repro.configs.w2v import smoke as ref_smoke
from repro.core.trainer import TrainSession as RefSession
from repro.distributed import vocab_placement as ref_vp
from repro.frontends import doc2vec as ref_doc2vec
from repro.frontends import node2vec as ref_node2vec
from repro.frontends import subword as ref_subword
from repro.kernels import ref as jref
from repro.kernels import registry as ref_registry
from repro_torch import frontends
from repro_torch.configs.w2v import smoke
from repro_torch.convert import params_from_reference
from repro_torch.core.trainer import TrainSession
from repro_torch.data import batching
from repro_torch.data.prefetch import AsyncBatchingPipeline
from repro_torch.distributed import vocab_placement as vp
from repro_torch.frontends import doc2vec, node2vec, subword
from repro_torch.kernels import ops, ref, registry
from repro_torch.kernels.tables import Tables
from repro_torch.launch.mesh import DataMesh
from tests.conftest import REPO, SRC, make_distinct_negs

TOL = dict(atol=2e-5, rtol=1e-4)
WORKLOADS = ("node2vec", "doc2vec", "subword")

# each workload at a small size: a few batches of S=32
KNOBS = {
    "w2v": dict(vocab=96, clusters=6, sentences=120, mean_len=10),
    "node2vec": dict(communities=6, nodes_per=8, walks_per_node=2,
                     walk_length=16),
    "doc2vec": dict(docs=12, sents_per_doc=8, clusters=4,
                    words_per_cluster=12, mean_len=10),
    "subword": dict(vocab=96, clusters=6, sentences=150, mean_len=10,
                    buckets=64),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores and these small-tensor
    tests slow tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(tile=1, **kw):
    return dict(dim=16, sentences_per_batch=32, tile_windows=tile, **kw)


def _build(name, side="port", **cfg_kw):
    """A workload's (pipeline, cfg, workload) on one side, attached."""
    if side == "port":
        w = frontends.get(name).build(smoke(**_cfg_kw(**cfg_kw)),
                                      **KNOBS[name])
        pipe = batching.BatchingPipeline(w.corpus, w.cfg)
    else:
        w = ref_frontends.get(name).build(ref_smoke(**_cfg_kw(**cfg_kw)),
                                          **KNOBS[name])
        pipe = ref_batching.BatchingPipeline(w.corpus, w.cfg)
    w.attach(pipe)
    return pipe, w.cfg, w


# ---------------------------------------------------------------------------
# Graphs and walks
# ---------------------------------------------------------------------------

def _graphs():
    """(name, port graph, reference graph) for the walk cases."""
    edges = [(0, 1), (1, 2), (2, 0), (2, 2), (3, 4)]
    out = [("community", node2vec.community_graph(6, 5, extra_edges=7,
                                                  seed=3),
            ref_node2vec.community_graph(6, 5, extra_edges=7, seed=3)),
           # a self-loop, an isolated node (5) and a 2-node component
           ("self_loop_isolated", node2vec.Graph.from_edges(edges, 6),
            ref_node2vec.Graph.from_edges(edges, 6)),
           # directed: node 3 is a sink, node 4 has no edges at all
           ("directed_sink", node2vec.Graph.from_edges(
               [(0, 1), (1, 2), (2, 0), (2, 3)], 5, undirected=False),
            ref_node2vec.Graph.from_edges(
                [(0, 1), (1, 2), (2, 0), (2, 3)], 5, undirected=False)),
           ("empty", node2vec.Graph.from_edges([], 0),
            ref_node2vec.Graph.from_edges([], 0))]
    return out


@pytest.mark.parametrize("case", [g[0] for g in _graphs()])
def test_graphs_match_reference(case):
    _, a, b = next(g for g in _graphs() if g[0] == case)
    assert a.indptr.dtype == b.indptr.dtype and a.n_nodes == b.n_nodes
    assert np.array_equal(a.indptr, b.indptr)
    assert np.array_equal(a.indices, b.indices)
    for v in range(a.n_nodes):
        assert a.degree(v) == b.degree(v)


@pytest.mark.parametrize("p,q", [(1.0, 1.0), (1.0, 0.5), (0.25, 4.0),
                                 (4.0, 0.25), (1e-3, 1e3), (1e3, 1e-3)])
@pytest.mark.parametrize("case", [g[0] for g in _graphs()])
def test_walks_match_reference(case, p, q):
    """Every walk, step for step, from the same keyed draws."""
    _, a, b = next(g for g in _graphs() if g[0] == case)
    got = node2vec.walk_corpus(a, walks_per_node=3, walk_length=12, p=p,
                               q=q, seed=5)
    want = ref_node2vec.walk_corpus(b, walks_per_node=3, walk_length=12,
                                    p=p, q=q, seed=5)
    assert got.sentences == want.sentences
    assert got.vocab_size == want.vocab_size
    if case == "directed_sink":
        # walks end early at the sink and never leave the isolated node
        assert any(s[-1] == 3 and len(s) < 12 for s in got.sentences)
        assert all(s == [4] for s in got.sentences[4 * 3:5 * 3])


def test_single_walk_matches_reference_and_rejects_bad_bias():
    g = node2vec.community_graph(4, 6, seed=1)
    rg = ref_node2vec.community_graph(4, 6, seed=1)
    for start in range(0, 24, 5):
        a = node2vec.node2vec_walk(g, start, 30, 0.5, 2.0,
                                   np.random.default_rng(start))
        b = ref_node2vec.node2vec_walk(rg, start, 30, 0.5, 2.0,
                                       np.random.default_rng(start))
        assert a == b and all(isinstance(x, int) for x in a)
    for p, q in ((0.0, 1.0), (1.0, -1.0)):
        with pytest.raises(ValueError, match="positive"):
            node2vec.walk_corpus(g, p=p, q=q)


# ---------------------------------------------------------------------------
# Subword hashing and bag tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,want", [
    (b"", 0x811C9DC5), (b"a", 0xE40C292C), (b"foobar", 0xBF9CF968)])
def test_fnv1a_known_answers(data, want):
    """The published 32-bit FNV-1a test vectors."""
    assert subword.fnv1a(data) == want == ref_subword.fnv1a(data)


@pytest.mark.parametrize("minn,maxn", [(3, 5), (1, 2), (2, 6)])
def test_ngrams_and_buckets_match_reference(minn, maxn):
    words = ["a", "where", "12345", "naïve", "日本語", "x" * 40, ""]
    for w in words:
        grams = subword.word_ngrams(w, minn, maxn)
        assert grams == ref_subword.word_ngrams(w, minn, maxn)
        for g in grams:
            for buckets in (7, 4096, 2_000_000):
                assert (subword.ngram_bucket(g, buckets)
                        == ref_subword.ngram_bucket(g, buckets))
    rng = np.random.default_rng(3)
    for _ in range(50):
        b = rng.integers(0, 256, size=int(rng.integers(0, 30))).astype(
            np.uint8).tobytes()
        assert subword.fnv1a(b) == ref_subword.fnv1a(b)


@pytest.mark.parametrize("buckets,max_members", [(64, 0), (4096, 0),
                                                 (97, 4)])
def test_bag_tables_match_reference(buckets, max_members):
    w = frontends.get("w2v").build(smoke(), **KNOBS["w2v"])
    pv = batching.BatchingPipeline(w.corpus, w.cfg).vocab
    rw = ref_frontends.get("w2v").build(ref_smoke(), **KNOBS["w2v"])
    rv = ref_batching.BatchingPipeline(rw.corpus, rw.cfg).vocab
    a = subword.build_bag_table(pv, buckets, max_members=max_members)
    b = ref_subword.build_bag_table(rv, buckets, max_members=max_members)
    assert a.dtype == b.dtype == np.int32 and a.shape == b.shape
    assert a.tobytes() == b.tobytes()
    assert (a[:, 0] == np.arange(pv.size)).all()
    assert ((a[:, 1:] == -1) | (a[:, 1:] >= pv.size)).all()


# ---------------------------------------------------------------------------
# Documents, the registry and built workloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(n_docs=5, sents_per_doc=3,
                                             purity=0.5, seed=9)])
def test_document_corpus_matches_reference(kw):
    a = doc2vec.document_corpus(**kw)
    b = ref_doc2vec.document_corpus(**kw)
    assert a.sentences == b.sentences and a.doc_ids == b.doc_ids
    assert np.array_equal(a.clusters, b.clusters)
    assert a.vocab_size == b.vocab_size


def test_registry_matches_reference():
    assert frontends.names() == ref_frontends.names()
    for a, b in zip(frontends.specs(), ref_frontends.specs()):
        assert (a.name, a.description, a.corpus, a.features) == (
            b.name, b.description, b.corpus, b.features)
    with pytest.raises(ValueError, match="unknown workload frontend"):
        frontends.get("bogus")
    with pytest.raises(ValueError, match="already registered"):
        frontends.register(frontends.get("w2v"))


@pytest.mark.parametrize("name", ["w2v", *WORKLOADS])
def test_built_workloads_match_reference(name):
    pipe, cfg, w = _build(name, tile=4)
    rpipe, rcfg, rw = _build(name, "ref", tile=4)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert w.corpus.sentences == rw.corpus.sentences
    assert w.corpus.doc_ids == rw.corpus.doc_ids
    assert w.features == rw.features == pipe.frontend_features
    assert pipe.extra_rows == rpipe.extra_rows
    assert pipe.table_rows == rpipe.table_rows
    assert np.array_equal(pipe.table_counts(), rpipe.table_counts())
    if name == "subword":
        assert pipe.bag_table.tobytes() == rpipe.bag_table.tobytes()
    else:
        assert pipe.bag_table is None and rpipe.bag_table is None


# ---------------------------------------------------------------------------
# Packed batches, synchronous and with prefetch workers
# ---------------------------------------------------------------------------

def _same_batches(got, want):
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        for f in ("tokens", "negs", "lengths", "docs", "bags"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        assert a.n_words == b.n_words
        assert (a.plan is None) == (b.plan is None)
        if a.plan is not None:
            for f in ("uniq", "scatter", "ucount", "strict"):
                assert np.array_equal(getattr(a.plan, f),
                                      getattr(b.plan, f)), f


@pytest.mark.parametrize("mode,workers,tile", [
    ("sync", 0, 1), ("sync", 0, 4), ("thread", 2, 1), ("thread", 2, 4),
    ("process", 2, 4)])
@pytest.mark.parametrize("name", WORKLOADS)
def test_batches_match_reference(name, mode, workers, tile):
    rpipe, _, _ = _build(name, "ref", tile=tile)
    want = list(rpipe.batches(pad_len=32, epoch=1))
    if mode == "sync":
        pipe, _, _ = _build(name, tile=tile)
    else:
        w = frontends.get(name).build(smoke(**_cfg_kw(tile)), **KNOBS[name])
        pipe = AsyncBatchingPipeline(w.corpus, w.cfg, workers=workers,
                                     mode=mode)
        w.attach(pipe)
    _same_batches(list(pipe.batches(pad_len=32, epoch=1)), want)
    if name == "doc2vec":
        assert all((b.docs[b.lengths > 0] >= pipe.vocab.size).all()
                   for b in want)
    if name == "subword":
        b = want[0]
        pad = np.arange(32)[None, :] >= b.lengths[:, None]
        assert (b.bags[pad] == -1).all() and (b.bags[~pad][:, 0] >= 0).all()


@pytest.mark.parametrize("name", ["doc2vec", "subword"])
def test_exchange_plans_match_reference(name):
    """Doc rows and bag buckets count zero, so they lie in the cold tail
    and ride the exchange, remapped into working-table space."""
    pipe, _, _ = _build(name, tile=4)
    rpipe, _, _ = _build(name, "ref", tile=4)
    pipe.placement = vp.VocabPlacement.plan(pipe.table_counts(), 2)
    rpipe.placement = ref_vp.VocabPlacement.plan(rpipe.table_counts(), 2)
    assert pipe.placement.hot <= pipe.vocab.size
    for a, b in zip(pipe.batches(pad_len=32, epoch=0),
                    rpipe.batches(pad_len=32, epoch=0)):
        ea, eb = a.exchange, b.exchange
        for f in ("tokens", "negs", "cold_ids", "bucket_ids", "bucket_pos",
                  "docs", "bags", "plan_uniq"):
            x, y = getattr(ea, f), getattr(eb, f)
            assert (x is None) == (y is None) and np.array_equal(x, y), f
        extra = ea.docs if name == "doc2vec" else ea.bags
        assert extra is not None and (extra >= -1).all()


def test_step_inputs_lift_frontend_rows():
    """``from_batch`` and ``VocabExchange.step_inputs`` carry ``docs`` and
    ``bags`` as ``static_ctx`` and ``bags``, a rank's block under a
    mesh."""
    pipe, _, _ = _build("subword", tile=4)
    batch = next(pipe.batches(pad_len=32, epoch=0))
    batch.docs = np.arange(32, dtype=np.int32)
    step = batch.step_inputs(0.05, "cpu")
    assert step.has_static_ctx and step.has_bags and step.has_plan
    assert step.frontends == ("static_ctx", "bags")
    assert torch.equal(step.bags, torch.from_numpy(batch.bags))
    half = batch.step_inputs(0.05, "cpu", mesh=DataMesh(1, 2, "cpu"))
    assert torch.equal(half.static_ctx, torch.arange(16, 32,
                                                     dtype=torch.int32))
    assert torch.equal(half.bags, torch.from_numpy(batch.bags[16:]))
    ex = vp.plan_exchange(batch, vp.VocabPlacement.plan(
        pipe.table_counts(), 2))
    s = ex.step_inputs(0.05, "cpu", mesh=DataMesh(0, 2, "cpu"))
    assert torch.equal(s.bags, torch.from_numpy(ex.bags[:16]))
    assert torch.equal(s.static_ctx, torch.from_numpy(ex.docs[:16]))
    plain = dataclasses.replace(batch, docs=None, bags=None)
    assert plain.step_inputs(0.05, "cpu").frontends == ()


# ---------------------------------------------------------------------------
# Plain versions with static_ids / bags
# ---------------------------------------------------------------------------

def _frontend_batch(seed=0, V=40, X=16, d=32, S=4, L=14, N=3, B=5):
    """Tables of V words + X extra rows, doc rows past the vocabulary (one
    sentence without, one repeated), bags with -1 pads, repeated members
    and a word row first."""
    rng = np.random.default_rng(seed)
    w_in = (rng.normal(size=(V + X, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V + X, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, V, size=(S, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    lengths = np.array([L, L - 5, 1, 6], np.int32)
    docs = np.array([V + 3, V + 7, -1, V + 3], np.int32)
    bags = rng.integers(V, V + X, size=(S, L, B)).astype(np.int32)
    bags[rng.random((S, L, B)) < 0.3] = -1
    bags[..., 2] = bags[..., 1]                       # repeated members
    bags[..., 0] = tokens
    bags[np.arange(L)[None, :] >= lengths[:, None]] = -1
    return (w_in, w_out, tokens, negs, lengths), docs, bags


FEATURES = {"static_ids": ("static_ids",), "bags": ("bags",),
            "both": ("static_ids", "bags")}


def _fe(kind, docs, bags, to):
    return {k: to(v) for k, v in (("static_ids", docs), ("bags", bags))
            if k in FEATURES[kind]}


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("tile,G", [(0, 0), (1, 0), (4, 2), (8, 4)])
@pytest.mark.parametrize("kind", list(FEATURES))
def test_plain_versions_match_reference(kind, tile, G):
    """``tile=0``: the sequential plain version."""
    batch, docs, bags = _frontend_batch()
    fe_t = _fe(kind, docs, bags, lambda a: torch.from_numpy(a))
    fe_j = _fe(kind, docs, bags, jnp.asarray)
    if tile == 0:
        want = jref.batch_sgns_ref(*_jax(*batch), jnp.float32(0.05), 2,
                                   **fe_j)
        got = ref.batch_sgns_ref(*_torch(*batch), 0.05, 2, **fe_t)
    else:
        plan = batching.plan_tiles(*batch[2:], tile)
        p = (plan.uniq, plan.scatter, plan.ucount, plan.strict)
        want = jref.batch_sgns_tiled_ref(*_jax(*batch), jnp.float32(0.05),
                                         2, tile, *_jax(*p), gemm_windows=G,
                                         **fe_j)
        got = ref.batch_sgns_tiled_ref(*_torch(*batch), 0.05, 2, tile,
                                       *_torch(*p), gemm_windows=G, **fe_t)
    for g, w, init in zip(got, want, batch[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    w_in = got[0].numpy()
    if "static_ids" in FEATURES[kind]:          # the doc rows trained
        assert np.abs(w_in[[43, 47]] - batch[0][[43, 47]]).min() > 0
    if "bags" in FEATURES[kind]:                # and the bucket rows
        touched = np.unique(bags[bags >= 40])
        assert (np.abs(w_in[touched] - batch[0][touched]).max(1) > 0).all()


@pytest.mark.parametrize("kind", list(FEATURES))
def test_tiled_t1_is_bit_identical_to_sequential(kind):
    batch, docs, bags = _frontend_batch(seed=1)
    fe = _fe(kind, docs, bags, lambda a: torch.from_numpy(a))
    seq = ref.batch_sgns_ref(*_torch(*batch), 0.05, 2, **fe)
    plan = batching.plan_tiles(*batch[2:], 1)
    tiled = ref.batch_sgns_tiled_ref(
        *_torch(*batch), 0.05, 2, 1,
        *_torch(plan.uniq, plan.scatter, plan.ucount, plan.strict), **fe)
    for a, b in zip(seq, tiled):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Registry resolution of frontend steps
# ---------------------------------------------------------------------------

TO_REF = {"torch": "jnp", "torch_tiled": "jnp_tiled", "cuda": "pallas",
          "cuda_pipelined": "pallas_pipelined", "cuda_tiled": "pallas_tiled",
          "auto": "auto"}


@pytest.mark.parametrize("platform", ["cuda", "cpu"])
@pytest.mark.parametrize("fe", [("static_ctx",), ("bags",)])
def test_frontend_steps_resolve_to_the_plain_versions(fe, platform):
    for tiled in (False, True):
        for shard in (False, True):
            be = registry.resolve("auto", tiled=tiled, vocab_shard=shard,
                                  frontends=fe, platform=platform)
            assert be.name == ("torch_tiled" if tiled else "torch")
            ref_be = ref_registry.resolve(
                "auto", tiled=tiled, vocab_shard=shard, frontends=fe,
                platform="tpu" if platform == "cuda" else "cpu")
            assert TO_REF[be.name] == ref_be.name
    for name in ("cuda", "cuda_pipelined", "cuda_tiled"):
        with pytest.raises(ValueError, match="frontend feature"):
            registry.resolve(name, tiled=name == "cuda_tiled", frontends=fe,
                             platform="cuda")
    with pytest.raises(ValueError, match="frontend feature"):
        registry.resolve("cuda_tiled", tiled=True, frontends=("bags",),
                         platform=platform)


def test_step_resolves_frontends_from_the_step():
    """``ops.step`` resolves against the step's features: a CUDA backend
    named for a frontend step raises before anything runs."""
    pipe, cfg, _ = _build("subword", tile=4)
    batch = next(pipe.batches(pad_len=32, epoch=0))
    step = batch.step_inputs(0.05, "cpu")
    t = Tables(w_in=torch.zeros(pipe.table_rows, cfg.dim),
               w_out=torch.zeros(pipe.table_rows, cfg.dim))
    with pytest.raises(ValueError, match="frontend feature"):
        ops.step(t, step, cfg, backend="cuda_tiled")


# ---------------------------------------------------------------------------
# Sessions against the reference's
# ---------------------------------------------------------------------------

def _sessions(name, tile, shard, **kw):
    """A port session from the reference session's tables, both fresh."""
    extra = dict(vocab_shard=True, hot_vocab_frac=0.3) if shard else {}
    rpipe, rcfg, _ = _build(name, "ref", tile=tile, **extra, **kw)
    rs = RefSession(rpipe, rcfg, backend="jnp")
    pipe, cfg, _ = _build(name, tile=tile, **extra, **kw)
    ps = TrainSession(pipe, cfg, device="cpu")
    ps.state = params_from_reference(
        {k: np.asarray(v) for k, v in rs.state.params().items()}, "cpu")
    return ps, rs


@pytest.mark.parametrize("shard", [False, True])
@pytest.mark.parametrize("tile", [1, 4])
@pytest.mark.parametrize("name", WORKLOADS)
def test_session_matches_reference(name, tile, shard):
    ps, rs = _sessions(name, tile, shard)
    assert ps.backend == ("torch_tiled" if tile > 1 else "torch")
    assert ps.state.params().keys() == rs.state.params().keys()
    init = ps.embeddings().copy()      # on the CPU a view of the table
    assert init.shape[0] == ps.pipeline.table_rows
    rm = list(rs.stream(max_batches=3))
    pm = list(ps.stream(max_batches=3))
    assert [m.words_seen for m in pm] == [m.words_seen for m in rm]
    got, want = ps.embeddings(), np.asarray(rs.embeddings())
    np.testing.assert_allclose(got, want, **TOL)
    if shard:
        assert ps.placement.to_extra() == rs.placement.to_extra()
        out = ps.placement.merge(ps.state.w_out.numpy(),
                                 ps.state.cold_out.numpy())
        rout = rs.placement.merge(np.asarray(rs.state.w_out),
                                  np.asarray(rs.state.cold_out))
    else:
        out, rout = ps.state.w_out.numpy(), np.asarray(rs.state.w_out)
    np.testing.assert_allclose(out, rout, **TOL)
    V = ps.pipeline.vocab.size
    assert np.abs(got[:V] - init[:V]).max() > 1e-4          # it trained
    if name != "node2vec":                     # and so did the extra rows
        assert np.abs(got[V:] - init[V:]).max() > 1e-4


@pytest.mark.parametrize("name", WORKLOADS)
def test_one_shard_is_bit_identical_to_replicated(name):
    pipe, cfg, _ = _build(name, tile=4)
    a = TrainSession(pipe, cfg, device="cpu")
    pipe, cfg, _ = _build(name, tile=4, vocab_shard=True, hot_vocab_frac=0.3)
    b = TrainSession(pipe, cfg, device="cpu")
    assert b.placement.vocab_size == pipe.table_rows
    a.train(max_batches=3)
    b.train(max_batches=3)
    np.testing.assert_array_equal(a.embeddings(), b.embeddings())


def test_subword_on_mixed_int8_tables_stays_finite():
    """The n-gram rows sit in the int8 cold tail (zero counts) and train
    through the exact exchange in storage precision."""
    pipe, cfg, _ = _build("subword", tile=4,
                          tables="hot=bf16:frac=0.25,cold=int8,shards=1")
    s = TrainSession(pipe, cfg, device="cpu")
    V = pipe.vocab.size
    assert s.state.cold_in.dtype == torch.int8
    assert s.state.w_in.dtype == torch.bfloat16
    assert s.placement.hot < V and s.placement.vocab_size == pipe.table_rows
    init = s.embeddings().copy()
    s.train(max_batches=3)
    emb = s.embeddings()
    assert np.isfinite(emb).all() and emb.shape == (pipe.table_rows, 16)
    assert np.abs(emb[V:] - init[V:]).max() > 0           # buckets trained


def test_doc2vec_checkpoint_resumes_mid_epoch_bit_exact(tmp_path):
    def session(**kw):
        pipe, cfg, _ = _build("doc2vec", tile=4)
        return TrainSession(pipe, cfg, device="cpu", **kw)

    full = session()
    full.train()
    assert full.state.batches_seen == 3
    d = str(tmp_path / "ck")
    session(ckpt_dir=d, ckpt_every=1).train(max_batches=2)
    again = session(ckpt_dir=d)
    assert again.resumed_step == 2 and again._resume_skip == 2
    again.train()
    assert again.state.words_seen == full.state.words_seen
    for k, v in full.state.params().items():
        assert torch.equal(again.state.params()[k], v), k
    assert again.embeddings().shape[0] == again.pipeline.table_rows


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "w2v", "--device",
         "cpu", "--vocab", "96", "--clusters", "6", "--sentences", "120",
         "--sentences-per-batch", "16", "--max-batches", "3", "--epochs",
         "1", "--walks-per-node", "1", "--docs", "12",
         "--subword-buckets", "64", *args], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("name,extra", [
    ("node2vec", ""), ("doc2vec", " (+12 doc2vec rows)"),
    ("subword", " (+64 subword rows)")])
def test_cli_runs_every_workload(name, extra):
    outs = [_cli("--workload", name, "--tile-windows", "4", *flags)
            for flags in ((), ("--prefetch-workers", "2"))]
    digests = []
    for out in outs:
        assert out.returncode == 0, out.stderr
        assert f"workload={name} vocab=" in out.stdout, out.stdout
        assert f"{extra} params=" in out.stdout, out.stdout
        assert "backend=torch_tiled device=cpu" in out.stdout, out.stdout
        assert "quality:" in out.stdout, out.stdout
        digests.append(out.stdout.split("final_digest=")[1].split()[0])
    assert digests[0] == digests[1]


@pytest.mark.parametrize("tile,G", [(0, 0), (4, 2), (8, 4)])
@pytest.mark.parametrize("kind", ["none", "both"])
def test_plain_versions_add_one_value_per_row(monkeypatch, kind, tile, G):
    """Every ``index_add_`` of the plain versions adds at most one nonzero
    value to a row (repeated bag members receive the same delta, a fused
    group's windows add one window at a time): CUDA's ``index_add_`` adds
    repeated indices with atomics in no fixed order, so this is what makes
    a rerun on the card give the same bits. ``tile=0``: sequential."""
    real = torch.Tensor.index_add_
    calls = []

    def checked(self, dim, index, source, *a, **kw):
        rows = {}
        for i, r in enumerate(index.tolist()):
            v = source.select(dim, i)
            if bool(v.any()):
                rows.setdefault(r, []).append(v)
        for r, vals in rows.items():
            assert all(torch.equal(vals[0], v) for v in vals), (
                f"index_add_ adds {len(vals)} different values to row {r}")
        calls.append(len(rows))
        return real(self, dim, index, source, *a, **kw)

    # the subword workload's batch: tile-shared negatives (T > 1) make a
    # fused group's output columns repeat across its windows; its bags
    # repeat members; three doc rows past the table, one per sentence
    pipe, _, _ = _build("subword", tile=max(tile, 1))
    b = next(pipe.batches(pad_len=32, epoch=0))
    S, rows = 8, pipe.table_rows
    rng = np.random.default_rng(2)
    tables = [(rng.normal(size=(rows + 3, 16)) * 0.1).astype(np.float32)
              for _ in range(2)]
    batch = _torch(*tables, b.tokens[:S], b.negs[:S], b.lengths[:S])
    fe = {} if kind == "none" else dict(
        static_ids=torch.from_numpy(rows + np.arange(S, dtype=np.int32) % 3),
        bags=torch.from_numpy(b.bags[:S]))
    monkeypatch.setattr(torch.Tensor, "index_add_", checked)
    if tile == 0:
        ref.batch_sgns_ref(*batch, 0.05, 2, **fe)
    else:
        p = b.plan
        ref.batch_sgns_tiled_ref(
            *batch, 0.05, 2, tile,
            *_torch(p.uniq[:S], p.scatter[:S], p.ucount[:S], p.strict[:S]),
            gemm_windows=G, **fe)
    assert calls and max(calls) > 1


def test_sharded_checkpoint_with_extra_rows_restores_replicated(tmp_path):
    """A one-shard subword checkpoint (the n-gram rows in the cold tail)
    restores into a replicated session through its recorded placement:
    every table row, the vocabulary and the buckets, bit for bit."""
    pipe, cfg, _ = _build("subword", tile=4, vocab_shard=True,
                          hot_vocab_frac=0.3)
    d = str(tmp_path / "ck")
    a = TrainSession(pipe, cfg, device="cpu", ckpt_dir=d, ckpt_every=2)
    a.train(max_batches=2)
    assert a.placement.vocab_size == pipe.table_rows
    pipe, cfg, _ = _build("subword", tile=4)
    b = TrainSession(pipe, cfg, device="cpu", ckpt_dir=d)
    assert b.resumed_step == 2 and b.placement is None
    np.testing.assert_array_equal(b.embeddings(), a.embeddings())
    assert b.embeddings().shape == (pipe.table_rows, 16)


# ---------------------------------------------------------------------------
# Serve queryability: doc vectors through EmbeddingIndex
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", [False, True])
def test_doc_vectors_queryable_via_embedding_index(shard):
    """A port doc2vec session serves through the port's serving stack: the
    index covers the doc rows past the vocabulary (in the cold tail when
    sharded), its table is the normalized trainer table, and top-k over
    *doc* query ids equals the reference's sharded top-k and dense oracle
    on the same table (ids equal, scores within 1e-6)."""
    from jax.sharding import Mesh

    import repro.serve.index as ref_index
    import repro.serve.query as ref_query
    from repro_torch.serve import EmbeddingIndex, make_topk_fn
    extra = dict(vocab_shard=True, hot_vocab_frac=0.3) if shard else {}
    pipe, cfg, _ = _build("doc2vec", tile=4, **extra)
    sess = TrainSession(pipe, cfg, device="cpu")
    sess.train(max_batches=3)
    idx = EmbeddingIndex.from_session(sess)
    V = pipe.vocab.size
    assert idx.vocab_size == pipe.table_rows == V + KNOBS["doc2vec"]["docs"]
    emb = sess.embeddings()
    norm = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True),
                            1e-12)
    np.testing.assert_allclose(idx.dense_embeddings(), norm, atol=1e-6)
    doc_ids = np.arange(V, pipe.table_rows, dtype=np.int32)
    got = make_topk_fn(idx.placement, idx.mesh, mode="nn", k=5)(
        idx.hot, idx.cold, doc_ids)
    placement = ref_vp.VocabPlacement(**idx.placement.to_extra())
    ridx = ref_index.EmbeddingIndex._stage(
        placement, *placement.split(emb),
        Mesh(np.array(jax.devices()[:1]), ("data",)))
    want = ref_query.dense_topk(ridx.dense_embeddings(), doc_ids, k=5)
    ref_got = ref_query.make_topk_fn(placement, ridx.mesh, mode="nn", k=5)(
        ridx.hot, ridx.cold, doc_ids)
    for w in (want, ref_got):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(w[0]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(w[1]),
                                   atol=1e-6, rtol=0)
