"""The port's vocab-sharded training (one shard) against the reference:
placements, exchange plans and batches bit-identical to ``repro``'s; the
plain version of the split-table kernel (K4) against the reference's
``fullw2v_pallas_tiled_fused`` in interpret mode; sharded sessions against
the reference's within atol 2e-5 / rtol 1e-4; and the port's own contracts
(one-shard sharded == replicated and dense == exact, bit for bit)."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.batching as ref_batching
from repro.configs.w2v import smoke as ref_smoke
from repro.core.trainer import TrainSession as RefSession
from repro.distributed import vocab_placement as ref_vp
from repro.kernels.fullw2v import fullw2v_pallas_tiled_fused
from repro_torch.configs.w2v import smoke
from repro_torch.convert import params_from_reference
from repro_torch.core.trainer import TrainSession
from repro_torch.data import batching
from repro_torch.data.batching import BatchingPipeline, plan_tiles
from repro_torch.data.corpus import synthetic_cluster_corpus
from repro_torch.distributed import collectives as coll
from repro_torch.distributed import vocab_placement as vp
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tables import Tables, TableSpec
from repro_torch.launch.mesh import DataMesh
from tests.conftest import REPO, SRC, make_distinct_negs

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores and these small-tensor
    tests slow tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus():
    return synthetic_cluster_corpus(n_clusters=6, words_per_cluster=12,
                                    n_sentences=200, mean_len=12, seed=0)


def _cfg_kw(tile, **kw):
    return dict(dim=16, sentences_per_batch=64, tile_windows=tile, **kw)


def _sharded_kw(tile):
    return _cfg_kw(tile, vocab_shard=True, hot_vocab_frac=0.3)


# ---------------------------------------------------------------------------
# Host parity: placements, exchange plans, batches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("vocab,hot_frac", [(37, 0.0), (103, 0.2), (8, 0.5)])
def test_placement_bit_identical(vocab, hot_frac, n):
    rng = np.random.default_rng(vocab + n)
    counts = np.sort(rng.integers(1, 500, size=vocab))[::-1]
    a = vp.VocabPlacement.plan(counts, n, hot_frac=hot_frac)
    b = ref_vp.VocabPlacement.plan(counts, n, hot_frac=hot_frac)
    assert a.to_extra() == b.to_extra()
    assert vp.VocabPlacement.from_extra(a.to_extra()) == a
    for prop in ("cold", "cold_pad", "cold_per_shard", "rows_per_device"):
        assert getattr(a, prop) == getattr(b, prop), prop
    ids = np.arange(vocab)
    np.testing.assert_array_equal(a.owner_of(ids), b.owner_of(ids))
    np.testing.assert_array_equal(a.local_row(ids), b.local_row(ids))
    full = rng.normal(size=(vocab, 5)).astype(np.float32)
    for x, y in zip(a.split(full), b.split(full)):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    np.testing.assert_array_equal(a.merge(*a.split(full)), full)


def test_first_seen_unique_matches_reference():
    flat = np.random.default_rng(0).integers(0, 50, size=300)
    np.testing.assert_array_equal(batching.first_seen_unique(flat),
                                  ref_batching.first_seen_unique(flat))


def _manual(mod, tokens, negs, tile):
    tokens = np.asarray(tokens, np.int32)
    negs = np.asarray(negs, np.int32)
    lengths = np.full(tokens.shape[0], tokens.shape[1], np.int32)
    plan = mod.plan_tiles(tokens, negs, lengths, tile) if tile > 1 else None
    return mod.Batch(tokens=tokens, negs=negs, lengths=lengths,
                     n_words=int(lengths.sum()), plan=plan)


def _hot_negs(tokens, hot, n=3):
    """Hot negatives distinct from their target (deterministic)."""
    out = np.empty(tokens.shape + (n,), np.int32)
    for idx, t in np.ndenumerate(tokens):
        out[idx] = [v for v in range(hot) if v != t][:n]
    return out


def _cases(tile):
    """(name, vocab, hot, tokens, negs): a random batch, an all-hot batch
    and a batch with a single cold row."""
    rng = np.random.default_rng(tile)
    tokens = rng.integers(0, 60, size=(4, 8))
    yield "random", 60, 9, tokens, make_distinct_negs(rng, tokens, 60, 3)
    tokens = np.tile(np.arange(8), (4, 1))
    yield "all_hot", 20, 19, tokens, _hot_negs(tokens, 19)
    tokens = np.array([[1, 15, 2, 3, 4, 5, 6, 7]] + [[4, 5, 6, 7, 1, 2, 3,
                                                      8]] * 3)
    yield "one_cold", 20, 10, tokens, _hot_negs(tokens, 10)


_EXCHANGE_FIELDS = ("tokens", "negs", "lengths", "cold_ids", "bucket_ids",
                    "bucket_pos", "plan_uniq", "plan_scatter", "plan_ucount",
                    "plan_strict")


def _same_exchange(a, b):
    assert a.n_distinct == b.n_distinct
    assert a.placement.to_extra() == b.placement.to_extra()
    for f in _EXCHANGE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("tile", [1, 4])
def test_plan_exchange_bit_identical(tile, n):
    for name, vocab, hot, tokens, negs in _cases(tile):
        a = vp.plan_exchange(_manual(batching, tokens, negs, tile),
                             vp.VocabPlacement(vocab, hot, n))
        b = ref_vp.plan_exchange(_manual(ref_batching, tokens, negs, tile),
                                 ref_vp.VocabPlacement(vocab, hot, n))
        _same_exchange(a, b)
        if name == "all_hot":
            assert a.n_distinct == [0] * n and (a.cold_ids == -1).all()
        if name == "one_cold":
            assert sum(a.n_distinct) == 1


@pytest.mark.parametrize("tile", [1, 4])
def test_finalize_packed_with_placement_bit_identical(tile):
    corpus = _corpus()
    kw = _cfg_kw(tile)
    port = BatchingPipeline(corpus, smoke(**kw))
    refp = ref_batching.BatchingPipeline(corpus, ref_smoke(**kw))
    counts = port.vocab.counts
    port.placement = vp.VocabPlacement.plan(counts, 2, hot_frac=0.3)
    refp.placement = ref_vp.VocabPlacement.plan(counts, 2, hot_frac=0.3)
    pad = smoke(**kw).resolved_pad_len
    pairs = list(zip(port.batches(pad_len=pad, epoch=0),
                     refp.batches(pad_len=pad, epoch=0)))
    assert len(pairs) >= 3
    for a, b in pairs:
        assert a.exchange is not None
        _same_exchange(a.exchange, b.exchange)


def test_step_inputs_carry_the_exchange_plan():
    _, vocab, hot, tokens, negs = next(_cases(4))
    ex = vp.plan_exchange(_manual(batching, tokens, negs, 4),
                          vp.VocabPlacement(vocab, hot, 1))
    step = ex.step_inputs(0.025, "cpu")
    assert step.has_vocab_shard and step.has_plan and step.tile == 4
    for f in _EXCHANGE_FIELDS:
        np.testing.assert_array_equal(getattr(step, f).numpy(),
                                      getattr(ex, f))
    assert step.lr.dtype == torch.float32 and step.lr.device.type == "cpu"


# ---------------------------------------------------------------------------
# K4's plain version against the reference kernel (interpret mode)
# ---------------------------------------------------------------------------

def test_plain_fused_matches_reference_pallas_interpret():
    """The second case of test_kernel_tiled's split-table test (d=128): a
    cold working row shared by two tiles of one sentence and a token that
    is another tile's negative. The first case (strict-heavy, V=30) costs
    the same ~30 s in interpret mode and is left out; the strict path of
    the plain tiled version is held against the reference in
    test_torch_kernels. Within tolerance, not bit for bit (~1.5e-8)."""
    rng = np.random.default_rng(0)
    w_f, tile, N, d, V, hot, L = 2, 4, 3, 128, 600, 17, 16
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, V, size=(2, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    negs[0, 1, 0] = negs[0, 2 * tile + 1, 0] = hot + 3
    negs[1, tile, 1] = tokens[1, 0]
    lengths = np.array([L, L - 3], np.int32)
    plan = plan_tiles(tokens, negs, lengths, tile)
    assert (plan.uniq[0] == hot + 3).sum() == 2     # one cold row, two tiles
    tabs = (w_in[:hot], w_out[:hot], w_in[hot:], w_out[hot:])
    idx = (tokens, negs, lengths)
    pl = (plan.uniq, plan.scatter, plan.ucount, plan.strict)
    want = fullw2v_pallas_tiled_fused(
        *(jnp.asarray(a) for a in tabs + idx), jnp.float32(0.05), w_f, tile,
        *(jnp.asarray(a) for a in pl), interpret=True)
    put = [torch.from_numpy(np.array(a)) for a in tabs + idx + pl]
    got = ref.batch_sgns_tiled_fused_ref(*put[:7], 0.05, w_f, tile, *put[7:])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert np.abs(got[2].numpy() - tabs[2]).max() > 1e-4   # cold rows moved


def test_plain_fused_is_tiled_on_concat():
    rng = np.random.default_rng(1)
    V, hot, d, L, N, tile = 50, 1, 16, 12, 3, 4     # hot may be one row
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, V, size=(3, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    lengths = np.array([L, 7, 1], np.int32)
    plan = plan_tiles(tokens, negs, lengths, tile)
    t = [torch.from_numpy(a) for a in (tokens, negs, lengths, plan.uniq,
                                       plan.scatter, plan.ucount,
                                       plan.strict)]
    full = ref.batch_sgns_tiled_ref(torch.tensor(w_in), torch.tensor(w_out),
                                    *t[:3], 0.05, 2, tile, *t[3:])
    split = ref.batch_sgns_tiled_fused_ref(
        torch.tensor(w_in[:hot]), torch.tensor(w_out[:hot]),
        torch.tensor(w_in[hot:]), torch.tensor(w_out[hot:]), *t[:3], 0.05, 2,
        tile, *t[3:])
    assert torch.equal(torch.cat([split[0], split[2]]), full[0])
    assert torch.equal(torch.cat([split[1], split[3]]), full[1])


# ---------------------------------------------------------------------------
# Sessions: the port against the reference, and its own contracts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exchange", ["exact", "dense"])
@pytest.mark.parametrize("tile", [1, 4])
def test_sharded_session_matches_reference(tile, exchange):
    corpus = _corpus()
    rcfg = ref_smoke(**_sharded_kw(tile))
    refs = RefSession(ref_batching.BatchingPipeline(corpus, rcfg), rcfg,
                      backend="jnp", exchange=exchange)
    cfg = smoke(**_sharded_kw(tile))
    port = TrainSession(BatchingPipeline(corpus, cfg), cfg, device="cpu",
                        exchange=exchange)
    assert port.backend == ("torch" if tile == 1 else "torch_tiled")
    assert port.placement.to_extra() == refs.placement.to_extra()
    params = {k: np.asarray(v) for k, v in refs.state.params().items()}
    assert set(params) == {"hot_in", "hot_out", "cold_in", "cold_out"}
    port.state = params_from_reference(params, "cpu")

    ref_m = list(refs.stream(max_batches=3))
    port_m = list(port.stream(max_batches=3))
    assert [m.words_seen for m in port_m] == [m.words_seen for m in ref_m]
    np.testing.assert_allclose(port.embeddings(), refs.embeddings(), **TOL)
    merged = port.placement.merge(port.state.w_out.numpy(),
                                  port.state.cold_out.numpy())
    want = refs.placement.merge(np.asarray(refs.state.w_out),
                                np.asarray(refs.state.cold_out))
    np.testing.assert_allclose(merged, want, **TOL)
    assert np.abs(port.embeddings() - refs.placement.merge(
        params["hot_in"], params["cold_in"])).max() > 1e-4   # it trained


def _train_pair(tile, max_batches=3):
    corpus = _corpus()
    cfg = smoke(**_cfg_kw(tile))
    pipe = BatchingPipeline(corpus, cfg)
    cfg_vs = smoke(**_sharded_kw(tile))
    a = TrainSession(pipe, cfg, device="cpu")
    b = TrainSession(BatchingPipeline(corpus, cfg_vs, vocab=pipe.vocab),
                     cfg_vs, device="cpu")
    a.train(max_batches=max_batches)
    b.train(max_batches=max_batches)
    return a, b


@pytest.mark.parametrize("tile", [1, 4])
def test_single_shard_sharded_training_bit_identical(tile):
    """One shard — gather, compact working table, kernel, write-back — is
    bit-identical to the replicated session (the reference's contract)."""
    a, b = _train_pair(tile)
    assert b.placement is not None and b.placement.n_shards == 1
    np.testing.assert_array_equal(a.embeddings(), b.embeddings())
    full_out = b.placement.merge(b.state.w_out.numpy(),
                                 b.state.cold_out.numpy())
    np.testing.assert_array_equal(a.state.w_out.numpy(), full_out)


@pytest.mark.parametrize("tile", [1, 4])
def test_exchange_dense_and_exact_bit_identical(tile):
    corpus = _corpus()
    cfg_vs = smoke(**_sharded_kw(tile))
    sessions = []
    for flavor in ("dense", "exact"):
        s = TrainSession(BatchingPipeline(corpus, cfg_vs), cfg_vs,
                         device="cpu", exchange=flavor)
        assert s.exchange == flavor
        s.train(max_batches=3)
        sessions.append(s)
    a, b = sessions
    for name, t in a.state.params().items():
        assert torch.equal(t, b.state.params()[name]), name


def test_sharded_session_reports_split_param_tree():
    a, b = _train_pair(1, max_batches=1)
    params = b.state.params()
    assert set(params) == {"hot_in", "hot_out", "cold_in", "cold_out"}
    assert params["hot_in"].shape[0] == b.placement.hot
    assert params["cold_in"].shape[0] == b.placement.cold_pad
    hot, cold, placement = b.embeddings_sharded()
    assert placement is b.placement
    np.testing.assert_array_equal(placement.merge(hot.numpy(), cold.numpy()),
                                  b.embeddings())
    assert a.embeddings_sharded() == (a.state.w_in, None, None)


def test_session_rejects_vocab_shard_incapable_backend():
    cfg_vs = smoke(**_sharded_kw(1))
    with pytest.raises(ValueError, match="vocab-sharded"):
        TrainSession(BatchingPipeline(_corpus(), cfg_vs), cfg_vs,
                     backend="cuda_pipelined", device="cpu")


def _sharded_step(n_shards):
    corpus = _corpus()
    cfg = smoke(**_sharded_kw(4))
    pipe = BatchingPipeline(corpus, cfg)
    batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    pl = vp.VocabPlacement.plan(pipe.vocab.counts, n_shards, hot_frac=0.3)
    tables = Tables(
        w_in=torch.zeros((pl.hot, 16)), w_out=torch.zeros((pl.hot, 16)),
        cold_in=torch.zeros((pl.cold_per_shard, 16)),
        cold_out=torch.zeros((pl.cold_per_shard, 16)),
        spec=TableSpec(vocab_shard=True), placement=pl)
    return cfg, batch, tables, vp.plan_exchange(batch, pl)


def test_more_than_one_shard_raises_on_the_device_step():
    """Two shards run on a mesh of two ranks, one shard each: without one
    the step raises, and a step carrying every requester's plan rows (a
    lift without the rank) is refused by the runner."""
    cfg, _, tables, ex = _sharded_step(2)
    with pytest.raises(ValueError, match="mesh of 2 ranks"):
        ops.step(tables, ex.step_inputs(0.025, "cpu"), cfg)
    run = ops._VocabShardedRun("torch", ops.static_for(cfg), ex.placement,
                               mesh=DataMesh(rank=0, size=2, device="cpu"))
    with pytest.raises(ValueError, match="lift this rank's row"):
        run.route(ex.step_inputs(0.025, "cpu"))


@pytest.mark.parametrize("fn", [coll.all_gather, coll.all_to_all,
                                coll.psum_scatter, coll.pmean])
def test_collectives_are_identities_on_one_shard(fn):
    """No mesh, or a mesh of one rank, touches no process group: each
    collective returns its input (``all_gather`` adds the rank axis).
    More ranks run in tests/test_torch_mesh.py."""
    x = torch.arange(12.0).view(1, 3, 4)
    for mesh in (None, DataMesh(rank=0, size=1, device="cpu")):
        got = fn(x, mesh)
        assert torch.equal(got.reshape(x.shape), x)


def test_step_rejects_mismatched_tables_and_steps():
    cfg, batch, tables, ex = _sharded_step(1)
    with pytest.raises(ValueError, match="exchange plan"):
        ops.step(tables, batch.step_inputs(0.025, "cpu"), cfg)
    replicated = Tables(w_in=torch.zeros((72, 16)),
                        w_out=torch.zeros((72, 16)))
    with pytest.raises(ValueError, match="single-replica"):
        ops.step(replicated, ex.step_inputs(0.025, "cpu"), cfg)
    with pytest.raises(ValueError, match="vocab_shard"):
        Tables(w_in=tables.w_in, w_out=tables.w_out,
               spec=TableSpec(vocab_shard=True)).check_runnable()
    # an int8 tail runs since the mixed-precision slice, with its scales
    with pytest.raises(ValueError, match="scales"):
        Tables(w_in=tables.w_in, w_out=tables.w_out, cold_in=tables.cold_in,
               cold_out=tables.cold_out, placement=tables.placement,
               spec=TableSpec(vocab_shard=True, cold_dtype="int8")
               ).check_runnable()
    # a shard of two holds its stripe, cold_per_shard rows
    _, _, two, _ = _sharded_step(2)
    two.check_runnable()
    whole = two.placement.cold_pad
    with pytest.raises(ValueError, match="cold_per_shard"):
        Tables(w_in=two.w_in, w_out=two.w_out,
               cold_in=torch.zeros((whole, 16)),
               cold_out=torch.zeros((whole, 16)), spec=two.spec,
               placement=two.placement).check_runnable()


def test_params_from_reference_takes_the_split_tree():
    split = {"hot_in": np.ones((3, 4), np.float32),
             "hot_out": np.zeros((3, 4), np.float32),
             "cold_in": np.full((5, 4), 2, np.float32),
             "cold_out": np.zeros((5, 4), np.float32)}
    st = params_from_reference(split, "cpu")
    assert set(st.params()) == set(split)
    assert st.cold_in.sum() == 40 and st.w_in.shape == (3, 4)
    with pytest.raises(ValueError, match="cold_out"):
        params_from_reference({k: v for k, v in split.items()
                               if k != "cold_out"}, "cpu")
    with pytest.raises(ValueError, match="one d"):
        params_from_reference({**split, "cold_in": np.ones((5, 3),
                                                           np.float32)},
                              "cpu")


def test_step_rebuilds_a_plain_prebuilt_step_for_a_sharded_session():
    cfg = smoke(**_sharded_kw(4))
    b = TrainSession(BatchingPipeline(_corpus(), cfg), cfg, device="cpu")
    batch = next(b.pipeline.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    plain = batch.step_inputs(b.current_lr(), "cpu")
    assert not plain.has_vocab_shard
    b.train_batch(batch, step=plain)       # rebuilt from the host batch
    c = TrainSession(BatchingPipeline(_corpus(), cfg), cfg, device="cpu")
    c.train(max_batches=1)
    np.testing.assert_array_equal(b.embeddings(), c.embeddings())


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    # one OpenMP thread, as in test_torch_trainer's CLI runs
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "w2v", "--device",
         "cpu", "--vocab", "128", "--clusters", "8", "--sentences", "80",
         "--sentences-per-batch", "16", "--max-batches", "3", "--epochs",
         "1", *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("flags", [
    ("--vocab-shard", "--tile-windows", "4"),
    ("--vocab-shard", "1", "--hot-vocab-frac", "0.25"),
    ("--tables", "shards=1,exchange=dense", "--tile-windows", "4")])
def test_cli_runs_vocab_sharded_on_cpu(flags):
    out = _cli(*flags)
    assert out.returncode == 0, out.stderr
    assert "vocab_shard: hot=" in out.stdout and "shards=1" in out.stdout
    for key in ("throughput:", "final_digest=", "quality:"):
        assert key in out.stdout, out.stdout


@pytest.mark.parametrize("flags,names", [
    (("--vocab-shard", "2"), "shards=2 ranks=2 backend=gloo"),
    (("--tables", "cold=int8,shards=2"), "shards=2 ranks=2 backend=gloo"),
    (("--tables", "shards=4"), "shards=4 ranks=4 backend=gloo")])
def test_cli_rejects_later_slice_sharding(flags, names):
    """More than one shard runs since the data-parallel slice: the CLI
    starts a rank per shard (gloo on the CPU) and rank 0 prints the usual
    lines once."""
    out = _cli(*flags)
    assert out.returncode == 0, out.stderr
    assert names in out.stdout, out.stdout
    for key in ("throughput:", "final_digest=", "quality:"):
        assert out.stdout.count(key) == 1, out.stdout
