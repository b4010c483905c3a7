"""The port's serving stack (``repro_torch.serve``, ``repro_torch.launch.
serve``) against the reference's (``repro.serve``) at one rank, on the CPU.

Each test of ``tests/test_serve.py`` has its mirror here (the multi-shard
case at one rank: ``tests/test_torch_serve_mesh.py`` runs 2 and 4 ranks).
Where the reference's test checks an invariant, the same inputs, made with
numpy from the same seeds, also go through the reference's functions on
the CPU (``EmbeddingIndex._stage``, ``make_topk_fn``, ``dense_topk``):
top-k ids must be equal and scores within ``TOL`` = 1e-6, the reference's
own parity tolerance (the two packages normalize and multiply in f32 in
their own orders, ~1e-7 apart). Exact ties use tables of small integers,
whose dot products and norms are exact in f32 in any order, beside the
reference's random normal table with a duplicated row.

Cross-format cases: a checkpoint written by either package's
``checkpoint.save`` (replicated, split at 2 shards, a bf16 head with an
int8 tail and its scales) loads in both packages' ``EmbeddingIndex`` with
the same answers. The CLI runs as a ``--device cpu`` subprocess.
"""
import os
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh

import repro.serve.index as ref_index
import repro.serve.query as ref_query
from repro.distributed.vocab_placement import VocabPlacement as RefPlacement
from repro.train import checkpoint as ref_ckpt
from repro_torch.distributed.vocab_placement import VocabPlacement
from repro_torch.serve import (EmbeddingIndex, EmbeddingServer,
                               SnapshotWatcher, dense_topk, make_topk_fn)
from repro_torch.serve.chaos import SCHEDULES, _publish, run_serve_chaos
from repro_torch.serve.index import _restripe
from repro_torch.train import checkpoint as ckpt
from tests.conftest import REPO, SRC

V, HOT, D = 64, 12, 16
TOL = 1e-6          # scores, port vs reference (ids must be equal)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh1():
    return Mesh(np.array(jax.devices()[:1]), ("data",))


def _table(seed=0, v=V, d=D):
    return np.random.default_rng(seed).standard_normal(
        (v, d)).astype(np.float32)


def _norm(table):
    return table / np.maximum(np.linalg.norm(table, axis=1, keepdims=True),
                              1e-12)


def _index(seed=0, v=V, hot=HOT, d=D, step=0, table=None):
    placement = VocabPlacement(vocab_size=v, hot=hot, n_shards=1)
    h, c = placement.split(_table(seed, v, d) if table is None else table)
    return EmbeddingIndex._stage(placement, h, c, None, step=step,
                                 device="cpu")


def _ref_index(table, hot=HOT):
    placement = RefPlacement(vocab_size=table.shape[0], hot=hot, n_shards=1)
    h, c = placement.split(table)
    return ref_index.EmbeddingIndex._stage(placement, h, c, _mesh1())


def _same(got, want):
    """(ids, scores) pairs: ids equal, scores within TOL."""
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               atol=TOL, rtol=0)


def _port_topk(idx, ids, k, mode="nn"):
    fn = make_topk_fn(idx.placement, idx.mesh, mode=mode, k=k)
    return tuple(t.numpy() for t in fn(idx.hot, idx.cold, ids))


def _ref_topk(ridx, ids, k, mode="nn"):
    fn = ref_query.make_topk_fn(ridx.placement, ridx.mesh, mode=mode, k=k)
    return fn(ridx.hot, ridx.cold, ids)


def _parity(table, ids, k, mode="nn", hot=HOT):
    """The port's sharded top-k and dense oracle against the reference's
    sharded top-k and dense oracle on one table."""
    idx, ridx = _index(table=table, v=table.shape[0], d=table.shape[1],
                       hot=hot), _ref_index(table, hot)
    got = _port_topk(idx, ids, k, mode)
    want = ref_query.dense_topk(ridx.dense_embeddings(), ids, k=k, mode=mode)
    _same(got, want)
    _same(got, _ref_topk(ridx, ids, k, mode))
    _same(dense_topk(idx.dense_embeddings(), ids, k=k, mode=mode), want)
    return got


# -- index construction -------------------------------------------------------
def test_index_rows_normalized():
    idx = _index()
    dense = idx.dense_embeddings()
    np.testing.assert_allclose(np.linalg.norm(dense, axis=1), np.ones(V),
                               atol=1e-5)
    np.testing.assert_allclose(dense, _ref_index(_table()).dense_embeddings(),
                               atol=TOL, rtol=0)
    assert idx.hot.dtype == torch.float32 and idx.device.type == "cpu"


def test_index_load_split_checkpoint_without_merge(tmp_path, monkeypatch):
    """Loading a split checkpoint restores only the input-table leaves
    and never calls VocabPlacement.merge (the no-(V,d)-reassembly
    contract); the reference loads the port's publish to the same
    table."""
    d = str(tmp_path)
    table = _table(1)
    placement = VocabPlacement(vocab_size=V, hot=HOT, n_shards=1)
    _publish(d, 30, table, placement)

    def boom(*a, **k):
        raise AssertionError("serving load reassembled the full table")
    monkeypatch.setattr(VocabPlacement, "merge", boom)
    idx = EmbeddingIndex.load(d, device="cpu")
    assert idx.step == 30 and idx.vocab_size == V
    assert idx.placement == placement
    monkeypatch.undo()
    np.testing.assert_allclose(idx.dense_embeddings(), _norm(table),
                               atol=1e-6)
    ref = ref_index.EmbeddingIndex.load(d)
    np.testing.assert_allclose(idx.dense_embeddings(),
                               ref.dense_embeddings(), atol=TOL, rtol=0)


def test_index_load_replicated_checkpoint(tmp_path):
    """A replicated (w_in/w_out) checkpoint is split under a prefix-head
    placement at load time, as the reference splits it."""
    d = str(tmp_path)
    table = _table(2)
    ckpt.save(d, 5, {"w_in": table, "w_out": table * 0.5})
    idx = EmbeddingIndex.load(d, hot_frac=0.25, device="cpu")
    assert idx.placement.hot == 16 and idx.n_shards == 1
    np.testing.assert_allclose(idx.dense_embeddings(), _norm(table),
                               atol=1e-6)
    ref = ref_index.EmbeddingIndex.load(d, hot_frac=0.25)
    assert idx.placement.to_extra() == ref.placement.to_extra()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_restripe_permutes_between_layouts(dtype):
    """Elastic serving: re-striping cold rows between shard counts is a
    pure permutation — merge(src) == merge(dst) row for row — in the
    storage dtype, the reference's permutation."""
    table = _table(3)
    if dtype == "int8":
        table = np.clip(np.round(table * 40), -127, 127).astype(np.int8)
    src = VocabPlacement(vocab_size=V, hot=HOT, n_shards=4)
    dst = VocabPlacement(vocab_size=V, hot=HOT, n_shards=2)
    hot, cold_src = src.split(table)
    cold_dst = _restripe(torch.from_numpy(cold_src), src, dst)
    assert cold_dst.dtype == torch.from_numpy(cold_src).dtype
    np.testing.assert_array_equal(dst.merge(hot, cold_dst.numpy()), table)
    want = ref_index._restripe(cold_src, RefPlacement(V, HOT, 4),
                               RefPlacement(V, HOT, 2))
    np.testing.assert_array_equal(cold_dst.numpy(), want)


def test_index_load_restripes_on_shard_count_change(tmp_path):
    """A checkpoint written on 2 shards serves on 1 without reassembly:
    the dense views agree exactly."""
    d = str(tmp_path)
    table = _table(4)
    _publish(d, 7, table, VocabPlacement(vocab_size=V, hot=HOT, n_shards=2))
    idx = EmbeddingIndex.load(d, device="cpu")   # one rank -> one shard
    assert idx.n_shards == 1
    np.testing.assert_allclose(idx.dense_embeddings(), _norm(table),
                               atol=1e-6)


def test_index_load_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        EmbeddingIndex.load(str(tmp_path / "empty"), device="cpu")


def test_index_serves_on_the_gpu_unless_cpu_is_asked_for(tmp_path):
    """No silent fallback: without a card, an index asked for no device
    raises instead of landing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    d = str(tmp_path)
    _publish(d, 1, _table(), VocabPlacement(V, HOT, 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingIndex.load(d)
    pl = VocabPlacement(V, HOT, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EmbeddingIndex._stage(pl, *pl.split(_table()))


# -- sharded top-k parity -----------------------------------------------------
def test_topk_parity_boundary_ids_1shard():
    ids = np.array([0, HOT - 1, HOT, HOT + 1, V - 1], np.int32)
    _parity(_table(), ids, k=6)


def test_topk_analogy_parity_1shard():
    triples = np.array([[0, 1, 2], [HOT - 1, HOT, HOT + 1],
                        [V - 1, 0, HOT]], np.int32)
    _parity(_table(5), triples, k=4, mode="analogy")


def _integer_table(seed):
    """Rows of small integers with many exact duplicates: every dot
    product and norm is exact in f32, so tied scores are truly equal."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-3, 4, size=(8, D)).astype(np.float32)
    base[base.sum(axis=1) == 0, 0] = 1.0          # no all-zero row
    base[:, 0] = np.where(base[:, 0] == 0, 2.0, base[:, 0])
    return base[rng.integers(8, size=V)]


@pytest.mark.parametrize("table", ["normal", "integer"])
def test_topk_ties_break_by_id(table):
    """Duplicate rows produce tied scores; both packages must rank the
    lower id first (the lexicographic tie-break parity depends on), over
    the whole candidate list (k = V-1)."""
    if table == "normal":
        t = _table(6)
        t[HOT + 3] = t[2]              # a cold duplicate of a hot row
    else:
        t = _integer_table(6)
    ids = np.array([5, 40], np.int32)
    got = _parity(t, ids, k=V - 1)
    if table == "integer":
        sc = got[1]
        ties = (np.diff(sc, axis=1) == 0)
        assert ties.sum() > 20                     # many exact ties ...
        ids_sorted = np.diff(got[0], axis=1) > 0
        assert ids_sorted[ties].all()              # ... each by id
        _parity(t, np.array([[1, 2, 3], [HOT, 9, 50]], np.int32), k=V - 3,
                mode="analogy")


def test_topk_excludes_query_words():
    idx = _index(7)
    ids = np.arange(8, dtype=np.int32)
    got_ids, _ = _port_topk(idx, ids, k=5)
    for q, row in zip(ids, got_ids):
        assert q not in row
    _parity(_table(7), ids, k=5)


def test_topk_k_too_large_raises():
    idx = _index()
    with pytest.raises(ValueError):
        make_topk_fn(idx.placement, idx.mesh, k=V + 1)
    with pytest.raises(ValueError):
        make_topk_fn(idx.placement, idx.mesh, mode="cosmul")


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 2**31 - 1),     # seed
       st.integers(24, 80),           # vocab
       st.integers(2, 16),            # hot head
       st.integers(1, 8),             # k
       st.integers(1, 6))             # query batch
def test_topk_parity_property_1shard(seed, v, hot, k, b):
    rng = np.random.default_rng(seed)
    hot = min(hot, v - 2)
    table = rng.standard_normal((v, 8)).astype(np.float32)
    ids = rng.integers(v, size=b).astype(np.int32)
    _parity(table, ids, k, hot=hot)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_parity_seeds_1rank(seed):
    """The cases of the reference's multi-shard parity test at one rank:
    random ids plus the hot/cold boundary, nn and analogy."""
    rng = np.random.default_rng(seed)
    v = int(rng.integers(40, 90))
    hot = int(rng.integers(4, 14))
    table = rng.standard_normal((v, 8)).astype(np.float32)
    ids = rng.integers(v, size=9).astype(np.int32)
    ids[:4] = [hot - 1, hot, hot + 1, v - 1]
    _parity(table, ids, k=6, hot=hot)
    tri = rng.integers(v, size=(4, 3)).astype(np.int32)
    _parity(table, tri, k=5, mode="analogy", hot=hot)


# -- session accessors --------------------------------------------------------
def _tiny_session(vocab_shard, tables=None):
    from repro_torch.configs.w2v import smoke
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus

    kw = {} if tables is None else {"tables": tables}
    cfg = smoke(epochs=1, dim=16, vocab_shard=vocab_shard, **kw)
    corpus = synthetic_cluster_corpus(n_clusters=4, words_per_cluster=8,
                                      n_sentences=120, mean_len=8, seed=0)
    sess = TrainSession(BatchingPipeline(corpus, cfg), cfg, device="cpu")
    sess.train(max_batches=2)
    return sess


def test_embeddings_sharded_no_gather():
    sess = _tiny_session(vocab_shard=True)
    hot, cold, placement = sess.embeddings_sharded()
    assert placement is sess.placement
    assert hot.shape == (placement.hot, 16)
    assert cold.shape == (placement.cold_pad, 16)
    np.testing.assert_array_equal(
        placement.merge(hot.numpy(), cold.numpy()), sess.embeddings())


def test_embeddings_sharded_replicated_session():
    sess = _tiny_session(vocab_shard=False)
    full, cold, placement = sess.embeddings_sharded()
    assert cold is None and placement is None
    np.testing.assert_array_equal(full.numpy(), sess.embeddings())


@pytest.mark.parametrize("vocab_shard,tables", [
    (False, None), (True, None), (True, "hot=bf16,cold=int8,shards=1")])
def test_from_session_matches_dense(vocab_shard, tables):
    """The index of a live session is its normalized input table (an int8
    tail dequantized once at staging), and its top-k equals the
    reference's on that table."""
    sess = _tiny_session(vocab_shard, tables)
    idx = EmbeddingIndex.from_session(sess)
    assert idx.step == 2 and idx.device.type == "cpu"
    e = sess.embeddings()
    np.testing.assert_allclose(idx.dense_embeddings(), _norm(e), atol=1e-6)
    ids = np.arange(0, e.shape[0], 5, dtype=np.int32)
    want = ref_query.dense_topk(e, ids, k=5, normalized=False)
    _same(_port_topk(idx, ids, k=5), want)


# -- snapshot watcher ---------------------------------------------------------
def test_watcher_swaps_and_tolerates_corrupt(tmp_path):
    d = str(tmp_path)
    placement = VocabPlacement(vocab_size=V, hot=HOT, n_shards=1)
    _publish(d, 10, _table(8), placement)
    w = SnapshotWatcher(d, poll_s=0.01, device="cpu")
    assert w.poll_once() and w.current().step == 10

    # newer-but-corrupt checkpoint: swap refused, old snapshot serves on
    _publish(d, 20, _table(9), placement)
    npz = os.path.join(d, "step_00000020", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    w.poll_once()
    assert w.current().step == 10 and w.load_failures >= 1

    # a good one after it is picked up (corrupt step was quarantined)
    _publish(d, 30, _table(10), placement)
    assert w.poll_once() and w.current().step == 30
    assert w.swaps == 2
    np.testing.assert_allclose(w.current().dense_embeddings(),
                               _norm(_table(10)), atol=1e-6)


def test_watcher_crash_and_restart(tmp_path):
    d = str(tmp_path)
    placement = VocabPlacement(vocab_size=V, hot=HOT, n_shards=1)
    _publish(d, 10, _table(11), placement)
    w = SnapshotWatcher(d, poll_s=0.01, device="cpu")
    with w:
        w.wait_ready(timeout=30)
        w.inject_crash()
        deadline = time.monotonic() + 10
        while w.alive and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not w.alive and w.crashes == 1
        assert w.current().step == 10        # serving survives the crash
        _publish(d, 20, _table(12), placement)
        w.start()                            # restart picks up missed step
        deadline = time.monotonic() + 10
        while w.current().step != 20 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert w.current().step == 20
    assert not w.alive


def test_watcher_current_before_ready_raises(tmp_path):
    w = SnapshotWatcher(str(tmp_path), poll_s=0.01, device="cpu")
    with pytest.raises(RuntimeError):
        w.current()


# -- server batching ----------------------------------------------------------
def test_server_coalesces_and_answers():
    idx = _index(13, step=42)
    ridx = _ref_index(_table(13))
    with EmbeddingServer(idx, batch_size=8, deadline_ms=20.0,
                         k=4) as server:
        reqs = [server.submit("nn", np.array([i], np.int32))
                for i in range(8)]
        results = [r.wait(30.0) for r in reqs]
        # a full row budget arriving within the deadline rides one batch
        assert server.batches <= 2
        for i, res in enumerate(results):
            assert res.snapshot_step == 42
            want = ref_query.dense_topk(ridx.dense_embeddings(),
                                        np.array([i], np.int32), k=4)
            _same((res.ids, res.scores), want)


def test_server_mixed_kinds_never_share_a_batch():
    idx = _index(14)
    with EmbeddingServer(idx, batch_size=16, deadline_ms=5.0,
                         k=3) as server:
        nn = server.submit("nn", np.array([1, 2], np.int32))
        an = server.submit("analogy", np.array([[1, 2, 3]], np.int32))
        r_nn, r_an = nn.wait(30.0), an.wait(30.0)
        assert r_nn.ids.shape == (2, 3)
        assert r_an.ids.shape == (1, 3)
        assert server.batches == 2
    want = ref_query.dense_topk(_ref_index(_table(14)).dense_embeddings(),
                                np.array([[1, 2, 3]], np.int32), k=3,
                                mode="analogy")
    _same((r_an.ids, r_an.scores), want)


def test_server_close_drains_pending():
    idx = _index(15)
    server = EmbeddingServer(idx, batch_size=4, deadline_ms=1.0, k=3)
    reqs = [server.submit("nn", np.array([i % V], np.int32))
            for i in range(25)]
    server.close()
    assert all(r.event.is_set() for r in reqs)          # zero dropped
    assert server.served == 25
    with pytest.raises(RuntimeError):
        server.submit("nn", np.array([0], np.int32))


def test_server_rejects_bad_requests():
    idx = _index(16)
    with EmbeddingServer(idx, batch_size=4, k=3) as server:
        with pytest.raises(ValueError):
            server.submit("nn", np.arange(5, dtype=np.int32))   # > batch
        with pytest.raises(ValueError):
            server.submit("cosmul", np.array([0], np.int32))
        with pytest.raises(ValueError):
            server.neighbors(np.array([0], np.int32), k=99)


def test_server_concurrent_submitters():
    idx = _index(17)
    dense = _ref_index(_table(17)).dense_embeddings()
    errors = []

    def client(seed):
        try:
            rng = np.random.default_rng(seed)
            with_ids = rng.integers(V, size=3).astype(np.int32)
            res = server.neighbors(with_ids, timeout=30.0)
            want_ids, _ = ref_query.dense_topk(dense, with_ids, k=5)
            assert np.array_equal(res.ids, want_ids)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    with EmbeddingServer(idx, batch_size=8, deadline_ms=2.0,
                         k=5) as server:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


# -- chaos bar ----------------------------------------------------------------
def test_serve_chaos_ci_schedule_zero_dropped_zero_torn():
    rep = run_serve_chaos(SCHEDULES["ci"], timeout=30.0, device="cpu")
    assert rep["dropped"] == 0, rep
    assert rep["torn"] == 0, rep
    assert rep["errors"] == 0, rep
    assert rep["crashes"] == len(SCHEDULES["ci"].crash_at)
    assert rep["swaps"] >= 2                  # live swap + post-restart swap
    assert rep["steps_served"] >= 2           # answers from >1 snapshot
    assert rep["final_step_served"] == 10 * len(SCHEDULES["ci"].publish_at)


# -- one on-disk format -----------------------------------------------------
def _tree(fmt, side):
    """(tree, extra) of one checkpoint format, from seeded numpy tables, in
    one package's array types: ``replicated`` (w_in/w_out), ``split2``
    (split at 2 shards), ``int8`` (a bf16 head and an int8 tail with its
    per-row scales, split at 2 shards)."""
    table = _table(21, v=70)
    if fmt == "replicated":
        return {"w_in": table, "w_out": table * 0.5}, {}
    pl = RefPlacement(vocab_size=70, hot=HOT, n_shards=2)
    hot, cold = pl.split(table)
    extra = {"vocab_shard": pl.to_extra()}
    if fmt == "split2":
        return {"hot_in": hot, "cold_in": cold, "hot_out": hot * 0.5,
                "cold_out": cold * 0.5}, extra
    scale = (np.abs(cold).max(axis=1) / np.float32(127)).astype(np.float32)
    scale = np.where(scale > 0, scale, np.float32(1))
    q = np.clip(np.round(cold / scale[:, None]), -127, 127).astype(np.int8)
    if side == "ref":
        bf = jnp.asarray(hot, jnp.bfloat16)
    else:
        bf = torch.from_numpy(hot).to(torch.bfloat16)
    return {"hot_in": bf, "hot_out": bf, "cold_in": q, "cold_out": q,
            "scale_in": scale, "scale_out": scale}, extra


@pytest.mark.parametrize("fmt", ["replicated", "split2", "int8"])
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_of_either_package_serves_in_both(tmp_path, writer, fmt):
    d = str(tmp_path)
    tree, extra = _tree(fmt, writer)
    (ref_ckpt if writer == "ref" else ckpt).save(d, 3, tree, extra=extra)
    idx = EmbeddingIndex.load(d, device="cpu")
    ref = ref_index.EmbeddingIndex.load(d)
    assert idx.step == ref.step == 3
    assert idx.placement.to_extra() == ref.placement.to_extra()
    if fmt == "int8":
        assert idx.placement.n_shards == 1      # re-striped from 2 shards
    np.testing.assert_allclose(idx.dense_embeddings(),
                               ref.dense_embeddings(), atol=TOL, rtol=0)
    rng = np.random.default_rng(3)
    ids = rng.integers(70, size=12).astype(np.int32)
    ids[:3] = [HOT - 1, HOT, 69]
    tri = rng.integers(70, size=(5, 3)).astype(np.int32)
    for q, mode in ((ids, "nn"), (tri, "analogy")):
        got = _port_topk(idx, q, 6, mode)
        _same(got, _ref_topk(ref, q, 6, mode))
        _same(got, ref_query.dense_topk(ref.dense_embeddings(), q, k=6,
                                        mode=mode))


def test_reference_serves_a_port_publish(tmp_path):
    """``_publish`` of the port writes what the reference's watcher and
    index read, with the same answers."""
    from repro.serve.snapshot import SnapshotWatcher as RefWatcher
    d = str(tmp_path)
    table = _table(22)
    _publish(d, 40, table, VocabPlacement(vocab_size=V, hot=HOT, n_shards=2))
    w = RefWatcher(d, poll_s=0.01)
    assert w.poll_once() and w.current().step == 40
    ids = np.array([0, HOT, V - 1, 7], np.int32)
    _same(_port_topk(EmbeddingIndex.load(d, device="cpu"), ids, 5),
          _ref_topk(w.current(), ids, 5))


# -- the CLI ----------------------------------------------------------------
def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=300)


def test_cli_serves_on_cpu_with_oracle_parity(tmp_path):
    d = str(tmp_path)
    _publish(d, 10, _table(23, v=200), VocabPlacement(200, 20, 2))
    out = _cli("--ckpt-dir", d, "--device", "cpu", "--queries", "48",
               "--mode", "both", "--check-oracle", "--follow", "0.3",
               "--poll-s", "0.05")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "serving: step=10 vocab=200 dim=16 shards=1 hot=20" in out.stdout
    assert "oracle_parity=ok checked=48 mismatches=0" in out.stdout
    assert "serve_stats: queries=" in out.stdout
    assert "follow_done: swaps=0 now_serving_step=10" in out.stdout
    if not torch.cuda.is_available():        # no silent fallback
        out = _cli("--ckpt-dir", d)
        assert out.returncode != 0 and "no CUDA device" in out.stderr
