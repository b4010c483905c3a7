"""The port's serving stack over 2 and 4 gloo ranks (one process a rank,
``repro_torch.launch.mesh.start_ranks`` on the CPU) against the
reference's dense oracle (``repro.serve.query.dense_topk``, one process).

One ``start_ranks`` call per N carries every check (``RANKS`` below):

* the two collectives serving adds (``psum`` in rank order,
  ``broadcast``) against their numpy definitions;
* nn and analogy top-k on the seeds of the reference's multi-shard parity
  test (random ids plus the hot/cold boundary), every rank calling the
  sharded function on its own cold block;
* indexes loaded from checkpoints written at 1, 2 and 4 shards and
  re-striped to N;
* rank 0's ``EmbeddingServer`` over a static index, from 4 client threads,
  while the other ranks run ``serve_follower``;
* a hot swap under the command stream: a publish every rank loads (all
  flip), then one whose load fails on rank 1 only (a ``loader`` that
  fails there): no rank flips, every rank ends on the same step.

The test compares rank 0's answers with the reference's ``dense_topk`` on
the same numpy tables: ids equal, scores within 1e-6. Last, the CLI
``python -m repro_torch.launch.serve --shards 2 --device cpu``."""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro.serve.query import dense_topk as ref_dense_topk
from repro_torch.distributed.vocab_placement import VocabPlacement
from repro_torch.serve.chaos import _publish
from tests.conftest import REPO, SRC

TOL = 1e-6          # scores, port vs reference (ids must be equal)

# numpy helpers the ranks and the test share
HELPERS = textwrap.dedent('''
    import numpy as np

    V, HOT, D = 90, 11, 8


    def seed_case(seed):
        """The reference's multi-shard parity case for one seed."""
        rng = np.random.default_rng(seed)
        v = int(rng.integers(40, 90))
        hot = int(rng.integers(4, 14))
        table = rng.standard_normal((v, 8)).astype(np.float32)
        ids = rng.integers(v, size=9).astype(np.int32)
        ids[:4] = [hot - 1, hot, hot + 1, v - 1]
        tri = rng.integers(v, size=(4, 3)).astype(np.int32)
        return v, hot, table, ids, tri


    def queries(seed):
        rng = np.random.default_rng(100 + seed)
        ids = rng.integers(V, size=10).astype(np.int32)
        ids[:4] = [HOT - 1, HOT, HOT + 1, V - 1]
        return ids, rng.integers(V, size=(5, 3)).astype(np.int32)
''')

RANKS = HELPERS + textwrap.dedent('''
    import ast
    import pickle
    import sys
    import threading
    import time


    def failing_loader(bad_step, bad_rank):
        from repro_torch.serve import EmbeddingIndex

        def load(ckpt_dir, step=None, mesh=None, device=None):
            if mesh.rank == bad_rank and step == bad_step:
                raise OSError(f"injected load fault on rank {mesh.rank}")
            return EmbeddingIndex.load(ckpt_dir, step=step, mesh=mesh,
                                       device=device)
        return load


    def wait(pred, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not pred():
            if time.monotonic() > deadline:
                raise TimeoutError(what)
            time.sleep(0.005)


    def gathered(mesh, value):
        import torch
        from repro_torch.distributed import collectives as coll
        return coll.all_gather(torch.tensor(value), mesh).tolist()


    def ask(server, out, key, seed):
        """Both kinds of query from 4 client threads; (ids, result) per
        request under ``key``."""
        ids, tri = queries(seed)
        res = {}

        def client(c):
            res[c] = ([(q, server.neighbors(q[None], timeout=60))
                       for q in ids[c::4]]
                      + [(t, server.analogy(t[None], timeout=60))
                         for t in tri[c::4]])
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        out[key] = [(q, r.ids, r.scores, r.snapshot_step)
                    for c in range(4) for q, r in res[c]]


    def run(mesh, dirs, swap_dir):
        import torch
        from repro_torch.distributed import collectives as coll
        from repro_torch.distributed.vocab_placement import VocabPlacement
        from repro_torch.serve import (EmbeddingIndex, EmbeddingServer,
                                       SnapshotWatcher, make_topk_fn)
        from repro_torch.serve.chaos import _publish
        from repro_torch.serve.server import serve_follower

        torch.set_num_threads(1)
        n, r = mesh.size, mesh.rank
        out = {}
        # the collectives serving adds
        x = torch.arange(6, dtype=torch.float32) * 0.1 + r
        out["psum"] = coll.psum(x, mesh).numpy()
        b = torch.full((3,), r, dtype=torch.int64)
        out["broadcast"] = gathered(mesh, coll.broadcast(b, mesh)[0].item())
        # the reference's multi-shard parity seeds
        for seed in range(3):
            v, hot, table, ids, tri = seed_case(seed)
            pl = VocabPlacement(vocab_size=v, hot=hot, n_shards=n)
            idx = EmbeddingIndex._stage(pl, *pl.split(table), mesh)
            assert idx.cold.shape[0] == pl.cold_per_shard
            for mode, q, k in (("nn", ids, 6), ("analogy", tri, 5)):
                got = make_topk_fn(pl, mesh, mode=mode, k=k)(idx.hot,
                                                            idx.cold, q)
                out[f"seed{seed}|{mode}"] = tuple(t.numpy() for t in got)
        # checkpoints written at 1, 2 and 4 shards, re-striped to n
        for shards, d in dirs.items():
            idx = EmbeddingIndex.load(d, mesh=mesh)
            assert idx.n_shards == n and idx.step == 7
            ids, tri = queries(shards)
            for mode, q in (("nn", ids), ("analogy", tri)):
                got = make_topk_fn(idx.placement, mesh, mode=mode, k=6)(
                    idx.hot, idx.cold, q)
                out[f"ckpt{shards}|{mode}"] = tuple(t.numpy() for t in got)
        # rank 0's server over a static index; the others follow
        idx = EmbeddingIndex.load(dirs[2], mesh=mesh)
        if r == 0:
            with EmbeddingServer(idx, batch_size=8, deadline_ms=2.0,
                                 k=5) as server:
                ask(server, out, "server", 2)
            out["server_batches"] = server.batches
        else:
            serve_follower(idx, mesh)
        # hot swaps: step 10 at start, 20 loads everywhere, 30 fails on
        # rank 1 only
        w = SnapshotWatcher(swap_dir, mesh=mesh, poll_s=0.02,
                            loader=failing_loader(30, 1))
        pl = VocabPlacement(vocab_size=V, hot=HOT, n_shards=2)
        if r == 0:
            w.start()
            w.wait_ready(timeout=60)
            server = EmbeddingServer(w, batch_size=8, deadline_ms=2.0, k=5)
            ask(server, out, "swap10", 10)
            _publish(swap_dir, 20, np.random.default_rng(20)
                     .standard_normal((V, D)).astype(np.float32), pl)
            wait(lambda: w.current().step == 20, "swap to step 20")
            ask(server, out, "swap20", 20)
            fails = w.load_failures
            _publish(swap_dir, 30, np.random.default_rng(30)
                     .standard_normal((V, D)).astype(np.float32), pl)
            wait(lambda: w.load_failures >= fails + 2, "refused step 30")
            ask(server, out, "swap30", 30)
            w.stop()
            server.close()
            stats = {"swaps": w.swaps, "load_failures": w.load_failures}
        else:
            stats = serve_follower(w, mesh)
        out["steps"] = gathered(mesh, w.current().step)
        out["swaps"] = gathered(mesh, stats["swaps"])
        out["failures"] = gathered(mesh, stats["load_failures"])
        return out


    if __name__ == "__main__":
        from repro_torch.launch.mesh import start_ranks
        n, out_path, swap_dir = int(sys.argv[1]), sys.argv[2], sys.argv[4]
        dirs = ast.literal_eval(sys.argv[3])
        res = start_ranks(run, n, "cpu", dirs, swap_dir, timeout=300)
        with open(out_path, "wb") as f:
            pickle.dump(res, f)
''')


_SHARED = {}
exec(HELPERS, _SHARED)
V, HOT, D = _SHARED["V"], _SHARED["HOT"], _SHARED["D"]


def _table(seed, v=V, d=D):
    return np.random.default_rng(seed).standard_normal(
        (v, d)).astype(np.float32)


def _norm(table):
    return table / np.maximum(np.linalg.norm(table, axis=1, keepdims=True),
                              1e-12)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               atol=TOL, rtol=0)




@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    n = request.param
    tmp = tmp_path_factory.mktemp(f"serve_mesh{n}")
    dirs = {}
    for shards in (1, 2, 4):
        dirs[shards] = str(tmp / f"ckpt{shards}")
        _publish(dirs[shards], 7, _table(shards),
                 VocabPlacement(vocab_size=V, hot=HOT, n_shards=shards))
    swap_dir = str(tmp / "swap")
    _publish(swap_dir, 10, _table(10),
             VocabPlacement(vocab_size=V, hot=HOT, n_shards=2))
    script = tmp / "serve_ranks.py"
    script.write_text(RANKS)
    out = str(tmp / "out.pkl")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(n), out,
                        repr(dirs), swap_dir], env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=400)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert f"ranks={n} backend=gloo" in r.stdout
    with open(out, "rb") as f:
        return n, pickle.load(f)


def test_collectives(ranks):
    n, out = ranks
    want = np.zeros(6, np.float32)
    for r in range(n):                       # the rank-order sum
        want = want + (np.arange(6, dtype=np.float32) * np.float32(0.1)
                       + np.float32(r))
    np.testing.assert_array_equal(out["psum"], want)
    assert out["broadcast"] == [0] * n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_parity_seeds(ranks, seed):
    n, out = ranks
    v, hot, table, ids, tri = _SHARED["seed_case"](seed)
    _same(out[f"seed{seed}|nn"], ref_dense_topk(_norm(table), ids, k=6))
    _same(out[f"seed{seed}|analogy"],
          ref_dense_topk(_norm(table), tri, k=5, mode="analogy"))


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_load_restripes_checkpoint_to_ranks(ranks, shards):
    n, out = ranks
    ids, tri = _SHARED["queries"](shards)
    emb = _norm(_table(shards))
    _same(out[f"ckpt{shards}|nn"], ref_dense_topk(emb, ids, k=6))
    _same(out[f"ckpt{shards}|analogy"],
          ref_dense_topk(emb, tri, k=6, mode="analogy"))


def _check_answers(answers, tables):
    for q, ids, scores, step in answers:
        mode = "nn" if q.ndim == 0 else "analogy"
        want = ref_dense_topk(_norm(tables[step]), q[None], k=5, mode=mode)
        _same((ids, scores), want)


def test_server_with_followers(ranks):
    n, out = ranks
    assert len(out["server"]) == 15 and out["server_batches"] >= 2
    _check_answers(out["server"], {7: _table(2)})


def test_swap_is_all_or_none(ranks):
    n, out = ranks
    tables = {s: _table(s) for s in (10, 20, 30)}
    for key, step in (("swap10", 10), ("swap20", 20), ("swap30", 20)):
        assert {a[3] for a in out[key]} == {step}, key
        _check_answers(out[key], tables)
    assert out["steps"] == [20] * n          # step 30 flipped nowhere
    assert out["swaps"] == [2] * n
    assert min(out["failures"]) >= 2 and len(set(out["failures"])) == 1


def test_cli_serves_over_two_ranks(tmp_path):
    d = str(tmp_path)
    _publish(d, 10, _table(23, v=200), VocabPlacement(200, 20, 1))
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ckpt-dir", d,
         "--device", "cpu", "--shards", "2", "--queries", "40",
         "--check-oracle"], env=env, cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "ranks=2 backend=gloo" in out.stdout
    assert "serving: step=10 vocab=200 dim=8 shards=2 hot=20" in out.stdout
    assert "oracle_parity=ok checked=40 mismatches=0" in out.stdout
    assert "serve_stats: queries=" in out.stdout
