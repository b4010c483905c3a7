"""Supervised recovery and chaos under a ``torch.distributed`` mesh
(``repro_torch.train.supervisor``'s rank vote, ``chaos`` with rank-local
faults, the CLI's resilience flags, ``tools/torch_chaos.py``) on gloo
ranks on the CPU, at d=16 on the chaos workload (300 sentences, 5 batches
an epoch):

* (a) 2 ranks, data-parallel T=1, the ``ci`` schedule with its faults on
  rank 1: the fault-free 2-rank digest, every fault fired, equal reports,
  one quarantined directory;
* (b) the same schedule against the reference's 2-device session running
  its own ``ChaosMonkey`` and ``train_resilient`` from the same tables:
  equal report counts (the NaN kind surfaces there as a step failure, not
  a health failure; the kill finds no worker there) and tables within
  atol 2e-5 / rtol 1e-4;
* (c) 2 ranks, vocab-sharded exact T=4, NaN in rank 1's cold block;
  (d) 4 ranks, vocab-sharded, a failed step and a NaN: equal digests;
* (e) poison excision under 2 ranks equals a run that never trained the
  batch; (f) a checkpoint unhealthy on rank 1 only is quarantined once,
  by rank 0;
* (g) a restart budget exhausted by rank 1's faults and (h) a fault before
  a step's collective end the job with ``RankFailed`` naming rank 1, the
  latter within the group's timeout;
* (i) the CLI's resilience flags on 2 ranks keep the plain run's
  ``final_digest``, and its mixed-storage ``tables:`` line is the
  reference's; (j) ``tools/torch_chaos.py`` at 1 and 2 ranks and its exit
  code.

The ranks run in subprocesses (spawned ranks import their function from
a script's ``__main__``); the reference side runs in one with 2 fake host
devices. Results travel as ``.npz`` and JSON files."""
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import DataMesh
from repro_torch.train.chaos import ChaosMonkey, ChaosSchedule
from repro_torch.train.resilience import StepTimeout
from repro_torch.train.supervisor import (HealthError, MeshDesync,
                                          PeerError, PeerHealthError,
                                          TrainSupervisor)
from tests.conftest import SRC, run_subprocess

ROOT = os.path.dirname(SRC)
TOL = dict(atol=2e-5, rtol=1e-4)

COMMON = textwrap.dedent('''
    import json
    import sys

    import numpy as np

    CI = dict(fail_steps=(3, 5), kill_worker_at=(2,), truncate_ckpt_at=(4,),
              nan_at=(6,))


    def corpus_kw():
        return dict(n_clusters=4, words_per_cluster=8, n_sentences=300,
                    mean_len=10, seed=0)


    def cfg_kw(**kw):
        return dict(dim=16, sentences_per_batch=64, epochs=2, **kw)


    def leaves(params, prefix):
        out = {}
        for k, v in params.items():
            if hasattr(v, "detach"):
                v = v.detach().cpu().numpy().copy()
            out[prefix + k] = np.asarray(v)
        return out
''')

REF = COMMON + textwrap.dedent('''
    def main(path, d):
        from repro.configs.w2v import smoke
        from repro.core.trainer import TrainSession
        from repro.data.batching import BatchingPipeline
        from repro.data.corpus import synthetic_cluster_corpus
        from repro.launch.mesh import make_host_mesh
        from repro.train.chaos import ChaosMonkey, ChaosSchedule

        mesh = make_host_mesh(model=1)
        corpus = synthetic_cluster_corpus(**corpus_kw())
        cfg = smoke(**cfg_kw())
        vocab = BatchingPipeline(corpus, cfg).vocab
        base = TrainSession(BatchingPipeline(corpus, cfg, vocab=vocab), cfg,
                            backend="jnp", mesh=mesh)
        out = leaves(base.state.params(), "init|")
        base.train(max_batches=10)
        out.update(leaves(base.state.params(), "base|"))
        # no process workers: the reference's fork the jax process, which
        # can deadlock; the kill then finds no worker (it fires, a no-op)
        pipe = BatchingPipeline(corpus, cfg, vocab=vocab)
        monkey = ChaosMonkey(ChaosSchedule(**CI), d)
        s = TrainSession(pipe, cfg, backend="jnp", mesh=mesh, ckpt_dir=d,
                         ckpt_every=2, on_batch=monkey.on_batch)
        monkey.bind(pipe)
        s.train_resilient(max_batches=10, max_restarts=4, health_every=1,
                          backoff_s=0.01)
        out.update(leaves(s.state.params(), "final|"))
        np.savez(path, **out)
        r = s.last_report
        with open(path + ".json", "w") as f:
            json.dump({k: getattr(r, k) for k in (
                "restarts", "rollbacks", "health_failures", "timeouts",
                "batches_skipped", "ckpt_quarantined")}
                | {"fired": sorted(monkey.fired)}, f)
''')

PORT = COMMON + textwrap.dedent('''
    import os


    def workload(**kw):
        from repro_torch.configs.w2v import smoke
        from repro_torch.data.corpus import synthetic_cluster_corpus
        return smoke(**cfg_kw(**kw)), synthetic_cluster_corpus(**corpus_kw())


    def session(mesh, cfg, corpus, **kw):
        from repro_torch.core.trainer import TrainSession
        from repro_torch.data.batching import BatchingPipeline
        return TrainSession(BatchingPipeline(corpus, cfg), cfg, device="cpu",
                            mesh=mesh, **kw)


    def digest(sess):
        from repro_torch.train.chaos import params_digest
        return params_digest(sess.gathered_params())


    def counts(report):
        return {k: getattr(report, k) for k in (
            "restarts", "rollbacks", "health_failures", "timeouts",
            "batches_skipped", "ckpt_quarantined", "batches_trained")}


    def all_ranks(mesh, value):
        import torch.distributed as dist
        every = [None] * mesh.size
        dist.all_gather_object(every, value)
        return every


    def chaos(mesh, d, sched_kw, tables=""):
        """run_chaos on the mesh (a, c, d)."""
        from repro_torch.train.chaos import ChaosSchedule, run_chaos
        cfg, corpus = workload(tables=tables, tile_windows=4 if tables else 1)
        POISONED.clear()
        r = run_chaos(ChaosSchedule(**sched_kw), mesh=mesh, ckpt_dir=d,
                      device="cpu", cfg=cfg, corpus=corpus)
        r["poisoned"] = all_ranks(mesh, POISONED)
        return r


    POISONED = []


    def record_poison():
        """Note which table each rank's monkey poisons."""
        from repro_torch.train import chaos
        real = chaos.ChaosMonkey._poison

        def poison(self, state, n):
            before = {k: bool(v.isnan().any()) for k, v in
                      state.params().items()}
            real(self, state, n)
            POISONED.extend(k for k, v in state.params().items()
                            if v.isnan().any() and not before[k])
        chaos.ChaosMonkey._poison = poison


    def versus_reference(mesh, ref_path, d):
        """(b): the port's side of the reference's 2-device chaos run, from
        the reference's initial tables."""
        from repro_torch.convert import params_from_reference
        from repro_torch.data.prefetch import AsyncBatchingPipeline
        from repro_torch.core.trainer import TrainSession
        from repro_torch.train.chaos import ChaosMonkey, ChaosSchedule
        z = np.load(ref_path)
        init = {k[5:]: z[k] for k in z.files if k.startswith("init|")}
        cfg, corpus = workload()
        base = session(mesh, cfg, corpus)
        base.state = params_from_reference(init, "cpu", mesh)
        base.train(max_batches=10)
        sched = ChaosSchedule(**CI)
        pipe = AsyncBatchingPipeline(corpus, cfg, workers=2, mode="process")
        monkey = ChaosMonkey(sched, d, mesh)
        s = TrainSession(pipe, cfg, device="cpu", mesh=mesh, ckpt_dir=d,
                         ckpt_every=2, on_batch=monkey.on_batch)
        s.state = params_from_reference(init, "cpu", mesh)
        monkey.bind(pipe)
        s.train_resilient(max_batches=10, max_restarts=4, health_every=1,
                          backoff_s=0.01)
        return {"counts": all_ranks(mesh, counts(s.last_report)),
                "fired": sorted(set().union(*all_ranks(mesh, monkey.fired))),
                "quarantined": len([n for n in os.listdir(d)
                                    if ".corrupt" in n]),
                "bitwise": digest(s) == digest(base),
                "leaves": leaves(s.gathered_params(), "")}


    def poison_skip(mesh, d):
        """(e): rank 1's replica poisoned after batch 5, excised; a fresh
        2-rank run told to skip the same key ends with the same tables."""
        cfg, corpus = workload()
        s = session(mesh, cfg, corpus, ckpt_dir=d, ckpt_every=2)
        fired = []

        def poison(state):
            if mesh.rank == 1 and state.batches_seen == 5 and not fired:
                fired.append(True)
                state.w_in[0, 0] = float("nan")

        s.on_batch = poison
        s.train_resilient(health_every=1, skip_poison=True, backoff_s=0.0)
        replay = session(mesh, cfg, corpus)
        replay.poison_skip.update(s.poison_skip)
        replay.train()
        return {"counts": all_ranks(mesh, counts(s.last_report)),
                "keys": all_ranks(mesh, sorted(s.poison_skip)),
                "skipped": replay.batches_skipped,
                "equal": digest(s) == digest(replay),
                "batches_seen": s.state.batches_seen}


    def quarantine_once(mesh, d):
        """(f): sharded T=4; rank 1's cold block poisoned after batch 3,
        probed every 2 batches, so checkpoint 4 holds the NaN on rank 1's
        stripe alone."""
        from repro_torch.train import checkpoint as ckpt
        calls = []
        real = ckpt.quarantine

        def counted(*a):
            calls.append(a[1])
            return real(*a)

        ckpt.quarantine = counted
        cfg, corpus = workload(tables=SHARDED.format(n=mesh.size),
                               tile_windows=4)
        base = session(mesh, cfg, corpus)
        base.train()
        s = session(mesh, cfg, corpus, ckpt_dir=d, ckpt_every=2)
        fired = []

        def poison(state):
            if mesh.rank == 1 and state.batches_seen == 3 and not fired:
                fired.append(True)
                state.cold_in[0, 0] = float("nan")

        s.on_batch = poison
        s.train_resilient(health_every=2, backoff_s=0.0)
        return {"counts": all_ranks(mesh, counts(s.last_report)),
                "calls": all_ranks(mesh, calls),
                "dirs": sorted(n for n in os.listdir(d) if ".corrupt" in n),
                "equal": digest(s) == digest(base)}


    def two(mesh, ref_path, root):
        import torch
        torch.set_num_threads(1)
        record_poison()
        out = {}
        out["a"] = chaos(mesh, f"{root}/a", CI)
        out["c"] = chaos(mesh, f"{root}/c", dict(
            fail_steps=(3,), nan_at=(6,), max_batches=8, prefetch_workers=0,
            prefetch_mode="thread"), SHARDED.format(n=2))
        out["e"] = poison_skip(mesh, f"{root}/e")
        out["f"] = quarantine_once(mesh, f"{root}/f")
        b = versus_reference(mesh, ref_path, f"{root}/b")
        if mesh.rank == 0:
            np.savez(f"{root}/b.npz", **b.pop("leaves"))
        out["b"] = b
        return out


    def four(mesh, root):
        import torch
        torch.set_num_threads(1)
        record_poison()
        return chaos(mesh, f"{root}/d", dict(
            fail_steps=(3,), nan_at=(5,), max_batches=8, prefetch_workers=0,
            prefetch_mode="thread"), SHARDED.format(n=4))


    def budget(mesh, root):
        """(g): rank 1 fails batches 2 and 3 against a budget of one."""
        from repro_torch.train.chaos import ChaosSchedule, run_chaos
        cfg, corpus = workload()
        run_chaos(ChaosSchedule(fail_steps=(2, 3), max_restarts=1,
                                max_batches=5, prefetch_workers=0,
                                prefetch_mode="thread"),
                  mesh=mesh, ckpt_dir=f"{root}/g", device="cpu", cfg=cfg,
                  corpus=corpus)


    def before_collective(mesh):
        """(h): rank 1 raises inside its second step, before the step's
        pmean, where rank 0 waits."""
        from repro_torch.kernels import ops
        cfg, corpus = workload()
        s = session(mesh, cfg, corpus)
        real = ops.step

        def step(tables, inputs, cfg, **kw):
            if mesh.rank == 1 and s.state.batches_seen == 1:
                raise RuntimeError("injected before the collective")
            return real(tables, inputs, cfg, **kw)

        ops.step = step
        s.train_resilient(max_batches=4, max_restarts=3, backoff_s=0.0)


    SHARDED = "shards={n},exchange=exact"

    if __name__ == "__main__":
        from repro_torch.launch.mesh import RankFailed, start_ranks
        mode, out = sys.argv[1], sys.argv[2]
        t0 = __import__("time").perf_counter()
        try:
            if mode == "two":
                res = start_ranks(two, 2, "cpu", sys.argv[3], sys.argv[4],
                                  timeout=300)
            elif mode == "four":
                res = start_ranks(four, 4, "cpu", sys.argv[3], timeout=300)
            elif mode == "budget":
                res = start_ranks(budget, 2, "cpu", sys.argv[3], timeout=120)
            else:
                res = start_ranks(before_collective, 2, "cpu",
                                  timeout=float(sys.argv[3]))
        except RankFailed as e:
            res = {"rank_failed": str(e)}
        res["seconds"] = __import__("time").perf_counter() - t0
        with open(out, "w") as f:
            json.dump(res, f, default=list)
''')


def _run_port(tmp, *args, timeout=400) -> dict:
    script = tmp / "port_ranks.py"
    script.write_text(PORT)
    out = tmp / f"{args[0]}.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), args[0], str(out),
                        *map(str, args[1:])], env=env, capture_output=True,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's 2-device chaos run, then the port's 2-rank cases
    (a, b, c, e, f) and its 4-rank case (d)."""
    tmp = tmp_path_factory.mktemp("mesh_chaos")
    ref = str(tmp / "ref.npz")
    r = run_subprocess(REF + f"\nmain({ref!r}, {str(tmp / 'ref_ckpt')!r})\n",
                       n_devices=2, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(ref + ".json") as f:
        ref_counts = json.load(f)
    two = _run_port(tmp, "two", ref, tmp)
    four = _run_port(tmp, "four", tmp)
    return dict(ref=dict(np.load(ref)), ref_counts=ref_counts, two=two,
                four=four, b_leaves=dict(np.load(tmp / "b.npz")))


CI_FAULTS = [["fail", 3], ["fail", 5], ["kill", 2], ["nan", 6],
             ["trunc", 4]]


def _equal_reports(r):
    assert r["reports_equal"] == 1, [p["restarts"] for p in r["per_rank"]]
    keys = ("restarts", "rollbacks", "health_failures", "batches_skipped",
            "ckpt_quarantined", "batches_trained", "votes")
    assert len({tuple(p[k] for k in keys) for p in r["per_rank"]}) == 1


def test_two_ranks_ci_schedule_recovers_bit_exact(mesh_runs):
    """(a) The faulted 2-rank run ends with the fault-free 2-rank run's
    gathered tables; rank 1 fired the rank-local faults, rank 0 the
    truncation; one vote a batch and each restore."""
    r = mesh_runs["two"]["a"]
    assert r["digest_match"] == 1 and r["ranks"] == 2
    assert r["faults_fired"] == r["faults_scheduled"] == 5
    assert sorted(map(list, r["fired"])) == sorted(CI_FAULTS)
    assert [sorted(map(tuple, p["fired"])) for p in r["per_rank"]] == [
        [("trunc", 4)], [("fail", 3), ("fail", 5), ("kill", 2), ("nan", 6)]]
    _equal_reports(r)
    assert (r["restarts"], r["rollbacks"], r["health_failures"]) == (3, 3, 1)
    assert r["ckpt_quarantined"] == 1 and r["workers_killed"] == 1
    assert r["poisoned"] == [[], ["w_in"]]
    assert r["votes"] >= r["batches_trained"] + r["rollbacks"]
    assert all(p["vote_seconds"] > 0 for p in r["per_rank"])


def test_two_ranks_match_the_reference_two_device_chaos_run(mesh_runs):
    """(b) The same schedule on the reference's 2-device session: the same
    faults fired and the same counts, and tables within the kernel
    tolerance. Two fault kinds cannot fire there as they do in the port.
    The NaN: the reference's probe of the NaN-written replicated table
    raises on the mesh (a step failure), so its ``health_failures`` is 0
    where the port's is 1. The worker kill: the reference's process
    workers fork the jax process, which can deadlock, so its session
    runs the synchronous pipeline and the kill finds no worker (the
    port's kill, absorbed by its pool's heal, changes no count). Every
    other count is held equal."""
    ref, port = mesh_runs["ref_counts"], mesh_runs["two"]["b"]
    assert sorted(map(list, ref["fired"])) == sorted(map(list, port["fired"]))
    assert port["counts"][0] == port["counts"][1]
    got = port["counts"][0]
    for k in ("restarts", "rollbacks", "timeouts", "batches_skipped",
              "ckpt_quarantined"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert (got["health_failures"], ref["health_failures"]) == (1, 0)
    assert port["quarantined"] == 1 and port["bitwise"]
    leaves = mesh_runs["b_leaves"]
    assert set(leaves) == {"w_in", "w_out"}
    for k, got_leaf in leaves.items():
        np.testing.assert_allclose(got_leaf, mesh_runs["ref"]["final|" + k],
                                   **TOL, err_msg=k)
        np.testing.assert_allclose(mesh_runs["ref"]["final|" + k],
                                   mesh_runs["ref"]["base|" + k], atol=0,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("case,n", [("c", 2), ("d", 4)])
def test_sharded_mesh_recovers_from_nan_in_a_rank_cold_block(mesh_runs,
                                                              case, n):
    """(c) 2 ranks and (d) 4 ranks, vocab-sharded exact T=4: a failed step
    and NaN in rank 1's own cold block, the fault-free digest."""
    r = mesh_runs["two"][case] if case == "c" else mesh_runs["four"]
    assert r["ranks"] == n and r["digest_match"] == 1
    assert r["faults_fired"] == r["faults_scheduled"] == 2
    _equal_reports(r)
    assert (r["restarts"], r["health_failures"]) == (2, 1)
    assert r["poisoned"] == [[]] + [["cold_in"]] + [[]] * (n - 2)


def test_poison_skip_under_two_ranks_equals_never_training_the_batch(
        mesh_runs):
    """(e) The excised batch's key is the same on both ranks, and a run
    that skips it from the start ends with the same gathered tables."""
    r = mesh_runs["two"]["e"]
    assert r["keys"][0] == r["keys"][1] == [[0, 4]]   # batch 5 of 5
    assert r["counts"][0] == r["counts"][1]
    assert r["counts"][0]["health_failures"] == 1
    assert r["counts"][0]["batches_skipped"] == 1
    assert r["skipped"] == 1 and r["equal"] and r["batches_seen"] == 10


def test_checkpoint_unhealthy_on_one_rank_is_quarantined_once(mesh_runs):
    """(f) Checkpoint 4 fails the post-restore probe on rank 1 alone: rank
    0 alone quarantines it, both ranks count it, both fall back."""
    r = mesh_runs["two"]["f"]
    assert r["calls"] == [[4], []]
    assert r["dirs"] == ["step_00000004.corrupt"]
    assert r["counts"][0] == r["counts"][1]
    assert r["counts"][0]["ckpt_quarantined"] == 1
    assert r["equal"]


def test_exhausted_budget_ends_every_rank_naming_rank_1(tmp_path):
    """(g) Rank 1's second failure is past a budget of one: every rank
    raises (rank 1 its own failure, rank 0 a peer error naming it) and
    the launcher ends the job."""
    r = _run_port(tmp_path, "budget", tmp_path)
    msg = r["rank_failed"]
    own = "RuntimeError: chaos: injected failure at batch 3"
    peer = ("PeerError: rank 1 failed: RuntimeError('chaos: injected "
            "failure at batch 3')")
    assert (msg.startswith("rank 1 failed") and own in msg) or (
        msg.startswith("rank 0 failed") and peer in msg), msg[-1000:]
    assert r["seconds"] < 120


def test_fault_before_a_step_collective_ends_within_the_timeout(tmp_path):
    """(h) Rank 1 raises before its step's collective while rank 0 waits
    in it: rank 1's vote times out after half the group's timeout and the
    job ends with ``RankFailed`` naming rank 1, never hanging."""
    r = _run_port(tmp_path, "before", 40, timeout=200)
    msg = r["rank_failed"]
    assert msg.startswith("rank 1 failed"), msg[:500]
    assert "MeshDesync" in msg and "injected before the collective" in msg
    assert r["seconds"] < 40


def _cli(*flags):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "w2v",
         "--device", "cpu", "--vocab", "128", "--clusters", "8",
         "--sentences", "80", "--sentences-per-batch", "16", "--epochs", "1",
         "--max-batches", "4", "--tile-windows", "4", *flags], env=env,
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_cli_resilience_flags_on_two_ranks_keep_the_digest(tmp_path):
    """(i) ``--vocab-shard 2`` with ``--max-restarts 3 --health-every 1``
    and checkpoints trains under the supervisor on both ranks; rank 0
    prints the resilience line once and the plain run's digest."""
    plain = _cli("--vocab-shard", "2")
    sup = _cli("--vocab-shard", "2", "--max-restarts", "3",
               "--health-every", "1", "--ckpt-dir", str(tmp_path / "ck"),
               "--ckpt-every", "2")
    digests = [[ln for ln in out.splitlines()
                if ln.startswith("final_digest=")] for out in (plain, sup)]
    assert len(digests[0]) == 1 and digests[0] == digests[1]
    lines = [ln for ln in sup.splitlines() if ln.startswith("resilience:")]
    assert lines == ["resilience: restarts=0 rollbacks=0 health_failures=0 "
                     "timeouts=0 skipped=0 recovery_seconds=0.000"]


def test_cli_prints_the_reference_tables_line():
    """The port's CLI prints the reference CLI's ``tables:`` line for a
    mixed-storage run."""
    flags = ["--vocab", "128", "--clusters", "8", "--sentences", "80",
             "--sentences-per-batch", "16", "--epochs", "1",
             "--max-batches", "1", "--tables", "hot=bf16,cold=int8,shards=1"]
    r = run_subprocess(
        "import sys\nfrom repro.launch.train import main\n"
        f"sys.argv = ['train', 'w2v', *{flags!r}]\nsys.exit(main())\n",
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    want = [ln for ln in r.stdout.splitlines() if ln.startswith("tables:")]
    got = [ln for ln in _cli(*flags[:-4], "--max-batches", "1",
                             "--tables", flags[-1]).splitlines()
           if ln.startswith("tables:")]
    assert want == ["tables: hot=bfloat16 cold=int8 master_copy=False"]
    assert got == want


@pytest.mark.parametrize("ranks", [1, 2])
def test_chaos_tool_exits_zero_on_bit_exact_recovery(ranks):
    """(j) ``tools/torch_chaos.py --device cpu`` at 1 and 2 ranks."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "torch_chaos.py"),
         "--device", "cpu", "--ranks", str(ranks), "-q"], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    lines = r.stdout.splitlines()
    base = next(ln for ln in lines if ln.startswith("baseline_digest="))
    final = next(ln for ln in lines if ln.startswith("final_digest="))
    assert base.split("=")[1] == final.split("=")[1]
    assert lines[-1].startswith("chaos: recovery is bit-exact")
    assert (f"ranks={ranks} reports_equal=1" in r.stdout) == (ranks > 1)


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_chaos_tool", os.path.join(ROOT, "tools", "torch_chaos.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chaos_tool_exits_one_when_the_digests_differ(monkeypatch, capsys):
    """(j) The exit status is the contract: a result whose digests differ
    (every fault fired) exits 1 and says why."""
    from repro_torch.train import chaos
    result = dict(baseline_digest="a", final_digest="b", digest_match=0,
                  batches_seen=10, restarts=3, rollbacks=3, heals=0,
                  ckpt_quarantined=1, recovery_seconds=0.0, faults_fired=5,
                  faults_scheduled=5, workers_killed=1, ckpts_truncated=1,
                  reports_equal=1)
    monkeypatch.setattr(chaos, "run_chaos", lambda *a, **k: result)
    assert _tool().main(["--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "final_digest differs from fault-free baseline" in err
    monkeypatch.setattr(chaos, "run_chaos",
                        lambda *a, **k: {**result, "digest_match": 1,
                                         "final_digest": "a"})
    assert _tool().main(["--device", "cpu"]) == 0


# ----------------------------------------------- the vote, in one process
class _Voting(TrainSupervisor):
    """A supervisor whose vote sees preset rows (no group)."""

    def __init__(self, rows, rank=0):
        state = type("S", (), dict(batches_seen=4, epoch=0,
                                   epoch_batch=4))()
        mesh = DataMesh(rank=rank, size=len(rows), device="cpu")
        super().__init__(type("Sess", (), dict(state=state, mesh=mesh))())
        self.rows = rows

    def _gather(self, row, own=None):
        return [row if i == self._mesh.rank else r
                for i, r in enumerate(self.rows)]


@pytest.fixture
def whats(monkeypatch):
    """``all_gather_object`` without a group: the failing ranks' reprs."""
    import torch.distributed as dist

    def gather(out, obj, group=None):
        out[:] = [f"<failure of rank {i}>" for i in range(len(out))]

    monkeypatch.setattr(dist, "all_gather_object", gather)


@pytest.mark.parametrize("status,kind", [(1, PeerError),
                                         (2, StepTimeout),
                                         (3, HealthError)])
def test_a_peer_failure_raises_its_kind_naming_the_rank(whats, status, kind):
    rows = [[4, 0, 4, 0, 0], [4, 0, 4, 0, status]]
    with pytest.raises(kind, match="rank 1 failed: <failure of rank 1>") as e:
        _Voting(rows)._vote(None)
    assert isinstance(e.value, PeerError) and e.value.rank == 1


def test_the_lowest_failing_rank_decides_the_kind(whats):
    """Rank 1's health failure beside rank 2's step failure: rank 2 raises
    a peer health error, not its own step failure, so recovery takes one
    path everywhere; rank 1 raises its own exception."""
    rows = [[4, 0, 4, 0, 0], [4, 0, 4, 0, 3], [4, 0, 4, 0, 1]]
    own = RuntimeError("rank 2's own")
    with pytest.raises(PeerHealthError) as e:
        _Voting(rows, rank=2)._vote(own)
    assert e.value.__cause__ is own
    mine = HealthError("rank 1's own")
    with pytest.raises(HealthError) as e:
        _Voting(rows, rank=1)._vote(mine)
    assert e.value is mine
    assert _Voting([[4, 0, 4, 0, 0]] * 2)._vote(None) is None


def test_positions_that_differ_raise_naming_the_ranks():
    rows = [[4, 0, 4, 0, 0], [3, 0, 3, 0, 1]]
    with pytest.raises(MeshDesync, match=r"rank 0 \[4, 0, 4, 0\], rank 1 "
                                         r"\[3, 0, 3, 0\]"):
        _Voting(rows)._vote(None)
    # a desync is never recovered from
    with pytest.raises(MeshDesync):
        _Voting(rows)._recover(0, MeshDesync("x"))


def _state(sharded: bool, cold_dtype=torch.float32):
    from repro_torch.core.trainer import TrainState
    w = torch.zeros(4, 3)
    if not sharded:
        return TrainState(w_in=w, w_out=w.clone())
    return TrainState(w_in=w, w_out=w.clone(),
                      cold_in=torch.zeros(2, 3, dtype=cold_dtype),
                      cold_out=torch.zeros(2, 3, dtype=cold_dtype),
                      scale_in=torch.ones(2), scale_out=torch.ones(2))


@pytest.mark.parametrize("sharded,size,cold,want", [
    (False, 1, torch.float32, "w_in"), (False, 2, torch.float32, "w_in"),
    (True, 1, torch.float32, "w_in"), (True, 2, torch.float32, "cold_in"),
    (True, 2, torch.bfloat16, "cold_in"), (True, 2, torch.int8, "scale_in")])
def test_nan_lands_in_the_firing_rank_own_table(tmp_path, sharded, size,
                                                cold, want):
    rank = 1 if size > 1 else 0
    mesh = None if size == 1 else DataMesh(rank=rank, size=size,
                                           device="cpu")
    state = _state(sharded, cold)
    state.batches_seen = 6
    ChaosMonkey(ChaosSchedule(nan_at=(6,)), str(tmp_path), mesh).on_batch(
        state)
    nan = sorted(k for k, v in state.params().items()
                 if v.is_floating_point() and v.isnan().any())
    assert nan == [{"w_in": "hot_in" if sharded else "w_in"}.get(want, want)]


def test_rank_local_faults_fire_on_the_fault_rank_only(tmp_path):
    sched = ChaosSchedule(fail_steps=(2,), truncate_ckpt_at=(3,))
    state = _state(False)
    state.batches_seen = 2
    for rank, raises in ((0, False), (1, True)):
        monkey = ChaosMonkey(sched, str(tmp_path),
                             DataMesh(rank=rank, size=2, device="cpu"))
        if raises:
            with pytest.raises(RuntimeError, match="injected failure"):
                monkey.on_batch(state)
        else:
            monkey.on_batch(state)
        assert monkey.writes == (rank == 0)
    with pytest.raises(ValueError, match="fault_rank 2 outside a mesh of 2"):
        ChaosMonkey(ChaosSchedule(fault_rank=2), str(tmp_path),
                    DataMesh(rank=0, size=2, device="cpu"))
