"""Supervised recovery in the port (``repro_torch.train.supervisor``,
``resilience``, ``chaos``): mirrors of the recovery cases of
``tests/test_resilience_recovery.py`` on the port's CPU sessions —
injected step failures, a NaN'd table, a poisoned checkpoint, poison-batch
excision, re-init without a checkpoint — plus the retry budget, the
watchdog (waited on an event, not a sleep), the straggler monitor, and
chaos schedules with ``digest_match == 1``.

The recovery cases start from the reference's initial tables
(``params_from_reference``) and end held two ways: bit-identical to the
port's own fault-free run (the kernels keep strict sentence order), and
within the kernel tolerance of the reference session's (``backend="jnp"``)
fault-free run — or, for poison excision, of the reference's own
``poison_skip`` run of the same batch."""
import dataclasses
import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.configs.w2v import smoke as ref_smoke
from repro.core.trainer import TrainSession as RefSession
from repro.data.batching import BatchingPipeline as RefPipeline
from repro_torch.configs.w2v import smoke
from repro_torch.convert import params_from_reference
from repro_torch.core.trainer import TrainSession
from repro_torch.data.batching import BatchingPipeline
from repro_torch.data.corpus import synthetic_cluster_corpus
from repro_torch.train.chaos import SCHEDULES, run_chaos, table_digest
from repro_torch.train.resilience import (FailureInjector, RetryPolicy,
                                          StepTimeout, StragglerMonitor,
                                          Watchdog, run_with_recovery)
from repro_torch.train.supervisor import (HealthError, TrainSupervisor,
                                          table_max_abs)

WAIT_S = 30.0
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus():
    return synthetic_cluster_corpus(n_clusters=4, words_per_cluster=8,
                                    n_sentences=300, mean_len=10, seed=0)


# the reference's recovery workload (2 epochs of 5 batches) at a shorter
# padded length, which only shortens the plain version's loop
CFG_KW = dict(epochs=2, dim=32, sentences_per_batch=64, max_sentence_len=24)


def _cfg():
    return smoke(**CFG_KW)


def _ref_session():
    rcfg = ref_smoke(**CFG_KW)
    return RefSession(RefPipeline(_corpus(), rcfg), rcfg, backend="jnp")


def _params(state):
    return {k: np.asarray(v) for k, v in state.params().items()}


@pytest.fixture(scope="module")
def workload():
    """The workload on both packages: the reference's initial tables, its
    fault-free final tables, and the port's fault-free digests from those
    initial tables and from the port's own seed (for the re-init case)."""
    cfg, corpus = _cfg(), _corpus()
    vocab = BatchingPipeline(corpus, cfg).vocab
    ref = _ref_session()
    init = _params(ref.state)
    ref.train()
    assert ref.state.batches_seen == 10
    base = TrainSession(BatchingPipeline(corpus, cfg, vocab=vocab), cfg,
                        device="cpu")
    base.state = params_from_reference(init, "cpu")
    base.train()
    assert base.state.batches_seen == 10
    seeded = TrainSession(BatchingPipeline(corpus, cfg, vocab=vocab), cfg,
                          device="cpu")
    seeded.train()
    return SimpleNamespace(cfg=cfg, corpus=corpus, vocab=vocab, init=init,
                           ref_final=_params(ref.state),
                           port_final=_params(base.state),
                           digest=table_digest(base.state),
                           seed_digest=table_digest(seeded.state),
                           n=base.state.batches_seen)


def _session(workload, tmp_path, from_reference=True, **kw):
    """A port session on the workload with checkpoints every 2 batches,
    starting from the reference's initial tables unless told not to."""
    w = workload
    kw.setdefault("ckpt_every", 2)
    sess = TrainSession(BatchingPipeline(w.corpus, w.cfg, vocab=w.vocab),
                        w.cfg, device="cpu", ckpt_dir=str(tmp_path / "ckpt"),
                        **kw)
    if from_reference:
        sess.state = params_from_reference(w.init, "cpu")
    return sess


def _near(state, want):
    got = _params(state)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)


def test_fault_free_port_run_matches_reference(workload):
    """The baseline the recovery cases are held to: from the same tables
    the port's fault-free run ends within the kernel tolerance of the
    reference's."""
    got, want = workload.port_final, workload.ref_final
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
        assert np.abs(got[k] - workload.init[k]).max() > 1e-4   # it trained


# ------------------------------------------------------- supervised recovery
def test_injected_failures_recover_bit_exact(workload, tmp_path):
    """Step exceptions mid-epoch AND across the epoch boundary: restore +
    keyed-randomness replay reproduces the fault-free run bit for bit."""
    inj = FailureInjector([3, 7])
    sess = _session(workload, tmp_path,
                    on_metrics=lambda m: inj.check(m.batches_seen))
    sess.train_resilient(backoff_s=0.0)
    assert sess.state.batches_seen == workload.n
    assert table_digest(sess.state) == workload.digest
    _near(sess.state, workload.ref_final)
    r = sess.last_report
    assert r.restarts == 2 and r.rollbacks == 2
    assert r.recovery_seconds > 0


def test_nan_health_rollback_bit_exact(workload, tmp_path):
    fired = []

    def poison(state):
        if state.batches_seen == 5 and not fired:
            fired.append(True)
            state.w_in[0, 0] = float("nan")

    sess = _session(workload, tmp_path, on_batch=poison)
    sess.train_resilient(health_every=1, backoff_s=0.0)
    assert table_digest(sess.state) == workload.digest
    _near(sess.state, workload.ref_final)
    r = sess.last_report
    assert r.health_failures == 1 and r.rollbacks >= 1
    assert r.probes >= sess.state.batches_seen and r.probe_seconds > 0


def test_poisoned_checkpoint_is_quarantined(workload, tmp_path):
    """A checkpoint written after corruption landed (coarse health probe)
    fails the post-restore probe: quarantined, the older clean one
    restored, and the run still ends bit-exact."""
    fired = []

    def poison(state):
        if state.batches_seen == 3 and not fired:
            fired.append(True)
            state.w_in[0, 0] = float("nan")

    sess = _session(workload, tmp_path, on_batch=poison)
    sess.train_resilient(health_every=2, backoff_s=0.0)
    assert table_digest(sess.state) == workload.digest
    _near(sess.state, workload.ref_final)
    assert sess.last_report.ckpt_quarantined >= 1
    assert any(".corrupt" in n for n in os.listdir(tmp_path / "ckpt"))


def test_poison_skip_equals_never_training_that_batch(workload, tmp_path):
    """The excised batch's key skips the same batch in a port session and
    in a reference session: the port's skip run equals its own ``poison_skip``
    replay bit for bit and the reference's within the kernel tolerance,
    with the same counters."""
    w = workload
    sess = _session(workload, tmp_path)

    def poison(m):
        if m.batches_seen == 5 and not m.skipped:
            sess.state.w_in[0, 0] = float("nan")

    sess.on_metrics = poison
    sess.train_resilient(health_every=1, skip_poison=True, backoff_s=0.0)
    r = sess.last_report
    assert r.health_failures == 1 and r.batches_skipped == 1
    assert sess.state.batches_seen == w.n
    assert table_digest(sess.state) != w.digest
    skipped_key = next(iter(sess.poison_skip))
    replay = TrainSession(BatchingPipeline(w.corpus, w.cfg, vocab=w.vocab),
                          w.cfg, device="cpu")
    replay.state = params_from_reference(w.init, "cpu")
    replay.poison_skip.add(skipped_key)
    replay.train()
    assert replay.batches_skipped == 1
    assert table_digest(sess.state) == table_digest(replay.state)
    ref = _ref_session()
    ref.poison_skip.add(skipped_key)
    ref.train()
    assert ref.batches_skipped == 1
    assert (sess.state.batches_seen, sess.state.words_seen) == (
        ref.state.batches_seen, ref.state.words_seen)
    assert sess.current_lr() == ref.current_lr()
    _near(sess.state, _params(ref.state))


def test_supervisor_report_equals_the_reference(workload, tmp_path):
    """One fault schedule (step failures raised after batches 3 and 7
    trained, the newest checkpoint truncated after batch 4, NaN in
    ``w_in`` after batch 6) through the reference's ``TrainSupervisor``
    and the port's on one rank, from the same tables and batches: the
    two reports are equal field by field on the reference's fields, with
    ``batches`` counting the metrics consumed, replays included, in both.
    ``recovery_seconds`` is a wall time: positive on both, not compared.
    The port's ``batches_trained`` also counts the two batches whose step
    raised after its update."""
    from repro.train import chaos as ref_chaos
    from repro_torch.train.chaos import ChaosMonkey, ChaosSchedule

    faults = dict(fail_steps=(3, 7), truncate_ckpt_at=(4,), nan_at=(6,),
                  prefetch_workers=0, prefetch_mode="thread")
    kw = dict(max_restarts=4, health_every=1, backoff_s=0.0)
    rcfg = ref_smoke(**CFG_KW)
    ref_dir = str(tmp_path / "ref")
    ref_monkey = ref_chaos.ChaosMonkey(ref_chaos.ChaosSchedule(**faults),
                                       ref_dir)
    ref = RefSession(RefPipeline(_corpus(), rcfg), rcfg, backend="jnp",
                     ckpt_dir=ref_dir, ckpt_every=2,
                     on_batch=ref_monkey.on_batch)
    ref.train_resilient(**kw)
    monkey = ChaosMonkey(ChaosSchedule(**faults), str(tmp_path / "ckpt"))
    sess = _session(workload, tmp_path, on_batch=monkey.on_batch)
    sess.train_resilient(**kw)
    assert len(monkey.fired) == len(ref_monkey.fired) == 4
    want, got = ref.last_report, sess.last_report
    names = [f.name for f in dataclasses.fields(want)]
    assert "batches" in names and "recovery_seconds" in names
    for name in names:
        if name == "recovery_seconds":
            assert getattr(got, name) > 0 and getattr(want, name) > 0
        else:
            assert getattr(got, name) == getattr(want, name), name
    assert (got.restarts, got.health_failures) == (3, 1)
    assert got.batches_trained == got.batches + 2
    assert sess.state.batches_seen == ref.state.batches_seen == workload.n
    assert table_digest(sess.state) == workload.digest
    _near(sess.state, workload.ref_final)


def test_skip_poison_requires_unit_health_probe(workload, tmp_path):
    sess = _session(workload, tmp_path)
    with pytest.raises(ValueError, match="health_every=1"):
        sess.train_resilient(skip_poison=True, health_every=2)


def test_restore_latest_reinit_without_checkpoint(workload, tmp_path):
    """With no usable checkpoint the rollback restarts from the seed, on
    the session's device, with new tables — and the replay is bit-exact
    with the port's own run from its seed."""
    sess = _session(workload, tmp_path, from_reference=False, ckpt_every=0)
    sess.train(max_batches=4)
    old = sess.state.w_in
    assert sess.restore_latest() is None
    assert sess.state.batches_seen == 0
    assert sess.state.w_in is not old and sess.state.w_in.device.type == "cpu"
    sess.train()
    assert table_digest(sess.state) == workload.seed_digest


def test_restart_budget_exhausted_raises(workload, tmp_path):
    inj = FailureInjector([1, 2, 3])
    sess = _session(workload, tmp_path,
                    on_metrics=lambda m: inj.check(m.batches_seen))
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        sess.train_resilient(max_restarts=2, backoff_s=0.0)
    # two recoveries, then the third failure is past the budget and
    # propagates without one; the report still lands on the session
    assert sess.last_report.restarts == 2


def test_health_probe_reads_every_table():
    good = {"a": torch.ones(3, 2), "b": -2 * torch.ones(4, 2)}
    assert table_max_abs(good) == {"a": 1.0, "b": 2.0}
    bad = {**good, "b": torch.tensor([[float("inf")]])}
    assert table_max_abs(bad)["b"] == float("inf")

    sess = SimpleNamespace(state=SimpleNamespace(params=lambda: bad))
    with pytest.raises(HealthError, match="non-finite values in table 'b'"):
        TrainSupervisor(sess)._probe()
    huge = SimpleNamespace(state=SimpleNamespace(
        params=lambda: {"a": torch.full((2,), 1e5)}))
    with pytest.raises(HealthError, match="divergence in table 'a'"):
        TrainSupervisor(huge)._probe()


# --------------------------------------------------- resilience primitives
def test_retry_budget_refills_after_sustained_progress():
    inj = FailureInjector([1, 5, 9, 13])

    def step(i):
        inj.check(i)

    final = run_with_recovery(
        step, start_step=0, end_step=16, on_failure=lambda s, e: s,
        policy=RetryPolicy(max_restarts=2, backoff_s=0.0, reset_after=3))
    assert final == 16

    inj2 = FailureInjector([1, 5, 9, 13])
    with pytest.raises(RuntimeError, match="injected failure"):
        run_with_recovery(
            lambda i: inj2.check(i), start_step=0, end_step=16,
            on_failure=lambda s, e: s,
            policy=RetryPolicy(max_restarts=2, backoff_s=0.0))


def test_run_with_recovery_should_stop_mode():
    seen = []
    final = run_with_recovery(
        seen.append, start_step=0, on_failure=lambda s, e: s,
        should_stop=lambda: len(seen) >= 5)
    assert final == 5 and seen == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError, match="end_step or should_stop"):
        run_with_recovery(lambda i: None, start_step=0,
                          on_failure=lambda s, e: s)


def test_watchdog_timeout_not_swallowed_by_step_exception():
    """A step that both overruns the watchdog AND raises surfaces the
    timeout chained from the step's exception. The step waits for the
    watchdog's own callback, so the overrun is certain, not timed."""
    fired = threading.Event()
    with pytest.raises(StepTimeout) as ei:
        with Watchdog(0.01, on_timeout=fired.set):
            assert fired.wait(WAIT_S)
            raise ValueError("step also failed")
    assert isinstance(ei.value.__cause__, ValueError)

    fired = threading.Event()
    with pytest.raises(KeyboardInterrupt):
        with Watchdog(0.01, on_timeout=fired.set):
            assert fired.wait(WAIT_S)
            raise KeyboardInterrupt()

    fired = threading.Event()
    with pytest.raises(StepTimeout, match="exceeded"):
        with Watchdog(0.01, on_timeout=fired.set):
            assert fired.wait(WAIT_S)

    with Watchdog(WAIT_S) as wd:        # a step inside its bound
        pass
    assert not wd.fired


def test_straggler_ema_seeds_then_decays():
    m = StragglerMonitor(decay=0.9)
    m.report("h", 2.0)
    assert m.times["h"] == 2.0
    m.report("h", 1.0)
    assert m.times["h"] == pytest.approx(0.9 * 2.0 + 0.1 * 1.0)


def test_straggler_window_evicts_departed_hosts():
    m = StragglerMonitor(decay=0.5, threshold=1.4, window=6)
    m.report("gone", 9.0)
    for _ in range(4):
        for h in ("h0", "h1", "h2"):
            m.report(h, 1.0)
    assert "gone" not in m.times
    assert m.stragglers() == []
    m.report("slow", 5.0)
    assert m.stragglers() == ["slow"]


# ------------------------------------------------------------ chaos engine
def test_chaos_smoke_schedule_bit_exact():
    r = run_chaos(SCHEDULES["smoke"], device="cpu", cfg=_cfg(),
                  corpus=_corpus())
    assert r["digest_match"] == 1
    assert r["restarts"] == 1
    assert r["faults_fired"] == r["faults_scheduled"] == 1
    assert r["backend"] == "torch" and r["device"] == "cpu"


def test_chaos_thread_schedule_with_every_in_process_fault():
    """The ``heal`` schedule's failures, truncated checkpoint and NaN on
    thread workers (no process to kill): bit-exact, the truncated
    checkpoint quarantined, every scheduled fault but the kill fired."""
    sched = dataclasses.replace(SCHEDULES["heal"], kill_worker_at=(),
                                prefetch_mode="thread")
    r = run_chaos(sched, device="cpu", cfg=_cfg(), corpus=_corpus())
    assert r["digest_match"] == 1
    assert r["faults_fired"] == r["faults_scheduled"] == 4
    assert r["ckpt_quarantined"] >= 1 and r["health_failures"] == 1
    assert r["ckpts_truncated"] == 1


def test_chaos_heal_schedule_with_process_workers(subproc):
    """The full ``heal`` schedule (a killed process worker among the
    faults) in a subprocess: bit-exact, every fault fired, the pool healed
    and the truncated checkpoint quarantined."""
    r = subproc("""
        import json, torch
        torch.set_num_threads(1)
        from repro_torch.configs.w2v import smoke
        from repro_torch.data.corpus import synthetic_cluster_corpus
        from repro_torch.train.chaos import SCHEDULES, run_chaos
        cfg = smoke(epochs=2, dim=32, sentences_per_batch=64,
                    max_sentence_len=24)
        corpus = synthetic_cluster_corpus(n_clusters=4, words_per_cluster=8,
                                          n_sentences=300, mean_len=10,
                                          seed=0)
        r = run_chaos(SCHEDULES["heal"], device="cpu", cfg=cfg,
                      corpus=corpus)
        print("RESULT", json.dumps(r))
    """, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    res = json.loads(r.stdout.split("RESULT", 1)[1])
    assert res["digest_match"] == 1, res
    assert res["faults_fired"] == res["faults_scheduled"] == 5, res
    assert res["workers_killed"] == 1 and res["heals"] >= 1, res
    assert res["ckpt_quarantined"] >= 1, res
