"""Deterministic chaos schedules: scripted faults against a supervised run.

The port's counterpart of ``repro.train.chaos``. A :class:`ChaosSchedule`
names *which fault fires at which global batch* (``state.batches_seen`` —
deterministic, so the same schedule replays the same faults).
:func:`run_chaos` executes it end to end: train a fault-free baseline,
then the same workload under :class:`TrainSupervisor` with the faults
injected, and compare final table digests. Because batching randomness is
keyed, recovery replays from exact pipeline cursors (DESIGN.md §9) and the
kernels keep the reference's strict sentence order, the supervised run
must end **bit-identical** to the baseline — the pass/fail is digest
equality, not "it didn't crash".

Fault kinds (all fire from the ``on_batch`` callback, i.e. *after* the
batch trained and any due checkpoint was published — so a checkpoint is
never poisoned by the fault scheduled at its own step):

  * ``fail_steps``        — raise out of the step
  * ``kill_worker_at``    — SIGKILL a live process-pool prefetch worker
  * ``truncate_ckpt_at``  — truncate the newest checkpoint's arrays.npz
  * ``nan_at``            — write NaN into a cell of ``w_in`` (in place)

Each fault fires exactly once (replays after a rollback do not re-fire),
which keeps the schedule a fixed fault *set* rather than a rate.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import logging
import os
import shutil
import signal
import tempfile
import time
from typing import Dict, Optional, Tuple

log = logging.getLogger("repro_torch.chaos")


def table_digest(state) -> str:
    """sha1 over every table of the state (``params()`` order: ``w_in``,
    ``w_out`` for a replicated session — the reference's digest — and the
    hot and cold tables of a vocab-sharded one), fetched to the host."""
    import torch

    h = hashlib.sha1()
    for t in state.params().values():
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class ChaosSchedule:
    """A deterministic fault script plus the tiny workload it runs on."""
    fail_steps: Tuple[int, ...] = ()
    kill_worker_at: Tuple[int, ...] = ()
    truncate_ckpt_at: Tuple[int, ...] = ()
    nan_at: Tuple[int, ...] = ()
    max_batches: int = 10
    epochs: int = 2
    ckpt_every: int = 2
    max_restarts: int = 4
    health_every: int = 1
    prefetch_workers: int = 2
    prefetch_mode: str = "process"   # worker kills need real processes

    @property
    def n_faults(self) -> int:
        return (len(self.fail_steps) + len(self.kill_worker_at)
                + len(self.truncate_ckpt_at) + len(self.nan_at))


# The ``ci`` schedule is the reference's acceptance bar: >=1 injected step
# exception, >=1 killed prefetch worker, >=1 truncated checkpoint (plus a
# NaN), all inside a 10-batch run that crosses an epoch boundary (5
# batches/epoch). Its kill at batch 2 is followed by a failure at batch 3,
# whose rollback may rebuild the pipeline before the pool notices the dead
# worker, so ``heals`` is 0 or 1. ``heal`` has the same fault kinds spaced
# so that the stream outlives the kill by ``prefetch_depth + 1`` batches:
# a batch submitted after the kill must come back through the pool's own
# heal path, and then the truncated checkpoint 6 is met by the rollback
# from batch 7 (quarantined; the replay crosses the epoch boundary back to
# checkpoint 4), and the NaN after checkpoint 8 by the health probe.
SCHEDULES: Dict[str, ChaosSchedule] = {
    "ci": ChaosSchedule(fail_steps=(3, 5), kill_worker_at=(2,),
                        truncate_ckpt_at=(4,), nan_at=(6,)),
    "heal": ChaosSchedule(fail_steps=(5, 7), kill_worker_at=(2,),
                          truncate_ckpt_at=(6,), nan_at=(8,)),
    "smoke": ChaosSchedule(fail_steps=(3,), max_batches=6,
                           prefetch_workers=0, prefetch_mode="thread"),
    "none": ChaosSchedule(),
}


class ChaosMonkey:
    """Fires a :class:`ChaosSchedule` from a session's ``on_batch`` hook."""

    def __init__(self, schedule: ChaosSchedule, ckpt_dir: str):
        self.schedule = schedule
        self.ckpt_dir = ckpt_dir
        self.pipeline = None          # bound after session construction
        self.fired: set = set()
        self.workers_killed = 0
        self.ckpts_truncated = 0

    def bind(self, pipeline) -> None:
        self.pipeline = pipeline

    def _once(self, kind: str, n: int) -> bool:
        if (kind, n) in self.fired:
            return False
        self.fired.add((kind, n))
        return True

    def on_batch(self, state) -> None:
        n = state.batches_seen
        if n in self.schedule.nan_at and self._once("nan", n):
            log.warning("chaos: injecting NaN into w_in at batch %d", n)
            state.w_in[0, 0] = float("nan")
        if n in self.schedule.truncate_ckpt_at and self._once("trunc", n):
            self._truncate_newest(n)
        if n in self.schedule.kill_worker_at and self._once("kill", n):
            self._kill_worker(n)
        if n in self.schedule.fail_steps and self._once("fail", n):
            raise RuntimeError(f"chaos: injected failure at batch {n}")

    def _truncate_newest(self, n: int) -> None:
        from repro_torch.train import checkpoint as ckpt
        steps = ckpt.list_steps(self.ckpt_dir)
        if not steps:
            log.warning("chaos: no checkpoint to truncate at batch %d", n)
            return
        path = os.path.join(self.ckpt_dir, f"step_{steps[-1]:08d}",
                            "arrays.npz")
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(size // 2, 1))
        self.ckpts_truncated += 1
        log.warning("chaos: truncated %s (%d -> %d bytes) at batch %d",
                    path, size, max(size // 2, 1), n)

    def _kill_worker(self, n: int) -> None:
        pids = (self.pipeline.worker_pids()
                if self.pipeline is not None
                and hasattr(self.pipeline, "worker_pids") else [])
        if not pids:
            log.warning("chaos: no process-pool worker to kill at batch %d "
                        "(thread mode?)", n)
            return
        os.kill(pids[0], signal.SIGKILL)
        # wait until the pool sees the worker gone, so that the stream's
        # next submit meets the dead worker (and heals) deterministically
        deadline = time.monotonic() + 30.0
        while pids[0] in self.pipeline.worker_pids():
            if time.monotonic() > deadline:
                raise RuntimeError(f"chaos: worker pid {pids[0]} still "
                                   f"alive 30 s after SIGKILL")
            time.sleep(0.001)
        self.workers_killed += 1
        log.warning("chaos: SIGKILLed prefetch worker pid %d at batch %d",
                    pids[0], n)


def _make_workload(schedule: ChaosSchedule):
    from repro_torch.configs.w2v import smoke
    from repro_torch.data.corpus import synthetic_cluster_corpus

    # 300 sentences / 64 per batch -> 5 batches/epoch: a 10-batch schedule
    # crosses the epoch boundary, so mid-epoch AND cross-epoch rollbacks
    # are both exercised
    cfg = smoke(epochs=schedule.epochs, dim=32, sentences_per_batch=64)
    corpus = synthetic_cluster_corpus(n_clusters=4, words_per_cluster=8,
                                      n_sentences=300, mean_len=10, seed=0)
    return cfg, corpus


def run_chaos(schedule: ChaosSchedule, *,
              ckpt_dir: Optional[str] = None,
              backend: str = "auto", device=None,
              cfg=None, corpus=None) -> Dict:
    """Run ``schedule`` end to end; returns the result/metrics dict.

    ``backend`` and ``device`` go to both sessions (``device=None`` is the
    GPU, as for every session of the port). ``cfg`` and ``corpus`` replace
    the schedule's tiny workload (the schedule's ``epochs`` and
    ``prefetch_*`` still apply). ``digest_match`` is the headline: the
    supervised faulted run's final tables are bit-identical to the
    fault-free baseline's.
    """
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.prefetch import AsyncBatchingPipeline

    if cfg is None or corpus is None:
        cfg, corpus = _make_workload(schedule)
    cfg = dataclasses.replace(cfg, epochs=schedule.epochs,
                              prefetch_workers=schedule.prefetch_workers,
                              prefetch_mode=schedule.prefetch_mode)
    vocab = BatchingPipeline(corpus, cfg).vocab

    # fault-free baseline (sync pipeline: prefetch is bit-identical to it)
    base = TrainSession(BatchingPipeline(corpus, cfg, vocab=vocab), cfg,
                        backend=backend, device=device)
    base.train(max_batches=schedule.max_batches)
    baseline_digest = table_digest(base.state)
    del base

    owns_dir = ckpt_dir is None
    tmp = tempfile.mkdtemp(prefix="chaos_ckpt_") if owns_dir else ckpt_dir
    try:
        if schedule.prefetch_workers > 0:
            pipe = AsyncBatchingPipeline(corpus, cfg, vocab=vocab,
                                         workers=schedule.prefetch_workers,
                                         mode=schedule.prefetch_mode)
        else:
            pipe = BatchingPipeline(corpus, cfg, vocab=vocab)
        monkey = ChaosMonkey(schedule, tmp)
        sess = TrainSession(pipe, cfg, backend=backend, device=device,
                            ckpt_dir=tmp, ckpt_every=schedule.ckpt_every,
                            on_batch=monkey.on_batch)
        monkey.bind(pipe)
        t0 = time.perf_counter()
        sess.train_resilient(max_batches=schedule.max_batches,
                             max_restarts=schedule.max_restarts,
                             health_every=schedule.health_every,
                             backoff_s=0.01)
        wall = time.perf_counter() - t0
        report = sess.last_report
        final_digest = table_digest(sess.state)
        quarantined_dirs = len(glob.glob(os.path.join(tmp,
                                                      "step_*.corrupt*")))
        return {
            "baseline_digest": baseline_digest,
            "final_digest": final_digest,
            "digest_match": int(final_digest == baseline_digest),
            "batches_seen": sess.state.batches_seen,
            "restarts": report.restarts,
            "rollbacks": report.rollbacks,
            "health_failures": report.health_failures,
            "timeouts": report.timeouts,
            "batches_skipped": report.batches_skipped,
            "ckpt_quarantined": quarantined_dirs,
            "recovery_seconds": report.recovery_seconds,
            "heals": (pipe.prefetch.heals if hasattr(pipe, "prefetch")
                      else 0),
            "workers_killed": monkey.workers_killed,
            "ckpts_truncated": monkey.ckpts_truncated,
            "faults_fired": len(monkey.fired),
            "faults_scheduled": schedule.n_faults,
            "probes": report.probes,
            "probe_seconds": report.probe_seconds,
            "batches": report.batches,
            "wall_seconds": wall,
            "backend": sess.backend,
            "device": str(sess.device),
        }
    finally:
        if owns_dir:
            shutil.rmtree(tmp, ignore_errors=True)
