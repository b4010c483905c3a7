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

Under a mesh (``run_chaos(..., mesh=...)`` on every rank, or
:func:`run_chaos_ranks`) the rank-local faults (fail, NaN, worker kill)
fire on one rank, ``ChaosSchedule.fault_rank``, and the NaN goes into that
rank's own table (its replica's ``w_in`` when data-parallel, its cold
block when vocab-sharded); the truncation fires from rank 0, which writes
the checkpoints. The supervisor's vote makes every rank roll back
together, so the faulted N-rank run must end with the fault-free N-rank
run's gathered tables, and every rank with the same report.
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


def params_digest(params) -> str:
    """sha1 over a table dict's storage bytes, fetched to the host."""
    import torch

    h = hashlib.sha1()
    for t in params.values():
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def table_digest(state) -> str:
    """sha1 over every table of the state (``params()`` order: ``w_in``,
    ``w_out`` for a replicated session — the reference's digest — and the
    hot and cold tables of a vocab-sharded one), fetched to the host."""
    return params_digest(state.params())


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
    fault_rank: Optional[int] = None   # None: rank 1 under a mesh, else 0

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
    """Fires a :class:`ChaosSchedule` from a session's ``on_batch`` hook;
    under a ``mesh``, one per rank (rank-local faults on the schedule's
    fault rank, the truncation on rank 0)."""

    def __init__(self, schedule: ChaosSchedule, ckpt_dir: str, mesh=None):
        self.schedule = schedule
        self.ckpt_dir = ckpt_dir
        self.pipeline = None          # bound after session construction
        self.fired: set = set()
        self.workers_killed = 0
        self.ckpts_truncated = 0
        rank, ranks = (0, 1) if mesh is None else (mesh.rank, mesh.size)
        target = schedule.fault_rank
        if target is None:
            target = 1 if ranks > 1 else 0
        if not 0 <= target < ranks:
            raise ValueError(f"fault_rank {target} outside a mesh of "
                             f"{ranks}")
        self.local = rank == target   # fail, NaN and kills fire here
        self.writes = rank == 0       # the checkpoint writer truncates
        self.own_cold = ranks > 1     # a sharded rank's NaN: its cold block

    def bind(self, pipeline) -> None:
        self.pipeline = pipeline

    def _once(self, kind: str, n: int) -> bool:
        if (kind, n) in self.fired:
            return False
        self.fired.add((kind, n))
        return True

    def on_batch(self, state) -> None:
        n = state.batches_seen
        sched = self.schedule
        if self.local and n in sched.nan_at and self._once("nan", n):
            self._poison(state, n)
        if (self.writes and n in sched.truncate_ckpt_at
                and self._once("trunc", n)):
            self._truncate_newest(n)
        if self.local and n in sched.kill_worker_at and self._once("kill", n):
            self._kill_worker(n)
        if self.local and n in sched.fail_steps and self._once("fail", n):
            raise RuntimeError(f"chaos: injected failure at batch {n}")

    def _poison(self, state, n: int) -> None:
        """NaN into a cell of this rank's own table: ``w_in`` (a replica,
        or the hot head at one rank), or, on a sharded rank of a mesh, its
        cold block (the int8 tail's scales, since int8 has no NaN)."""
        table, name = state.w_in, "w_in"
        if self.own_cold and state.cold_in is not None:
            table, name = state.cold_in, "cold_in"
            if not table.is_floating_point():
                table, name = state.scale_in, "scale_in"
        log.warning("chaos: injecting NaN into %s at batch %d", name, n)
        table.view(-1)[0] = float("nan")

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


def workload(schedule: ChaosSchedule):
    """The schedule's tiny workload: ``(cfg, corpus)``."""
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
              cfg=None, corpus=None, mesh=None) -> Dict:
    """Run ``schedule`` end to end; returns the result/metrics dict.

    ``backend`` and ``device`` go to both sessions (``device=None`` is the
    GPU, as for every session of the port, or the mesh's device). ``cfg``
    and ``corpus`` replace the schedule's tiny workload (the schedule's
    ``epochs`` and ``prefetch_*`` still apply). ``digest_match`` is the
    headline: the supervised faulted run's final tables are bit-identical
    to the fault-free baseline's.

    Under a ``mesh`` of several ranks every rank calls it with the same
    arguments and a shared ``ckpt_dir``: both runs train on the mesh, the
    digests hash the gathered tables, and every rank returns the merged
    dict: rank 0's, with ``per_rank`` (each rank's own dict),
    ``reports_equal`` (the reports' counts equal on every rank), and the
    faults, kills, truncations and heals of all ranks together.
    """
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.prefetch import AsyncBatchingPipeline

    ranks = 1 if mesh is None else mesh.size
    if ranks > 1 and ckpt_dir is None:
        raise ValueError("run_chaos under a mesh needs the ranks' shared "
                         "ckpt_dir (run_chaos_ranks makes one)")
    if cfg is None or corpus is None:
        cfg, corpus = workload(schedule)
    cfg = dataclasses.replace(cfg, epochs=schedule.epochs,
                              prefetch_workers=schedule.prefetch_workers,
                              prefetch_mode=schedule.prefetch_mode)
    vocab = BatchingPipeline(corpus, cfg).vocab

    # fault-free baseline (sync pipeline: prefetch is bit-identical to it)
    base = TrainSession(BatchingPipeline(corpus, cfg, vocab=vocab), cfg,
                        backend=backend, device=device, mesh=mesh)
    base.train(max_batches=schedule.max_batches)
    baseline_digest = params_digest(base.gathered_params())
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
        monkey = ChaosMonkey(schedule, tmp, mesh)
        sess = TrainSession(pipe, cfg, backend=backend, device=device,
                            mesh=mesh, ckpt_dir=tmp,
                            ckpt_every=schedule.ckpt_every,
                            on_batch=monkey.on_batch)
        monkey.bind(pipe)
        t0 = time.perf_counter()
        sess.train_resilient(max_batches=schedule.max_batches,
                             max_restarts=schedule.max_restarts,
                             health_every=schedule.health_every,
                             backoff_s=0.01)
        wall = time.perf_counter() - t0
        report = sess.last_report
        final_digest = params_digest(sess.gathered_params())
        quarantined_dirs = len(glob.glob(os.path.join(tmp,
                                                      "step_*.corrupt*")))
        out = {
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
            "fired": sorted(monkey.fired),
            "faults_fired": len(monkey.fired),
            "faults_scheduled": schedule.n_faults,
            "probes": report.probes,
            "probe_seconds": report.probe_seconds,
            "votes": report.votes,
            "vote_seconds": report.vote_seconds,
            "batches": report.batches,
            "batches_trained": report.batches_trained,
            "wall_seconds": wall,
            "backend": sess.backend,
            "device": str(sess.device),
            "ranks": ranks,
            "reports_equal": 1,
        }
        if ranks == 1:
            return out
        import torch.distributed as dist
        every = [None] * ranks
        dist.all_gather_object(every, out, group=mesh.control_group)
        return _merged(every)
    finally:
        if owns_dir:
            shutil.rmtree(tmp, ignore_errors=True)


# the counts every rank's report must agree on (batches and probes are a
# rank's own: a rank whose step raised consumed no metrics and did not
# probe that batch)
_REPORT_COUNTS = ("restarts", "rollbacks", "health_failures", "timeouts",
                  "batches_skipped", "ckpt_quarantined", "batches_trained",
                  "votes", "batches_seen")


def _merged(every) -> Dict:
    """Rank 0's result with every rank's, and the ranks' faults together
    (see :func:`run_chaos`)."""
    counts = [{k: r[k] for k in _REPORT_COUNTS} for r in every]
    fired = sorted(set().union(*(map(tuple, r["fired"]) for r in every)))
    return {**every[0], "per_rank": every,
            "reports_equal": int(all(c == counts[0] for c in counts)),
            "digest_match": int(all(r["digest_match"] for r in every)),
            "fired": fired, "faults_fired": len(fired),
            **{k: sum(r[k] for r in every)
               for k in ("heals", "workers_killed", "ckpts_truncated")}}


def _chaos_rank(mesh, schedule: ChaosSchedule, ckpt_dir: str, kw) -> Dict:
    return run_chaos(schedule, mesh=mesh, ckpt_dir=ckpt_dir, **kw)


def run_chaos_ranks(schedule: ChaosSchedule, n: int, device=None, *,
                    timeout: float = 900.0, **kw) -> Dict:
    """:func:`run_chaos` on ``n`` new ranks, one process each
    (``repro_torch.launch.mesh.start_ranks`` on ``device``: the GPU
    unless the caller asks for the CPU), sharing a temporary checkpoint
    directory; returns the merged dict. ``kw`` goes to :func:`run_chaos`
    (``backend``, ``cfg``, ``corpus``). A rank that fails ends the job
    with ``RankFailed``."""
    from repro_torch.launch.mesh import start_ranks
    with tempfile.TemporaryDirectory(prefix="chaos_ckpt_") as tmp:
        return start_ranks(_chaos_rank, n, device, schedule, tmp, kw,
                           timeout=timeout)
