"""Deterministic serve-side chaos: kill/restart the snapshot watcher
mid-swap and prove no query is dropped or served from a torn table.

The port's counterpart of ``repro.serve.chaos``; it mirrors
:mod:`repro_torch.train.chaos`: a frozen :class:`ServeChaosSchedule`
scripts *which event fires at which query ordinal* — publish a new
checkpoint, crash the watcher, restart it — so the same schedule replays
the same interleaving. :func:`run_serve_chaos` executes it end to end
and audits every response after the fact:

* **dropped** — a request accepted by :meth:`EmbeddingServer.submit`
  whose future never resolved. The drain-on-close contract says this is
  always 0.
* **torn** — a response that does not bit-match the dense oracle
  (:func:`~repro_torch.serve.query.dense_topk`) recomputed from the *exact
  snapshot step the response claims* (``snapshot_step``). A batch that
  read a half-swapped table would answer from no published step and
  fail this audit; one-index-per-batch makes it impossible.

The pass bar (asserted by ``tests/test_torch_serve.py`` and by
``chip_smoke.py`` on the card): ``dropped == 0``, ``torn == 0``, every
scheduled crash fired, and the checkpoint published while the watcher was
dead is picked up after restart (hot-swap liveness). Checkpoints are
written through the port's ``checkpoint.save``, in the reference's
format; the oracle runs on the CPU from the published table.
"""
from __future__ import annotations

import dataclasses
import logging
import tempfile
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.distributed.vocab_placement import VocabPlacement
from repro_torch.serve.query import dense_topk
from repro_torch.serve.server import EmbeddingServer
from repro_torch.serve.snapshot import SnapshotWatcher

log = logging.getLogger("repro_torch.serve.chaos")


@dataclasses.dataclass(frozen=True)
class ServeChaosSchedule:
    """A deterministic serve-fault script plus its synthetic workload."""

    n_queries: int = 48
    publish_at: Tuple[int, ...] = (0, 12, 24)   # query ordinals; 0 = boot
    crash_at: Tuple[int, ...] = (20,)           # watcher dies before #24's
    restart_at: Tuple[int, ...] = (32,)         # publish, restarts after
    vocab_size: int = 96
    hot: int = 16
    dim: int = 16
    train_shards: int = 2       # checkpoints written in this stripe layout
    batch_size: int = 8
    k: int = 5
    deadline_ms: float = 1.0
    poll_s: float = 0.02
    seed: int = 0

    @property
    def n_events(self) -> int:
        return (len(self.publish_at) + len(self.crash_at)
                + len(self.restart_at))


SCHEDULES: Dict[str, ServeChaosSchedule] = {
    # The acceptance bar: one live swap, then a crash, a publish into the
    # dead window, and a restart that must pick the missed step up.
    "ci": ServeChaosSchedule(),
    "smoke": ServeChaosSchedule(n_queries=16, publish_at=(0, 6),
                                crash_at=(), restart_at=()),
    "none": ServeChaosSchedule(publish_at=(0,), crash_at=(),
                               restart_at=()),
}


def _publish(ckpt_dir: str, step: int, table: np.ndarray,
             placement: VocabPlacement) -> np.ndarray:
    """Write `table` as a real split-format checkpoint (both tables +
    placement extra, like ``TrainSession.save_checkpoint``); returns the
    normalized dense table — the oracle for responses claiming `step`."""
    from repro_torch.train import checkpoint as ckpt

    hot, cold = placement.split(table)
    tree = {"hot_in": hot, "cold_in": cold,
            "hot_out": hot * 0.5, "cold_out": cold * 0.5}
    ckpt.save(ckpt_dir, step, tree,
              extra={"vocab_shard": placement.to_extra(),
                     "batches_seen": step})
    norm = np.maximum(np.linalg.norm(table, axis=1, keepdims=True), 1e-12)
    return (table / norm).astype(np.float32)


def _wait(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise TimeoutError(f"chaos: timed out waiting for {what}")


def run_serve_chaos(schedule: ServeChaosSchedule, *,
                    ckpt_dir: Optional[str] = None,
                    mesh=None, timeout: float = 60.0,
                    device=None) -> Dict:
    """Run `schedule` end to end on ``device`` (the GPU unless ``"cpu"``
    is asked for; the mesh's device under a mesh, where the other ranks
    run ``serve_follower``); returns the audit/metrics dict.

    ``dropped`` and ``torn`` are the headline counters — both must be 0.
    """
    rng = np.random.default_rng(schedule.seed)
    placement = VocabPlacement(vocab_size=schedule.vocab_size,
                               hot=schedule.hot,
                               n_shards=schedule.train_shards)

    owns_dir = ckpt_dir is None
    tmp = tempfile.mkdtemp(prefix="serve_chaos_") if owns_dir else ckpt_dir
    oracles: Dict[int, np.ndarray] = {}     # step -> normalized (V, d)
    next_step = [0]

    def publish() -> int:
        next_step[0] += 10
        step = next_step[0]
        table = rng.standard_normal(
            (schedule.vocab_size, schedule.dim)).astype(np.float32)
        oracles[step] = _publish(tmp, step, table, placement)
        log.info("chaos: published step %d", step)
        return step

    t0 = time.perf_counter()
    crashes_fired = restarts_fired = 0
    dead_window_step = None      # step published while the watcher was dead
    pending = []                 # (request, query ids)
    try:
        if 0 in schedule.publish_at:
            publish()
        watcher = SnapshotWatcher(tmp, mesh=mesh, poll_s=schedule.poll_s,
                                  device=device)
        watcher.start()
        watcher.wait_ready(timeout=timeout)
        server = EmbeddingServer(watcher, batch_size=schedule.batch_size,
                                 deadline_ms=schedule.deadline_ms,
                                 k=schedule.k)
        for i in range(schedule.n_queries):
            if i in schedule.crash_at:
                watcher.inject_crash()
                _wait(lambda: not watcher.alive, timeout, "watcher crash")
                crashes_fired += 1
            if i in schedule.publish_at and i > 0:
                step = publish()
                if watcher.alive:
                    # live swap: wait for pickup so the swap provably
                    # lands *between* query i-1 and some later query
                    _wait(lambda: watcher.ready
                          and watcher.current().step == step,
                          timeout, f"swap to step {step}")
                else:
                    dead_window_step = step
            if i in schedule.restart_at:
                watcher.start()
                restarts_fired += 1
                if dead_window_step is not None:
                    # hot-swap liveness: the missed publish must be
                    # picked up without restarting the *server*
                    _wait(lambda: watcher.current().step
                          == dead_window_step,
                          timeout, f"post-restart swap to "
                          f"{dead_window_step}")
            n = 1 + int(rng.integers(schedule.batch_size))
            ids = rng.integers(schedule.vocab_size, size=n).astype(np.int32)
            pending.append((server.submit("nn", ids), ids))
        server.close(timeout=timeout)       # drain: answers everything
        watcher.stop()

        dropped = torn = unresolved_errors = 0
        steps_served = set()
        for req, ids in pending:
            if not req.event.is_set():
                dropped += 1
                continue
            if req.error is not None:
                unresolved_errors += 1
                continue
            res = req.result
            if res.snapshot_step not in oracles:
                torn += 1                    # answered from no real step
                continue
            steps_served.add(res.snapshot_step)
            want_ids, want_sc = dense_topk(
                oracles[res.snapshot_step], ids, k=schedule.k, mode="nn")
            if not (np.array_equal(res.ids, want_ids)
                    and np.allclose(res.scores, want_sc, atol=1e-5)):
                torn += 1
        wall = time.perf_counter() - t0
        return {
            "queries": len(pending),
            "dropped": dropped,
            "torn": torn,
            "errors": unresolved_errors,
            "swaps": watcher.swaps,
            "crashes": watcher.crashes,
            "crashes_fired": crashes_fired,
            "restarts_fired": restarts_fired,
            "load_failures": watcher.load_failures,
            "publishes": len(oracles),
            "steps_served": len(steps_served),
            "final_step_served": (watcher._index.step
                                  if watcher._index is not None else None),
            "served": server.served,
            "batches": server.batches,
            "wall_seconds": round(wall, 3),
        }
    finally:
        if owns_dir:
            import shutil
            shutil.rmtree(tmp, ignore_errors=True)
