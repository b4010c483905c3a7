"""Supervised, self-healing W2V training (DESIGN.md §9).

The port's counterpart of ``repro.train.supervisor``.
:class:`TrainSupervisor` drives :meth:`TrainSession.stream` under
``run_with_recovery`` + ``Watchdog``: any step failure — an exception out
of the kernel or pipeline, a :class:`StepTimeout`, a failed table health
probe — rolls the session back to the latest good checkpoint
(``TrainSession.restore_latest``) and replays. Because batching randomness
is keyed by ``(corpus, cfg, epoch, batch_index)``, the checkpoint carries
the exact :class:`PipelineCursor` and the kernels keep the reference's
strict sentence order, the replayed stream is bit-identical to the
uninterrupted one: a supervised run that survives faults ends with exactly
the tables a fault-free run produces (``train.chaos`` pins this by
digest).

The health guard probes the tables every ``health_every`` trained
batches: one ``max(|table|)`` reduce per table, all read back in one
device-to-host copy. On the GPU that copy waits for the step's kernel, so
``health_every=1`` serializes the host with every kernel;
``SupervisorReport.probe_seconds`` records what the probes cost.
Non-finite values or a norm blow-up raise :class:`HealthError`, which
recovery treats like any step failure — except that with
``skip_poison=True`` the offending batch is marked in
``session.poison_skip`` so the replay excises it (counters advance, tables
untouched; counted and logged, never silent). Skip identification assumes
``health_every=1``, so the supervisor refuses any other value with it. A
restored checkpoint is probed too: one that itself fails health is
quarantined and the fallback continues further back.

Under a mesh of several ranks (one process each, SPMD) every rank takes
the same recovery decisions. After every supervised batch each rank
catches its own outcome (success, a step exception, a
:class:`StepTimeout`, a :class:`HealthError` from probing its own tables)
and the ranks vote: one ``all_gather`` of a small int64 row per rank,
``[batches_seen, epoch, epoch_batch, finished, status]``, on the mesh's
control group (``DataMesh.control``), so a vote never pairs with a step's
collective. Positions that differ raise :class:`MeshDesync` on every rank,
which ends the run. If any rank failed, every rank raises the kind of the
lowest failing rank: that rank its own exception, the others a
:class:`PeerError` of the same kind naming it. ``run_with_recovery``, the
restart budget and the report then take the same path on every rank; a
rollback restores the step rank 0 chose (``TrainSession.restore_latest``),
and the restored tables' health is voted too, so a checkpoint unhealthy
on any rank is quarantined once, by rank 0, and every rank falls back.
Every scheduled fault fires after its batch's collectives, so one vote a
batch suffices for them. A fault before a step's collective leaves the
peers inside it: the faulted rank's vote times out (the control group's
timeout is half the mesh's) and raises :class:`MeshDesync`, and the
launcher ends the job naming that rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import time
from typing import Iterator, Optional

import torch

from repro_torch.train import checkpoint as ckpt
from repro_torch.train.resilience import (RetryPolicy, StepTimeout, Watchdog,
                                          run_with_recovery)

log = logging.getLogger("repro_torch.supervisor")


class HealthError(RuntimeError):
    """A table health probe failed: non-finite values or ``max(|x|)``
    above the divergence bound."""


class MeshDesync(RuntimeError):
    """The ranks of a supervised mesh disagree on where they stand, or a
    vote failed because a peer never reached it (a fault before or inside
    a step's collective). Recovery cannot go on: the run ends."""


class PeerError(RuntimeError):
    """Raised on a rank under a mesh when peer ``rank`` failed the batch
    (``what``: its exception): a step failure. Its subclasses keep the
    other kinds, so recovery takes the failing rank's path."""

    def __init__(self, rank: int, what: str):
        super().__init__(f"rank {rank} failed: {what}")
        self.rank = rank


class PeerStepTimeout(PeerError, StepTimeout):
    """A peer's step exceeded the watchdog's bound."""


class PeerHealthError(PeerError, HealthError):
    """A peer's tables failed the health probe."""


# a vote's status codes: 0 is success
_STEP, _TIMEOUT, _HEALTH = 1, 2, 3
_PEER = {_STEP: PeerError, _TIMEOUT: PeerStepTimeout,
         _HEALTH: PeerHealthError}


def _status(exc: Optional[BaseException]) -> int:
    if exc is None:
        return 0
    if isinstance(exc, HealthError):
        return _HEALTH
    if isinstance(exc, StepTimeout):
        return _TIMEOUT
    return _STEP


@dataclasses.dataclass
class SupervisorReport:
    """What one supervised run survived.

    ``restarts`` counts recovery invocations (one per step failure);
    ``rollbacks`` counts checkpoint restores, which can exceed
    ``restarts`` when a restored checkpoint itself fails the health probe
    and the fallback walks further back. ``recovery_seconds`` is total
    wall time inside recovery (close stream, restore, reopen).
    ``batches`` counts the metrics consumed, replays included (the
    reference's field); ``batches_trained`` counts the batches trained,
    replays included, also one whose step raised after its update.
    ``probes`` / ``probe_seconds`` count the health probes and the host
    time they took, the device sync included. Under a mesh every count
    but ``batches`` and ``probes`` is equal on every rank (a rank whose
    step raised consumed no metrics and did not probe that batch);
    ``votes`` / ``vote_seconds`` count the rank's votes and the host time
    inside them, waiting for the slowest rank included.
    """
    restarts: int = 0
    rollbacks: int = 0
    health_failures: int = 0
    timeouts: int = 0
    batches_skipped: int = 0
    ckpt_quarantined: int = 0    # restored-but-unhealthy checkpoints
    recovery_seconds: float = 0.0
    batches: int = 0             # metrics consumed, replays included
    batches_trained: int = 0     # batches trained, replays included
    probes: int = 0
    probe_seconds: float = 0.0
    votes: int = 0
    vote_seconds: float = 0.0


def table_max_abs(params) -> dict:
    """``max(|t|)`` of every table over its storage values (an int8 tail
    as stored, not decoded; its f32 scales are tables here too), read back
    in one device-to-host copy (NaN/Inf propagate through max)."""
    names = list(params)
    maxes = torch.stack([params[n].detach().abs().amax().float()
                         for n in names])
    return dict(zip(names, maxes.cpu().tolist()))


class TrainSupervisor:
    """Run a :class:`TrainSession` to completion through faults.

    Parameters
    ----------
    max_restarts / backoff_s / reset_after : the :class:`RetryPolicy`.
        ``reset_after > 0`` refills the budget after that many
        consecutive good batches.
    step_timeout_s : watchdog bound on a single batch (0 disables); see
        :class:`Watchdog` for what it times on the GPU.
    health_every : probe the tables every N trained batches (0 disables).
    norm_bound : ``max(|table|)`` above this raises :class:`HealthError`.
    skip_poison : on a health failure, mark the offending batch in
        ``session.poison_skip`` so the replay skips it. Requires
        ``health_every == 1``.
    epochs / max_batches : forwarded to ``stream``; ``max_batches`` is a
        *global* position (``state.batches_seen``), so replayed batches
        are not double-counted against it.

    Under the session's mesh every rank constructs and runs one, with the
    same arguments.
    """

    def __init__(self, session, *,
                 max_restarts: int = 3,
                 backoff_s: float = 0.05,
                 reset_after: int = 0,
                 step_timeout_s: float = 0.0,
                 health_every: int = 0,
                 norm_bound: float = 1e4,
                 skip_poison: bool = False,
                 epochs: Optional[int] = None,
                 max_batches: Optional[int] = None):
        if skip_poison and health_every != 1:
            raise ValueError(
                "skip_poison requires health_every=1: a coarser probe "
                "cannot attribute the failure to one batch")
        self.session = session
        self.policy = RetryPolicy(max_restarts=max_restarts,
                                  backoff_s=backoff_s,
                                  reset_after=reset_after)
        self.step_timeout_s = step_timeout_s
        self.health_every = health_every
        self.norm_bound = norm_bound
        self.skip_poison = skip_poison
        self.epochs = epochs
        self.max_batches = max_batches
        self.report = SupervisorReport()
        self._it: Optional[Iterator] = None
        self._finished = False
        self._since_probe = 0
        mesh = getattr(session, "mesh", None)
        self._mesh = mesh if mesh is not None and mesh.size > 1 else None

    # -- health probe --------------------------------------------------------
    def _probe(self) -> None:
        """One ``max(|x|)`` per table, one device sync for all of them."""
        t0 = time.perf_counter()
        maxes = table_max_abs(self.session.state.params())
        self.report.probes += 1
        self.report.probe_seconds += time.perf_counter() - t0
        for name, m in maxes.items():
            if not math.isfinite(m):
                raise HealthError(f"non-finite values in table {name!r}")
            if m > self.norm_bound:
                raise HealthError(
                    f"divergence in table {name!r}: max|x| = {m:.3g} > "
                    f"bound {self.norm_bound:g}")

    def _healthy(self) -> bool:
        try:
            self._probe()
            return True
        except HealthError:
            return False

    # -- stream plumbing -----------------------------------------------------
    def _remaining(self) -> Optional[int]:
        if self.max_batches is None:
            return None
        return max(0, self.max_batches - self.session.state.batches_seen)

    def _open(self) -> None:
        remaining = self._remaining()
        if remaining == 0:
            self._finished = True
            return
        self._it = self.session.stream(epochs=self.epochs,
                                       max_batches=remaining)

    def _close(self) -> None:
        if self._it is not None:
            self._it.close()
            self._it = None

    # -- the ranks' vote -----------------------------------------------------
    def _gather(self, row, own: Optional[BaseException] = None) -> list:
        """Every rank's int ``row``, by rank: one ``all_gather`` on the
        mesh's control group. A failed gather (a peer that never votes
        before the group's timeout) raises :class:`MeshDesync`; ``own``
        is this rank's failure, named in it."""
        from repro_torch.distributed import collectives as coll
        ctl = self._mesh.control
        t0 = time.perf_counter()
        try:
            rows = coll.all_gather(torch.tensor(row, dtype=torch.int64,
                                                device=ctl.device),
                                   ctl).tolist()
        except RuntimeError as e:
            mine = "" if own is None else f" after its own {own!r}"
            raise MeshDesync(
                f"rank {ctl.rank}: the vote failed{mine}; a peer did not "
                f"reach it (a fault before or inside a step's collective)"
            ) from e
        self.report.votes += 1
        self.report.vote_seconds += time.perf_counter() - t0
        return rows

    @staticmethod
    def _agree(rows, cols: int, what: str) -> None:
        """Raise :class:`MeshDesync` unless the rows' first ``cols``
        values are equal on every rank."""
        if any(r[:cols] != rows[0][:cols] for r in rows):
            raise MeshDesync(f"the ranks disagree on the {what}: " + ", ".join(
                f"rank {i} {r[:cols]}" for i, r in enumerate(rows)))

    def _vote(self, exc: Optional[Exception]) -> None:
        """The ranks' vote on this batch (see the module docstring): every
        rank returns, or every rank raises the same kind."""
        s = self.session.state
        rows = self._gather([s.batches_seen, s.epoch, s.epoch_batch,
                             int(self._finished), _status(exc)], exc)
        self._agree(rows, 4, "position [batches_seen, epoch, epoch_batch, "
                             "finished]")
        failed = [r for r, row in enumerate(rows) if row[4]]
        if not failed:
            return
        import torch.distributed as dist
        whats = [None] * self._mesh.size     # the failures, for the message
        dist.all_gather_object(whats, None if exc is None else repr(exc),
                               group=self._mesh.control_group)
        first, kind = failed[0], rows[failed[0]][4]
        if exc is not None and _status(exc) == kind:
            raise exc
        raise _PEER[kind](first, whats[first]) from exc

    # -- the supervised loop -------------------------------------------------
    def _step(self, step: int) -> None:
        if self._mesh is None:
            self._advance()
            return
        exc = None
        try:
            self._advance()
        except Exception as e:   # noqa: BLE001 — voted; the vote raises it
            exc = e
        self._vote(exc)

    def _advance(self) -> None:
        """Train the next batch (and probe the tables when due)."""
        if self._it is None:
            self._open()
            if self._finished:
                return
        guard = (Watchdog(self.step_timeout_s) if self.step_timeout_s
                 else contextlib.nullcontext())
        before = self.session.state.batches_seen
        try:
            with guard:
                metrics = next(self._it, None)
        finally:
            # trained, whether or not the step raised after its update
            self.report.batches_trained += (self.session.state.batches_seen
                                            - before)
        if metrics is None:
            self._finished = True
            return
        self.report.batches += 1
        if self.health_every:
            self._since_probe += 1
            if self._since_probe >= self.health_every:
                self._since_probe = 0
                self._probe()

    def _recover(self, step: int, exc: BaseException) -> int:
        if isinstance(exc, MeshDesync):
            raise exc
        t0 = time.perf_counter()
        self.report.restarts += 1
        if isinstance(exc, HealthError):
            self.report.health_failures += 1
            if self.skip_poison:
                s = self.session.state
                key = (s.epoch, s.epoch_batch - 1)
                self.session.poison_skip.add(key)
                log.warning("marking poison batch %s for skip on replay",
                            key)
        if isinstance(exc, StepTimeout):
            self.report.timeouts += 1
        self._close()
        self._since_probe = 0
        while True:
            restored = self.session.restore_latest()
            self.report.rollbacks += 1
            healthy = self._healthy()
            if self._mesh is not None:
                rows = self._gather([-1 if restored is None else restored,
                                     int(healthy)])
                self._agree(rows, 1, "restored step")
                healthy = all(r[1] for r in rows)
            if restored is None or healthy:
                break
            # the checkpoint itself is poisoned (saved after the
            # corruption landed) — quarantine and fall back further
            if self._mesh is None or self._mesh.rank == 0:
                ckpt.quarantine(self.session.ckpt_dir, restored)
            if self._mesh is not None:
                self._mesh.control.barrier()
            self.report.ckpt_quarantined += 1
            log.warning("restored checkpoint step %d fails the health "
                        "probe — quarantined, falling back", restored)
        log.warning("recovered from %r: rolled back to step %s",
                    exc, restored)
        self.report.recovery_seconds += time.perf_counter() - t0
        return step

    def run(self):
        """Drain the session through faults; returns the final
        :class:`TrainState`. Raises only when the restart budget is
        exhausted (the last failure propagates)."""
        self.report = SupervisorReport()
        self._finished = False
        self._it = None
        try:
            run_with_recovery(self._step, start_step=0,
                              on_failure=self._recover,
                              policy=self.policy,
                              should_stop=lambda: self._finished)
        finally:
            self._close()
        self.report.batches_skipped = self.session.batches_skipped
        return self.session.state
