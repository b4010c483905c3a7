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


@dataclasses.dataclass
class SupervisorReport:
    """What one supervised run survived.

    ``restarts`` counts recovery invocations (one per step failure);
    ``rollbacks`` counts checkpoint restores, which can exceed
    ``restarts`` when a restored checkpoint itself fails the health probe
    and the fallback walks further back. ``recovery_seconds`` is total
    wall time inside recovery (close stream, restore, reopen).
    ``probes`` / ``probe_seconds`` count the health probes and the host
    time they took, the device sync included.
    """
    restarts: int = 0
    rollbacks: int = 0
    health_failures: int = 0
    timeouts: int = 0
    batches_skipped: int = 0
    ckpt_quarantined: int = 0    # restored-but-unhealthy checkpoints
    recovery_seconds: float = 0.0
    batches: int = 0             # metrics consumed, replays included
    probes: int = 0
    probe_seconds: float = 0.0


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

    # -- the supervised loop -------------------------------------------------
    def _step(self, step: int) -> None:
        if self._it is None:
            self._open()
            if self._finished:
                return
        guard = (Watchdog(self.step_timeout_s) if self.step_timeout_s
                 else contextlib.nullcontext())
        with guard:
            metrics = next(self._it, None)
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
            if restored is None or self._healthy():
                break
            # the checkpoint itself is poisoned (saved after the
            # corruption landed) — quarantine and fall back further
            ckpt.quarantine(self.session.ckpt_dir, restored)
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
