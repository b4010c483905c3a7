"""Fault-tolerance utilities: retry-with-restore, watchdog, straggler
monitor, failure injection.

The port's counterpart of ``repro.train.resilience`` (standard library
only). A step that raises triggers restore-from-checkpoint through
``on_failure``; the W2V path drives these through
``repro_torch.train.supervisor.TrainSupervisor`` (DESIGN.md §9). The logic
is hardware-agnostic and unit-tested on the CPU via :class:`FailureInjector`.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger("repro_torch.resilience")


class StepTimeout(RuntimeError):
    pass


@dataclasses.dataclass
class RetryPolicy:
    """Restart budget for :func:`run_with_recovery`.

    ``reset_after > 0`` refills the budget (and resets the backoff) after
    that many *consecutive* successful steps: a week-long run with sparse,
    unrelated failures never exhausts a budget sized for failure *bursts*.
    ``reset_after = 0`` keeps the budget cumulative over the whole run.
    """
    max_restarts: int = 3
    backoff_s: float = 0.1
    backoff_mult: float = 2.0
    reset_after: int = 0


def run_with_recovery(step_fn: Callable[[int], None], *,
                      start_step: int, end_step: Optional[int] = None,
                      on_failure: Callable[[int, BaseException], int],
                      policy: RetryPolicy = RetryPolicy(),
                      should_stop: Optional[Callable[[], bool]] = None
                      ) -> int:
    """Drive `step_fn(step)` from start to end; on exception consult
    `on_failure(step, exc) -> resume_step` (typically: restore checkpoint,
    rebuild mesh, return the restored step). Returns the final step.

    ``end_step=None`` runs until ``should_stop()`` goes true — the mode for
    streaming workloads whose step count isn't known up front (the W2V
    supervisor drains a pipeline of unknown length). At least one of
    ``end_step`` / ``should_stop`` must be given.
    """
    if end_step is None and should_stop is None:
        raise ValueError("run_with_recovery needs end_step or should_stop")
    step = start_step
    restarts = 0
    successes = 0          # consecutive, for the reset_after budget refill
    backoff = policy.backoff_s
    while end_step is None or step < end_step:
        if should_stop is not None and should_stop():
            break
        try:
            step_fn(step)
            step += 1
            successes += 1
            if (policy.reset_after and restarts
                    and successes >= policy.reset_after):
                log.info("restart budget refilled after %d consecutive "
                         "good steps (%d restart(s) forgiven)",
                         successes, restarts)
                restarts = 0
                backoff = policy.backoff_s
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001
            successes = 0
            restarts += 1
            if restarts > policy.max_restarts:
                log.error("step %d failed %d times — giving up", step,
                          restarts)
                raise
            log.warning("step %d failed (%r); recovering (restart %d/%d)",
                        step, e, restarts, policy.max_restarts)
            time.sleep(backoff)
            backoff *= policy.backoff_mult
            step = on_failure(step, e)
    return step


class Watchdog:
    """Raises (in the waiting thread) if a step exceeds `timeout_s` —
    detects hung collectives / dead hosts. Use as a context manager around
    the blocking step call.

    It times the *host* side of a step. On the GPU a step returns once its
    kernel is launched, so a kernel that hangs surfaces at the next call
    that waits for the device (the next step's host-to-device copy, a
    checkpoint's device-to-host copy, a health probe), inside that call's
    watchdog — as a hung device call does under jax's async dispatch in
    the reference.

    If the step *also* raised, the timeout is not swallowed: a
    :class:`StepTimeout` chained from the step's exception propagates, so
    recovery sees both facts. Non-``Exception`` escapes
    (KeyboardInterrupt/SystemExit) win over the timeout and propagate
    unchanged (logged).
    """

    def __init__(self, timeout_s: float,
                 on_timeout: Optional[Callable[[], None]] = None):
        self.timeout_s = timeout_s
        self.on_timeout = on_timeout
        self._timer: Optional[threading.Timer] = None
        self.fired = False

    def _fire(self):
        self.fired = True
        if self.on_timeout:
            self.on_timeout()

    def __enter__(self):
        self._timer = threading.Timer(self.timeout_s, self._fire)
        self._timer.daemon = True
        self._timer.start()
        return self

    def __exit__(self, exc_type, exc, tb):
        assert self._timer is not None
        self._timer.cancel()
        if not self.fired:
            return False
        if exc_type is None:
            raise StepTimeout(f"step exceeded {self.timeout_s}s")
        if issubclass(exc_type, Exception):
            raise StepTimeout(
                f"step exceeded {self.timeout_s}s (and also raised "
                f"{exc!r})") from exc
        log.warning("watchdog fired during %r — propagating it unchanged",
                    exc)
        return False


class StragglerMonitor:
    """EMA-based step-time tracker. On real pods each host reports its step
    time; hosts persistently slower than `threshold` × median are flagged
    for replacement (the scheduler's straggler-mitigation hook).

    Decay convention (documented and tested): the first report *seeds* the
    EMA with the raw sample; every later report updates it as
    ``ema' = decay * ema + (1 - decay) * sample`` — ``decay`` weights the
    history, ``1 - decay`` the new sample.

    ``window > 0`` evicts hosts not heard from within the last ``window``
    reports (counted across *all* hosts): a host that left the job stops
    dragging the median. Size it well above the host count — e.g.
    ``4 × n_hosts`` tolerates a few missed heartbeats before eviction.
    """

    def __init__(self, decay: float = 0.9, threshold: float = 1.5,
                 window: int = 0):
        self.decay = decay
        self.threshold = threshold
        self.window = window
        self.times: Dict[str, float] = {}
        self._last_report: Dict[str, int] = {}
        self._n_reports = 0

    def report(self, host: str, seconds: float) -> None:
        prev = self.times.get(host)
        self.times[host] = (seconds if prev is None
                            else self.decay * prev
                            + (1 - self.decay) * seconds)
        self._n_reports += 1
        self._last_report[host] = self._n_reports
        if self.window:
            gone = [h for h, n in self._last_report.items()
                    if self._n_reports - n >= self.window]
            for h in gone:
                log.info("evicting silent host %s (last report %d of %d)",
                         h, self._last_report[h], self._n_reports)
                del self.times[h]
                del self._last_report[h]

    def median(self) -> float:
        vals = sorted(self.times.values())
        if not vals:
            return 0.0
        return vals[len(vals) // 2]

    def stragglers(self) -> List[str]:
        med = self.median()
        if med == 0.0:
            return []
        return [h for h, t in self.times.items()
                if t > self.threshold * med]


class FailureInjector:
    """Deterministic failure injection for tests: raises on the given
    steps (once each)."""

    def __init__(self, fail_steps: List[int],
                 exc_factory: Callable[[], BaseException] = RuntimeError):
        self.fail_steps = set(fail_steps)
        self.exc_factory = exc_factory

    def check(self, step: int) -> None:
        if step in self.fail_steps:
            self.fail_steps.remove(step)
            raise self.exc_factory(f"injected failure at step {step}")
