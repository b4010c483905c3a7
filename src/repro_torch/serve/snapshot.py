"""Snapshot hot-swap: a long-running server follows a training run's
checkpoint stream with zero dropped queries.

The port's counterpart of ``repro.serve.snapshot``.
:class:`SnapshotWatcher` polls ``checkpoint.latest_step`` on a cadence,
and when a newer step appears it **stages** the new
:class:`~repro_torch.serve.index.EmbeddingIndex` fully on the device and
then atomically flips the serving pointer (one reference assignment).
The protocol (DESIGN.md §10):

* **Stage-then-flip** — the new snapshot is loaded, placed, normalized
  and waited for on the device *before* the flip; at no point does a
  query see a half-loaded table.
* **In-flight queries finish on the old snapshot** — the server takes
  one index reference per batch (``current()``); a flip changes what the
  *next* batch sees, never a batch already scoring.
* **Publisher faults are survivable** — ``latest_step`` cleans
  interrupted publishes and quarantines partial directories (DESIGN.md
  §9); a load that still fails is logged, counted (``load_failures``)
  and retried next tick — the previous snapshot keeps serving.

Under a mesh of several ranks (one process per rank) a swap is a command
of rank 0's stream (:class:`~repro_torch.serve.server.CommandStream`):
rank 0's watcher finds step ``s`` and sends "stage ``s``"; every rank
loads its block of ``s`` (:meth:`SnapshotWatcher.stage`), and the minimum
of the ranks' success flags decides: all ranks flip or none does, so a
load that fails on one rank only leaves every rank on the old step.
Ranks other than 0 run no watcher thread: ``serve_follower`` calls
:meth:`~SnapshotWatcher.stage` when the command arrives.

``inject_crash()`` kills the watcher thread at its next tick (the chaos
harness's deterministic stand-in for a SIGKILL'd watcher process);
``start()`` restarts a crashed watcher, re-scanning from whatever the
newest checkpoint now is.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from repro_torch.serve.index import EmbeddingIndex
from repro_torch.serve.server import CommandStream, agree

log = logging.getLogger("repro_torch.serve.snapshot")


class WatcherCrash(RuntimeError):
    """Injected watcher-thread crash (chaos harness only)."""


class SnapshotWatcher:
    """Follow a checkpoint directory; hot-swap the served index.

    Parameters
    ----------
    ckpt_dir : checkpoint directory a (possibly live) training run
        publishes into.
    mesh : serving :class:`~repro_torch.launch.mesh.DataMesh` handed to
        the loader (``None``: one rank).
    poll_s : poll cadence for ``checkpoint.latest_step``.
    on_swap : callback ``(old_index | None, new_index)`` after every flip.
    loader : index factory ``loader(ckpt_dir, step=, mesh=, device=)``
        (tests substitute failure-injecting loaders).
    device : the index's device (the mesh's under a mesh; the GPU unless
        ``"cpu"`` is asked for).
    """

    def __init__(self, ckpt_dir: str, mesh=None, poll_s: float = 0.25,
                 on_swap: Optional[Callable] = None,
                 loader: Callable = EmbeddingIndex.load, device=None):
        self.ckpt_dir = ckpt_dir
        self.mesh = mesh
        self.poll_s = poll_s
        self.on_swap = on_swap
        self.loader = loader
        self.device = device
        many = mesh is not None and mesh.size > 1
        # rank 0 of a mesh sends its swaps down the command stream
        self.commands = (CommandStream(mesh) if many and mesh.rank == 0
                         else None)
        self._index: Optional[EmbeddingIndex] = None
        self._lock = threading.Lock()     # guards thread start/stop, not reads
        self._stop = threading.Event()
        self._crash = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.swaps = 0
        self.load_failures = 0
        self.crashes = 0
        self.polls = 0

    # -- serving side --------------------------------------------------------
    def current(self) -> EmbeddingIndex:
        """The serving snapshot — one atomic reference read. Callers hold
        the returned index for a whole batch, so a concurrent flip never
        tears a batch."""
        idx = self._index
        if idx is None:
            raise RuntimeError(
                f"no snapshot loaded yet from {self.ckpt_dir} "
                f"(call wait_ready or check the checkpoint dir)")
        return idx

    index = current   # alias

    @property
    def ready(self) -> bool:
        """True once a first snapshot is serving."""
        return self._index is not None

    def wait_ready(self, timeout: float = 30.0) -> EmbeddingIndex:
        """Block until the first snapshot is staged (the server's startup
        barrier)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._index is not None:
                return self._index
            if self._thread is None or not self._thread.is_alive():
                # crashed/never started: try one synchronous load so a
                # caller without a running watcher still gets an index
                self.poll_once()
                if self._index is not None:
                    return self._index
            time.sleep(0.01)
        raise TimeoutError(
            f"no usable checkpoint appeared under {self.ckpt_dir} "
            f"within {timeout:.1f}s")

    # -- watcher side --------------------------------------------------------
    def poll_once(self) -> bool:
        """One poll: stage + flip if a newer step is published. Returns
        True when a swap happened. Load failures are counted and
        swallowed — the previous snapshot keeps serving."""
        from repro_torch.train import checkpoint as ckpt

        self.polls += 1
        try:
            step = ckpt.latest_step(self.ckpt_dir)
        except OSError as e:               # directory vanished mid-scan
            log.warning("snapshot poll failed on %s: %s", self.ckpt_dir, e)
            self.load_failures += 1
            return False
        cur = self._index
        if step is None or (cur is not None and cur.step == step):
            return False
        if self.commands is not None:
            return self.commands.stage(step, self.stage)
        return self.stage(step)

    def stage(self, step: int) -> bool:
        """Load ``step`` and flip to it; True when the flip happened.
        Under a mesh of several ranks every rank calls this for the same
        step (a collective) and all flip or none does."""
        cur = self._index
        try:
            new, err = self.loader(self.ckpt_dir, step=step, mesh=self.mesh,
                                   device=self.device), None
        except Exception as e:  # noqa: BLE001 — any load fault: keep serving
            new, err = None, e
        if self.mesh is not None and self.mesh.size > 1:
            new, err = agree(new, err, self.mesh, step)
        if new is None:
            log.warning("snapshot load of step %s failed (%s) — keeping "
                        "step %s", step, err,
                        cur.step if cur is not None else None)
            self.load_failures += 1
            return False
        self._index = new                  # the atomic flip
        self.swaps += 1
        log.info("snapshot swap: step %s -> %s (swap #%d)",
                 cur.step if cur is not None else None, new.step, self.swaps)
        if self.on_swap is not None:
            self.on_swap(cur, new)
        return True

    def _run(self) -> None:
        try:
            while not self._stop.is_set():
                if self._crash.is_set():
                    self._crash.clear()
                    raise WatcherCrash("injected watcher crash")
                self.poll_once()
                self._stop.wait(self.poll_s)
        except WatcherCrash:
            self.crashes += 1
            log.warning("snapshot watcher crashed (injected); serving "
                        "continues on step %s until restart",
                        self._index.step if self._index else None)

    def start(self) -> "SnapshotWatcher":
        """Start (or restart after a crash) the watcher thread. Under a
        mesh only rank 0 runs one; the other ranks stage on command."""
        if self.mesh is not None and self.mesh.rank != 0:
            raise RuntimeError("only rank 0 runs the watcher thread; the "
                               "other ranks run serve_follower")
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="snapshot-watcher", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the watcher (the served index stays available)."""
        with self._lock:
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=10.0)
                self._thread = None

    @property
    def alive(self) -> bool:
        """True while the watcher thread is running."""
        return self._thread is not None and self._thread.is_alive()

    def inject_crash(self) -> None:
        """Chaos hook: the watcher thread dies at its next tick (serving
        is unaffected; ``start()`` restarts it)."""
        self._crash.set()

    def __enter__(self) -> "SnapshotWatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
