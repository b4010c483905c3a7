"""Request batcher in front of the sharded top-k.

The port's counterpart of ``repro.serve.server``.
:class:`EmbeddingServer` coalesces individual neighbour/analogy requests
into batches — the serving analogue of the training kernel's
minibatching: one device call amortizes the table sweep over the whole
batch. The reference pads every batch to ``batch_size`` rows so its
jitted function compiles once; the port needs no fixed shape and scores
the real rows only (rows are answered independently, so the answers are
the same).

Batch-cut policy (DESIGN.md §10): a batch closes when it reaches
``batch_size`` query rows **or** ``deadline_ms`` after its first request
arrived, whichever comes first; past the deadline the requests already
queued still join it (the reference's loop stops at the deadline, so a
backlog older than the deadline cuts one-request batches; the answers do
not change). Requests of different kinds (nn vs analogy) never share a
device call; a kind change closes the batch and the odd request carries
into the next one.

Snapshot discipline: the dispatcher takes **one** index reference per
batch, so every query in a batch is answered from a single coherent
snapshot even while :class:`~repro_torch.serve.snapshot.SnapshotWatcher`
flips the pointer underneath. Each result records ``snapshot_step``.

``close()`` drains the queue before the dispatcher exits: a request
accepted by :meth:`~EmbeddingServer.submit` is always answered (zero
dropped queries); requests arriving *after* close raise immediately.

**Under a mesh of several ranks** (one process per rank, where the
reference runs one process under ``shard_map``) every rank must issue the
same collectives in the same order. Rank 0 owns a command stream
(:class:`CommandStream`): for each batch it broadcasts a small header
(kind, rows, ``k``, the snapshot step it chose) and the id block, then
runs the top-k; a hot swap is a "stage" command (see
:mod:`repro_torch.serve.snapshot`); ``close()`` sends "close". The other
ranks run :func:`serve_follower`, which executes the commands in order and
answers the collectives. Everything rank 0 sends goes under the stream's
lock, so the dispatcher and the watcher threads cannot interleave their
collectives. At one rank there is no stream and no follower.
"""
from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.serve.index import EmbeddingIndex
from repro_torch.serve.query import MODES, make_topk_fn

log = logging.getLogger("repro_torch.serve.server")

# command header: (op, kind, rows, k, snapshot step or -1)
_CLOSE, _BATCH, _STAGE = 0, 1, 2
_HEADER = 5


@dataclasses.dataclass
class QueryResult:
    """One answered request: global-id/score top-k plus provenance."""

    ids: np.ndarray                 # (n, k) int32 global vocabulary ids
    scores: np.ndarray              # (n, k) f32 cosine scores
    snapshot_step: Optional[int]    # checkpoint step that answered it
    latency_us: float               # submit -> resolve wall time


class _Request:
    __slots__ = ("kind", "ids", "k", "t0", "event", "result", "error")

    def __init__(self, kind: str, ids: np.ndarray, k: int):
        self.kind = kind
        self.ids = ids
        self.k = k
        self.t0 = time.perf_counter()
        self.event = threading.Event()
        self.result: Optional[QueryResult] = None
        self.error: Optional[BaseException] = None

    def resolve(self, result: QueryResult) -> None:
        self.result = result
        self.event.set()

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.event.set()

    def wait(self, timeout: Optional[float]) -> QueryResult:
        if not self.event.wait(timeout):
            raise TimeoutError("query not answered in time")
        if self.error is not None:
            raise self.error
        assert self.result is not None
        return self.result


def _many(mesh) -> bool:
    return mesh is not None and mesh.size > 1


def agree(new, err, mesh, step) -> Tuple[object, Optional[BaseException]]:
    """All ranks keep ``new`` or none does: the minimum of the ranks'
    success flags (a collective every rank calls)."""
    ok = torch.tensor([0 if new is None else 1], dtype=torch.int32,
                      device=mesh.device)
    if int(coll.all_gather(ok, mesh).min()) == 1:
        return new, None
    return None, err or RuntimeError(
        f"another rank failed to load step {step}")


def _topk(fns: Dict, index: EmbeddingIndex, kind: str, k: int, ids
          ) -> Tuple[np.ndarray, np.ndarray]:
    """The index's top-k for one batch, on the host (a collective under a
    mesh of several ranks)."""
    key = (index.placement, kind, k)
    fn = fns.get(key)
    if fn is None:
        fn = fns[key] = make_topk_fn(index.placement, index.mesh, mode=kind,
                                     k=k)
    out_ids, out_scores = fn(index.hot, index.cold, ids)
    return out_ids.cpu().numpy(), out_scores.cpu().numpy()


class CommandStream:
    """Rank 0's side of the serving command stream under a mesh of
    several ranks (see the module docstring). ``lock`` serializes
    everything rank 0 sends; after :meth:`close` nothing more is sent."""

    def __init__(self, mesh):
        if not _many(mesh) or mesh.rank != 0:
            raise ValueError("a command stream belongs to rank 0 of a mesh "
                             "of several ranks")
        self.mesh = mesh
        self.lock = threading.Lock()
        self.closed = False

    def _send(self, *fields: int) -> None:
        head = torch.tensor(list(fields) + [0] * (_HEADER - len(fields)),
                            dtype=torch.int64, device=self.mesh.device)
        coll.broadcast(head, self.mesh)

    def batch(self, kind: str, ids: np.ndarray, k: int,
              step: Optional[int]) -> torch.Tensor:
        """Send one batch (the caller holds ``lock`` through its top-k);
        returns the id block on the device."""
        self._send(_BATCH, MODES.index(kind), ids.shape[0], k,
                   -1 if step is None else step)
        return coll.broadcast(torch.as_tensor(ids, device=self.mesh.device)
                              .contiguous(), self.mesh)

    def stage(self, step: int, stage) -> bool:
        """Send "stage ``step``" and run ``stage(step)`` (every rank's
        load and the all-or-none decision); False once closed."""
        with self.lock:
            if self.closed:
                return False
            self._send(_STAGE, 0, 0, 0, step)
            return stage(step)

    def close(self) -> None:
        """Send "close": the followers return (idempotent)."""
        with self.lock:
            if not self.closed:
                self.closed = True
                self._send(_CLOSE)


def serve_follower(source, mesh) -> Dict[str, int]:
    """A rank other than 0 of a serving mesh: execute rank 0's commands in
    order until "close". ``source`` is this rank's
    :class:`EmbeddingIndex` (a static snapshot) or a
    :class:`~repro_torch.serve.snapshot.SnapshotWatcher` (its thread not
    started: swaps arrive as commands). Returns the batches served and the
    swaps and load failures seen."""
    if not _many(mesh) or mesh.rank == 0:
        raise ValueError("serve_follower runs on ranks 1.. of a mesh of "
                         "several ranks")
    fns: Dict = {}
    batches = 0
    while True:
        head = torch.zeros(_HEADER, dtype=torch.int64, device=mesh.device)
        op, kind, rows, k, step = coll.broadcast(head, mesh).tolist()
        if op == _CLOSE:
            break
        if op == _STAGE:
            source.stage(step)
            continue
        mode = MODES[kind]
        ids = torch.empty((rows,) if mode == "nn" else (rows, 3),
                          dtype=torch.int32, device=mesh.device)
        coll.broadcast(ids, mesh)
        index = (source if isinstance(source, EmbeddingIndex)
                 else source.current())
        if (-1 if index.step is None else index.step) != step:
            raise RuntimeError(f"rank {mesh.rank} holds step {index.step}, "
                               f"rank 0 served step {step}")
        _topk(fns, index, mode, k, ids)
        batches += 1
    return {"batches": batches, "swaps": getattr(source, "swaps", 0),
            "load_failures": getattr(source, "load_failures", 0)}


class EmbeddingServer:
    """Deadline/max-batch query coalescer over a (possibly hot-swapped)
    :class:`EmbeddingIndex`.

    Parameters
    ----------
    source : an :class:`EmbeddingIndex` (static snapshot) or anything
        with a ``current() -> EmbeddingIndex`` method (a
        :class:`~repro_torch.serve.snapshot.SnapshotWatcher` for live
        serving). Under a mesh of several ranks the server runs on rank 0
        (the other ranks run :func:`serve_follower`) and shares the
        watcher's command stream.
    batch_size : the most query rows one device call takes — also the
        per-request row cap.
    deadline_ms : max time the first request in a batch waits for
        co-riders before the batch is cut short.
    k : neighbours returned per query (fixed per server).
    """

    def __init__(self, source, batch_size: int = 32,
                 deadline_ms: float = 2.0, k: int = 5):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self._source = source
        mesh = (source.mesh if isinstance(source, EmbeddingIndex)
                else getattr(source, "mesh", None))
        self._commands = getattr(source, "commands", None)
        if self._commands is None and _many(mesh):
            self._commands = CommandStream(mesh)
        self.batch_size = int(batch_size)
        self.deadline_s = float(deadline_ms) / 1e3
        self.k = int(k)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._carry: Optional[_Request] = None
        self._fns: Dict[Tuple, object] = {}   # (placement, mode, k) -> fn
        self._closed = False
        self._lock = threading.Lock()
        self.served = 0
        self.batches = 0
        self.latencies_us: List[float] = []
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="embedding-server", daemon=True)
        self._thread.start()

    # -- public API ----------------------------------------------------------
    def current_index(self) -> EmbeddingIndex:
        """The snapshot the *next* batch would be served from."""
        if isinstance(self._source, EmbeddingIndex):
            return self._source
        return self._source.current()

    def submit(self, kind: str, ids, k: Optional[int] = None) -> _Request:
        """Enqueue a request; returns a waitable handle. ``ids`` is
        ``(n,)`` for ``kind="nn"``, ``(n, 3)`` rows ``(a, b, c)`` for
        ``kind="analogy"``; ``n <= batch_size``."""
        if kind not in MODES:
            raise ValueError(f"unknown query kind {kind!r} (nn | analogy)")
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        if kind == "analogy":
            ids = ids.reshape(-1, 3)
        n = ids.shape[0]
        if n < 1 or n > self.batch_size:
            raise ValueError(
                f"request has {n} queries; allowed 1..{self.batch_size}")
        k = self.k if k is None else int(k)
        if k > self.k:
            raise ValueError(f"k={k} exceeds server k={self.k}")
        req = _Request(kind, ids, k)
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(req)
        return req

    def neighbors(self, ids, k: Optional[int] = None,
                  timeout: float = 60.0) -> QueryResult:
        """Synchronous nearest-neighbour query for global ids ``(n,)``."""
        return self.submit("nn", ids, k=k).wait(timeout)

    def analogy(self, triples, k: Optional[int] = None,
                timeout: float = 60.0) -> QueryResult:
        """Synchronous ``a − b + c`` analogy query for rows ``(n, 3)``."""
        return self.submit("analogy", triples, k=k).wait(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting requests, answer everything already accepted,
        then stop the dispatcher — zero dropped queries by construction.
        Under a mesh it then sends "close" to the followers."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._thread.join(timeout=timeout)
        if self._commands is not None:
            self._commands.close()

    def __enter__(self) -> "EmbeddingServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher ----------------------------------------------------------
    def _take_first(self) -> Optional[_Request]:
        if self._carry is not None:
            first, self._carry = self._carry, None
            return first
        try:
            return self._queue.get(timeout=0.01)
        except queue.Empty:
            return None

    def _collect_batch(self) -> Optional[List[_Request]]:
        """Block for a first request, then co-batch same-kind arrivals
        until the row budget or the deadline runs out."""
        first = self._take_first()
        if first is None:
            return None
        batch, rows = [first], first.ids.shape[0]
        deadline = first.t0 + self.deadline_s
        while rows < self.batch_size:
            remaining = deadline - time.perf_counter()
            try:
                # past the deadline, only what has already arrived rides:
                # a backlog older than the deadline still fills the batch
                nxt = (self._queue.get(timeout=remaining) if remaining > 0
                       else self._queue.get_nowait())
            except queue.Empty:
                break
            if (nxt.kind != first.kind
                    or rows + nxt.ids.shape[0] > self.batch_size):
                self._carry = nxt          # rides the next batch
                break
            batch.append(nxt)
            rows += nxt.ids.shape[0]
        return batch

    def _serve_batch(self, batch: List[_Request]) -> None:
        kind = batch[0].kind
        ids = np.concatenate([r.ids for r in batch], axis=0)
        if self._commands is None:
            index = self.current_index()   # ONE snapshot for the batch
            out_ids, out_scores = _topk(self._fns, index, kind, self.k, ids)
        else:
            with self._commands.lock:
                index = self.current_index()
                dev_ids = self._commands.batch(kind, ids, self.k, index.step)
                out_ids, out_scores = _topk(self._fns, index, kind, self.k,
                                            dev_ids)
        now = time.perf_counter()
        self.batches += 1
        off = 0
        for r in batch:
            m = r.ids.shape[0]
            lat = (now - r.t0) * 1e6
            r.resolve(QueryResult(
                ids=out_ids[off:off + m, :r.k],
                scores=out_scores[off:off + m, :r.k],
                snapshot_step=index.step, latency_us=lat))
            off += m
            self.served += m
            self.latencies_us.append(lat)

    def _dispatch_loop(self) -> None:
        while True:
            batch = self._collect_batch()
            if batch is None:
                if self._closed and self._carry is None \
                        and self._queue.empty():
                    return                 # drained: safe to exit
                continue
            try:
                self._serve_batch(batch)
            except BaseException as e:  # noqa: BLE001 — fail the batch,
                for r in batch:             # never strand its futures
                    r.fail(e)
                log.exception("batch of %d %s queries failed",
                              len(batch), batch[0].kind)
