"""Async host batching: multi-worker finalization + bounded prefetch.

The port's counterpart of ``repro.data.prefetch``. FULL-W2V assigns
encoding, subsampling, negative pre-sampling and tile planning to the CPU
*so the host can run ahead of the device* (paper §4.1, Table 1).
:class:`AsyncBatchingPipeline` is that overlap: a producer thread walks the
deterministic encode→pack stages while a pool of workers finalizes batches
(negative sampling + ``plan_tiles`` + the vocab-sharding exchange plan —
most of the host time, GIL-releasing numpy) into a bounded in-order queue
the training loop drains.

Determinism does not come from scheduling — it comes from the keyed
randomness in ``data/batching.py``: every batch is a pure function of
``(corpus, cfg, epoch, batch_index)``, so any worker count, any executor
interleaving and the synchronous pipeline all emit bit-identical streams.
Ordering is restored by consuming futures in submission order.

Stages (DESIGN.md §4.1):

    producer thread:  encode+subsample blocks -> pack (S, L) -> submit
    worker pool:      finalize_packed (negatives, tile plan)   [xN]
    consumer:         in-order bounded queue -> training step

Backpressure: at most ``depth`` finalized-or-in-flight batches exist ahead
of the consumer (a BoundedSemaphore the consumer releases per yield).

``mode="thread"`` shares the pipeline state directly; ``mode="process"``
ships the config, alias table and placement to worker processes once at
pool start. Unlike the reference, whose pool takes the platform's default
start method (``fork`` on Linux), the process pool here always starts its
workers from a fork server: the training process has a live CUDA context
and torch's threads by the time the pool starts, and a forked copy of that
must never run. The fork server is a fresh interpreter that imports only
this module's torch-free import path (``data.batching``, ``negatives``,
``vocab``, ``distributed.vocab_placement``), and every worker is forked
from it. As with ``spawn``, each worker then imports the main script (a
script run by path, or the module of ``python -m``) as ``__mp_main__``:
the script must guard its entry point with ``if __name__ ==
"__main__":``, and what its top level imports every worker imports too,
at every pool start (``chip_smoke.py`` and ``repro_torch.launch.train``
import no torch at top level).

Self-healing (DESIGN.md §9): a *killed* process worker breaks the whole
pool (``BrokenProcessPool``) — the pipeline rebuilds the pool and
recomputes every batch the dead pool still owed. Finalization is a pure
function of ``(packed, cfg, epoch)``, so the recomputed batches are
bit-identical and the emitted stream never changes
(``PrefetchStats.heals`` counts pool rebuilds). A worker killed while it
held a lock of the pool's queues or had sent part of a result can leave the
pool's own bookkeeping waiting forever, with its futures never failing: so
a consumer waits on a future in bounded polls and heals when the pool has
lost a worker, and a heal tears the old pool down for good (its surviving
workers killed, the parent's end of its result pipe closed), so that no
thread or future is left waiting on it. A dead *producer* thread
surfaces as a :class:`PipelineFault` on the consumer within a bounded
poll interval. Task *exceptions* (the finalize function itself raising)
propagate: they are deterministic, so retrying them would fail
identically. A process pool that cannot start raises
:class:`PipelineFault`; nothing falls back to the synchronous pipeline.
"""
from __future__ import annotations

import dataclasses
import logging
import multiprocessing
import queue
import threading
from concurrent.futures import (BrokenExecutor, CancelledError, Executor,
                                Future, ProcessPoolExecutor)
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Iterator, List, Optional

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.batching import (Batch, BatchingPipeline, PackedBatch,
                                       finalize_packed)
from repro_torch.data.corpus import Corpus
from repro_torch.data.negatives import NegativeSampler
from repro_torch.data.vocab import Vocab

log = logging.getLogger("repro_torch.prefetch")

# Seconds a process pool may take to start and initialize every worker.
POOL_START_TIMEOUT_S = 300.0
# Seconds between a consumer's checks, while it waits on a batch, that the
# batch's pool has not lost a worker.
HEAL_POLL_S = 1.0

# ---------------------------------------------------------------------------
# Process-mode worker state: shipped once via the pool initializer so each
# finalize task carries only its PackedBatch, not the alias table (nor the
# vocab-sharding placement).
# ---------------------------------------------------------------------------
_WORKER_CFG: Optional[W2VConfig] = None
_WORKER_SAMPLER: Optional[NegativeSampler] = None
_WORKER_PLACEMENT = None
_WORKER_BAGS = None


def _proc_init(cfg: W2VConfig, sampler: NegativeSampler,
               placement=None, bag_table=None) -> None:
    global _WORKER_CFG, _WORKER_SAMPLER, _WORKER_PLACEMENT, _WORKER_BAGS
    _WORKER_CFG = cfg
    _WORKER_SAMPLER = sampler
    _WORKER_PLACEMENT = placement
    _WORKER_BAGS = bag_table


def _proc_ready() -> bool:
    """No-op task: submitting it forces a worker process to spawn and run
    its initializer (unpickling the cfg + alias table)."""
    return True


def _proc_finalize(packed: PackedBatch, epoch: int) -> Batch:
    return finalize_packed(packed, _WORKER_CFG, _WORKER_SAMPLER, epoch,
                           _WORKER_PLACEMENT, _WORKER_BAGS)


def _process_context():
    """The process pool's start context: a fork server, never ``fork``.
    The server preloads this module (with it the torch-free finalize
    path), so each worker forked from it starts with that imported."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    return ctx


@dataclasses.dataclass
class _EndOfEpoch:
    """Queue sentinel: the producer finished (or failed with ``error``)."""
    error: Optional[BaseException] = None


class PipelineFault(RuntimeError):
    """The host pipeline died in a way a supervisor can recover from by
    re-opening the stream (producer thread gone without its sentinel, a
    worker pool that could not be healed, or one that could not start)."""


@dataclasses.dataclass
class _Pending:
    """One submitted finalize: the input kept alongside its future so a
    broken pool can recompute the batch bit-identically."""
    packed: PackedBatch
    epoch: int
    future: Future
    gen: int        # executor generation the future was submitted to


@dataclasses.dataclass
class PrefetchStats:
    """Observability for the overlap measurements: queue depth over time
    and the backpressure high-water mark, plus the self-healing counter."""
    max_in_flight: int = 0          # most batches ever past the semaphore
    heals: int = 0                  # worker pools rebuilt after breakage
    depth_samples: List[int] = dataclasses.field(default_factory=list)

    @property
    def mean_depth(self) -> float:
        d = self.depth_samples
        return sum(d) / len(d) if d else 0.0


def _pool_parts(ex: Optional[Executor]) -> tuple:
    """A process pool's ``pid -> Process`` map and the parent's end of its
    result pipe (empty and None for a thread pool, or once the pool is shut
    down). Both are private to ``concurrent.futures``: a Python whose pool
    lacks them raises here, rather than leave a heal unable to tear its
    pool down."""
    if not isinstance(ex, ProcessPoolExecutor):
        return {}, None
    try:
        procs, results = ex._processes, ex._result_queue
        return dict(procs or {}), (None if results is None
                                   else results._writer)
    except AttributeError as e:
        raise RuntimeError(
            f"this Python's ProcessPoolExecutor lacks what a pool heal "
            f"needs ({e}); use prefetch_mode='thread'") from e


class AsyncBatchingPipeline(BatchingPipeline):
    """Drop-in :class:`BatchingPipeline` whose ``batches()`` produces ahead
    of the consumer. Bit-identical stream, overlapped wall clock.

    Parameters default to the config's ``prefetch_*`` knobs; ``workers=0``
    is coerced to 1 (an async pipeline with no workers is the sync one —
    construct :class:`BatchingPipeline` for that).
    """

    def __init__(self, corpus: Corpus, cfg: W2VConfig,
                 vocab: Optional[Vocab] = None,
                 workers: Optional[int] = None,
                 depth: Optional[int] = None,
                 mode: Optional[str] = None):
        super().__init__(corpus, cfg, vocab)
        self.workers = max(1, cfg.prefetch_workers if workers is None
                           else workers)
        self.depth = max(1, cfg.prefetch_depth if depth is None else depth)
        self.mode = mode or cfg.prefetch_mode
        if self.mode not in ("thread", "process"):
            raise ValueError(
                f"prefetch_mode must be 'thread' or 'process', "
                f"got {self.mode!r}")
        self.prefetch = PrefetchStats()
        self.ready_depth = 0   # finalized batches waiting, as of last yield
        # exposed for tests: the machinery of the most recent batches() call
        self._producer: Optional[threading.Thread] = None
        self._executor: Optional[Executor] = None
        # pool-heal state: the lock serializes executor swap + submit, the
        # generation counter tells a failed future whether its pool was
        # already replaced (resubmit) or still needs healing (rebuild)
        self._ex_lock = threading.Lock()
        self._ex_gen = 0

    # -- executor ------------------------------------------------------------
    def _make_executor(self) -> Executor:
        if self.mode == "process":
            ex = ProcessPoolExecutor(
                max_workers=self.workers, mp_context=_process_context(),
                initializer=_proc_init,
                initargs=(self.cfg, self.sampler, self.placement,
                          self.bag_table))
            _pool_parts(ex)             # a heal can tear this pool down
            return ex
        from concurrent.futures import ThreadPoolExecutor
        return ThreadPoolExecutor(max_workers=self.workers,
                                  thread_name_prefix="w2v-finalize")

    def _warm(self, ex: Executor) -> None:
        """Spawn and initialize every process worker up front, so worker
        start-up (fork from the server, unpickling the cfg + alias table)
        is setup and never lands inside the steady-state stats window.
        A pool that cannot start raises :class:`PipelineFault`. Thread
        pools have no per-worker state to warm."""
        if self.mode != "process":
            return
        try:
            futs = [ex.submit(_proc_ready) for _ in range(self.workers)]
            for f in futs:
                f.result(timeout=POOL_START_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 — no quiet fallback
            raise PipelineFault(
                f"the process pool of {self.workers} worker(s) could not "
                f"start: {e!r}") from e

    def _submit(self, ex: Executor, packed: PackedBatch,
                epoch: int) -> Future:
        if self.mode == "process":
            return ex.submit(_proc_finalize, packed, epoch)
        return ex.submit(finalize_packed, packed, self.cfg, self.sampler,
                         epoch, self.placement, self.bag_table)

    # -- pool healing --------------------------------------------------------
    def _heal_locked(self) -> None:
        """Replace a broken worker pool (caller holds ``_ex_lock``). The
        dead pool's pending finalizes are recomputed by whoever owns their
        ``_Pending`` — deterministic, so the stream stays bit-identical."""
        self._discard(self._executor)
        self._executor = self._make_executor()
        self._warm(self._executor)
        self._ex_gen += 1
        self.prefetch.heals += 1
        log.warning("worker pool died — respawned (heal #%d)",
                    self.prefetch.heals)

    @staticmethod
    def _discard(ex: Executor) -> None:
        """Tear a process pool with a dead worker down for good. A worker
        killed while it held a lock of the pool's call queue, or while it
        was sending a result, leaves the other workers blocked behind it
        and the pool's manager thread reading a message that never ends:
        its futures never fail and interpreter exit would wait for it. So
        the surviving workers are killed and the parent's end of the
        result pipe is closed; the manager thread then reads EOF, fails
        what is pending and exits. Every task of the pool is recomputed
        elsewhere, so nothing is lost."""
        procs, writer = _pool_parts(ex)
        try:
            ex.shutdown(wait=False, cancel_futures=True)
        except Exception:  # noqa: BLE001 — a broken pool may refuse even this
            pass
        for p in procs.values():
            if p.exitcode is None:
                p.kill()
        if writer is not None:
            writer.close()

    def _submit_pending(self, packed: PackedBatch, epoch: int) -> _Pending:
        """Producer-side submit that survives a dead pool: a pool with a
        worker already dead is healed before the submit (the executor's
        own detection can lag while the surviving workers keep delivering
        results, and a batch submitted into it may or may not come back
        broken); a submit that still meets a broken pool heals and retries
        once (a fresh pool that breaks immediately is a real fault)."""
        with self._ex_lock:
            if self._lost_worker():
                self._heal_locked()
            try:
                fut = self._submit(self._executor, packed, epoch)
            except BrokenExecutor:
                self._heal_locked()
                fut = self._submit(self._executor, packed, epoch)
            return _Pending(packed, epoch, fut, self._ex_gen)

    def _result_healing(self, pend: _Pending) -> Batch:
        """Consumer-side result that survives a dead pool: on breakage,
        heal (unless another thread already did) and recompute this batch
        on the fresh pool. The wait polls every ``HEAL_POLL_S``: a pool
        that lost a worker may never fail the future (see :meth:`_discard`),
        so a poll that finds the batch's pool replaced or short of a worker
        recomputes it too. Task exceptions propagate — deterministic inputs
        would just fail again."""
        retries = 0
        while True:
            try:
                return pend.future.result(timeout=HEAL_POLL_S)
            except FutureTimeout:
                with self._ex_lock:
                    if pend.gen == self._ex_gen and not self._lost_worker():
                        continue           # still computing on a whole pool
                err: BaseException = PipelineFault(
                    "the batch's worker pool lost a worker")
            except (BrokenExecutor, CancelledError) as e:
                err = e
            retries += 1
            if retries > self.workers + 2:
                raise PipelineFault(
                    f"worker pool kept dying ({retries} heals for one "
                    f"batch)") from err
            with self._ex_lock:
                if pend.gen == self._ex_gen:
                    self._heal_locked()
                pend.future = self._submit(self._executor, pend.packed,
                                           pend.epoch)
                pend.gen = self._ex_gen

    def _workers(self) -> dict:
        """The process pool's ``pid -> Process`` map (empty for threads)."""
        return _pool_parts(self._executor)[0]

    def _lost_worker(self) -> bool:
        """Whether a worker of the current process pool has exited (no
        worker exits on its own while the pool is in use)."""
        return any(p.exitcode is not None for p in self._workers().values())

    def worker_pids(self) -> List[int]:
        """Live process-pool worker pids (empty for thread mode) — the
        chaos harness's kill target (``train.chaos``)."""
        return [pid for pid, p in self._workers().items()
                if p.exitcode is None]

    # -- the async stream ----------------------------------------------------
    def batches(self, pad_len: Optional[int] = None,
                epoch: Optional[int] = None,
                skip_batches: int = 0) -> Iterator[Batch]:
        """Same contract (and same bits) as the synchronous ``batches()``;
        production runs ahead on the worker pool, bounded by ``depth``.
        Starting the pool and the producer is the span ``w2v.epoch.open``,
        the ``finally`` that stops them ``w2v.epoch.close``; the producer's
        wait for a free slot is ``w2v.backpressure``."""
        epoch = self._resolve_epoch(epoch)
        spans = self.spans
        slots = threading.BoundedSemaphore(self.depth)
        out: "queue.Queue[object]" = queue.Queue()
        stop = threading.Event()
        in_flight = [0]              # guarded by lock, for the high-water mark
        lock = threading.Lock()

        def produce() -> None:
            try:
                for packed in self._packed(pad_len, epoch):
                    if packed.index < skip_batches:
                        continue
                    with spans.span("w2v.backpressure", packed):
                        while not slots.acquire(timeout=0.05):
                            if stop.is_set():
                                return
                    if stop.is_set():
                        return
                    with lock:
                        in_flight[0] += 1
                        self.prefetch.max_in_flight = max(
                            self.prefetch.max_in_flight, in_flight[0])
                    out.put(self._submit_pending(packed, epoch))
                out.put(_EndOfEpoch())
            except BaseException as e:  # noqa: BLE001 — relayed to consumer
                out.put(_EndOfEpoch(error=e))

        producer = threading.Thread(target=produce, name="w2v-producer",
                                    daemon=True)
        with spans.span("w2v.epoch.open"):
            self._executor = self._make_executor()
            self._warm(self._executor)  # worker spawn/init is setup
            self._producer = producer
            producer.start()
        try:
            while True:
                try:
                    item = out.get(timeout=1.0)
                except queue.Empty:
                    # bounded poll: a producer that died *between* queue
                    # puts must surface as a recoverable fault, not a hang
                    if not producer.is_alive():
                        raise PipelineFault(
                            "producer thread died without delivering "
                            "end-of-epoch")
                    continue
                if isinstance(item, _EndOfEpoch):
                    if item.error is not None:
                        raise item.error
                    return
                batch = self._result_healing(item)
                with lock:
                    in_flight[0] -= 1
                self.ready_depth = self._ready_depth(out)
                slots.release()
                self.prefetch.depth_samples.append(self.ready_depth)
                self._took(batch)
                yield batch
        finally:
            with spans.span("w2v.epoch.close"):
                stop.set()
                # drain queued work so shutdown never deadlocks on
                # cancelled-but-queued tasks
                while True:
                    try:
                        item = out.get_nowait()
                    except queue.Empty:
                        break
                    if isinstance(item, _Pending):
                        item.future.cancel()
                producer.join(timeout=10.0)
                # self._executor, not a local: healing may have replaced
                # it; a pool that lost a worker since may never finish
                # shutting down
                if self._lost_worker():
                    self._discard(self._executor)
                else:
                    self._executor.shutdown(wait=True, cancel_futures=True)

    @staticmethod
    def _ready_depth(out: "queue.Queue[object]") -> int:
        """Finalized batches sitting ready ahead of the consumer."""
        with out.mutex:
            return sum(1 for p in out.queue
                       if isinstance(p, _Pending) and p.future.done())


def make_pipeline(corpus: Corpus, cfg: W2VConfig,
                  vocab: Optional[Vocab] = None) -> BatchingPipeline:
    """The config-selected pipeline: async when ``cfg.prefetch_workers > 0``,
    synchronous otherwise. The single construction point the CLI and
    ``chip_smoke.py`` share."""
    if cfg.prefetch_workers > 0:
        return AsyncBatchingPipeline(corpus, cfg, vocab)
    return BatchingPipeline(corpus, cfg, vocab)
