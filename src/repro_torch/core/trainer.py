"""W2V training sessions: streaming steps, LR decay, checkpoint/resume,
supervised recovery, metrics callbacks.

The port's counterpart of ``repro.core.trainer``. :class:`TrainSession`
owns everything around the kernel: the classic linear LR schedule, the
batch stream with its host-to-device double buffer, periodic checkpoints
with exact resume (``repro_torch.train.checkpoint``), supervised recovery
(``train_resilient``, ``repro_torch.train.supervisor``) and per-step
metrics. The kernel is reached only through the engine API
(``kernels.ops.step`` / ``kernels.registry``); the backend is resolved
once at construction against the session's device, so invalid
combinations — unknown backend, a CUDA kernel on the CPU — fail fast.

The session runs on the GPU unless the caller passes ``device="cpu"``:
with ``device=None`` and no GPU it raises rather than quietly running the
plain versions on the CPU. ``cfg.vocab_shard`` splits the tables into a
replicated hot head and a cold tail striped over the shards (DESIGN.md
§8), with the row exchange planned per batch by ``repro_torch.distributed
.vocab_placement``. ``cfg.tables`` stores the tables below f32
(DESIGN.md §11): a bf16 head, a bf16 or int8 cold tail with per-row
scales; each step carries its batch's rounding key, so stochastic storage
rounding replays bit for bit at any worker count and through a resume.

A ``mesh`` (``repro_torch.launch.mesh.DataMesh``: one rank of a
``torch.distributed`` group, one process per rank) trains data-parallel:
every rank builds the same keyed batches, takes its block of sentences,
updates its replica and averages it with the others' (Hogwild, the
paper's multi-GPU design); with ``cfg.vocab_shard`` the cold tail is
striped over the ranks, one shard each, and rank r holds stripe r.
Checkpoints keep the reference's layout (rank 0 writes the gathered
tables), and :meth:`TrainSession.embeddings` of a sharded session is a
collective every rank calls.

The kernels update the tables in place (the reference reassigns them), so
a checkpoint copies them to the host with a blocking ``.cpu()`` on the
compute stream, after batch k's kernel and before batch k+1's; a restore
replaces the tables with new tensors, never aliases them.
"""
from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.batching import Batch, BatchingPipeline
from repro_torch.kernels import ops, quant, registry
from repro_torch.kernels import tables as tables_mod
from repro_torch.kernels.registry import StepInputs
from repro_torch.kernels.tables import Tables, TableSpec
from repro_torch.launch.mesh import DataMesh

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainState:
    """Training state: tables (updated in place by every step) + progress
    counters.

    Replicated sessions hold the full ``(V, d)`` tables in ``w_in`` /
    ``w_out``. Vocab-sharded sessions hold the replicated hot head there
    instead, plus the striped cold tail in ``cold_in`` / ``cold_out``
    (``(cold_pad, d)``, DESIGN.md §8). Tables live in their storage
    dtypes (``TableSpec``): an int8 cold tail carries its per-row f32
    scales in ``scale_in`` / ``scale_out``."""
    w_in: torch.Tensor
    w_out: torch.Tensor
    words_seen: int = 0
    batches_seen: int = 0
    epoch: int = 0
    epoch_batch: int = 0   # batches completed within the current epoch
    cold_in: Optional[torch.Tensor] = None    # vocab-sharded cold tail
    cold_out: Optional[torch.Tensor] = None
    scale_in: Optional[torch.Tensor] = None   # int8 per-row scales (cold)
    scale_out: Optional[torch.Tensor] = None

    def params(self) -> Dict[str, torch.Tensor]:
        """The table dict, named as the reference's ``TrainState.params``
        (split names when vocab-sharded; an int8 cold tail adds its scale
        leaves)."""
        if self.cold_in is not None:
            out = {"hot_in": self.w_in, "hot_out": self.w_out,
                   "cold_in": self.cold_in, "cold_out": self.cold_out}
            if self.scale_in is not None:
                out["scale_in"] = self.scale_in
                out["scale_out"] = self.scale_out
            return out
        return {"w_in": self.w_in, "w_out": self.w_out}


@dataclasses.dataclass
class StepMetrics:
    """Per-batch metrics yielded by :meth:`TrainSession.stream`.

    ``fetch_seconds`` is the time the step loop spent blocked waiting for
    this batch from the host pipeline (its host-side copy into pinned
    buffers included). ``queue_depth`` is an async pipeline's ready-batch
    depth when this batch was taken (-1 for the synchronous pipeline).
    ``skipped`` marks a poison batch the supervisor excised (counters
    advanced, tables untouched — DESIGN.md §9)."""
    epoch: int
    batches_seen: int
    words_seen: int
    batch_words: int
    lr: float
    backend: str
    fetch_seconds: float = 0.0
    queue_depth: int = -1
    skipped: bool = False


def resolve_device(device) -> torch.device:
    """The session device: ``None`` means the GPU, and raises when there is
    none — the CPU runs only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain torch versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available")
    return device


def init_state(vocab_size: int, cfg: W2VConfig, seed: int = 0,
               device=None, placement=None,
               spec: Optional[TableSpec] = None, mesh=None) -> TrainState:
    """Mikolov init: w_in ~ U(-0.5/d, 0.5/d), w_out = 0, drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (the same tables on every
    device; different numbers from the reference's ``jax.random`` — use
    ``repro_torch.convert.params_from_reference`` to start from the
    reference's tables).

    ``device`` resolves as a session's does (:func:`resolve_device`):
    ``None`` puts the tables on the GPU and raises without one; the CPU
    takes them only when asked for by name.

    With a ``placement`` (vocab sharding) the *same* full-table init is
    drawn and then split hot/cold, so a sharded session starts from
    exactly the tables a replicated one would; under a ``mesh`` every
    rank draws it and keeps its stripe of the cold tail (the reference's
    ``_cold_put``). Sub-f32 storage dtypes in ``spec`` encode the init
    round-to-nearest; ``w_out = 0`` is exact in every storage dtype."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = cfg.dim
    w_in = (torch.rand((vocab_size, d), generator=gen,
                       dtype=torch.float32) - 0.5) / d
    w_out = torch.zeros((vocab_size, d), dtype=torch.float32)
    return _encoded_state(w_in.numpy(), w_out.numpy(), device, placement,
                          spec or TableSpec(vocab_shard=placement is not None),
                          mesh)


def _stripe(placement, mesh) -> slice:
    """This rank's rows of the shard-major cold tail ``(cold_pad, ...)``
    (every row without a mesh)."""
    if mesh is None:
        return slice(0, placement.cold_pad)
    cps = placement.cold_per_shard
    return slice(mesh.rank * cps, (mesh.rank + 1) * cps)


def _encoded_state(full_in: np.ndarray, full_out: np.ndarray, device,
                   placement, spec: TableSpec, mesh=None) -> TrainState:
    """A state holding the f32 full tables ``(V, d)`` split through
    ``placement`` (when given; this rank's stripe of the cold tail) and
    encoded round-to-nearest into ``spec``'s storage dtypes, as new
    tensors on ``device``: the seam that init and cross-format restores
    share."""
    def enc(a: np.ndarray, dtype: str):
        payload, scale = quant.encode_nearest(torch.from_numpy(a), dtype)
        return (payload.to(device, copy=True),
                None if scale is None else scale.to(device))

    if placement is None:
        return TrainState(w_in=enc(full_in, spec.hot_dtype)[0],
                          w_out=enc(full_out, spec.hot_dtype)[0])
    (hot_in, cold_in), (hot_out, cold_out) = (
        placement.split(t) for t in (full_in, full_out))
    rows = _stripe(placement, mesh)
    c_in, s_in = enc(cold_in[rows], spec.cold_dtype)
    c_out, s_out = enc(cold_out[rows], spec.cold_dtype)
    return TrainState(w_in=enc(hot_in, spec.hot_dtype)[0],
                      w_out=enc(hot_out, spec.hot_dtype)[0],
                      cold_in=c_in, cold_out=c_out, scale_in=s_in,
                      scale_out=s_out)


class _PinnedLift:
    """The host-to-device double buffer of the session's step loop.

    Batch k+1's arrays are copied into pinned host buffers and from there
    to the device ``non_blocking`` on a side CUDA stream, while batch k's
    kernel runs on the compute stream; the compute stream then waits on an
    event recorded after the copies, so kernel k+1 (launched later on it)
    starts only once its inputs have landed. No host sync is involved.

    Pinned buffers come in :attr:`SLOTS` sets, one per step in flight (the
    one computing, the one uploading). After each step the trainer calls
    :meth:`ended`, which records an event on the compute stream in the
    slot of the latest lift; a set is rewritten only after that event has
    passed. The step has then ended, and with it the copies that read the
    set (the compute stream waited on them). The same wait bounds the
    steps in flight on the device to :attr:`SLOTS`: without it a host that
    prepares batches faster than the kernel runs them would queue
    launches, and their inputs in device memory, without limit; with it
    the host waits on the device and the prefetch workers fill their queue
    instead. The device tensors are allocated on the side stream and used
    on the compute stream, so each is ``record_stream``-ed there: the
    caching allocator does not hand its memory out again before the kernel
    that reads it has ended.
    """
    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device=device)
        self._bufs: List[List[torch.Tensor]] = [[] for _ in
                                                range(self.SLOTS)]
        self._ended: List[Optional[torch.cuda.Event]] = [None] * self.SLOTS
        self._slot = self.SLOTS - 1      # the slot of the latest lift

    def ended(self) -> None:
        """After a step (launched or skipped): mark its end on the compute
        stream, in the slot its inputs were lifted into."""
        end = torch.cuda.Event()
        end.record(torch.cuda.current_stream(self.device))
        self._ended[self._slot] = end

    def __call__(self, build: Callable) -> StepInputs:
        """``build(put)`` -> StepInputs, with ``put`` lifting each numpy
        array through the next slot's pinned buffers."""
        self._slot = slot = (self._slot + 1) % self.SLOTS
        if self._ended[slot] is not None:
            self._ended[slot].synchronize()
        bufs = self._bufs[slot]
        order = itertools.count()
        compute = torch.cuda.current_stream(self.device)

        def put(a: np.ndarray) -> torch.Tensor:
            a = np.ascontiguousarray(a)
            dtype = torch.from_numpy(a[:0]).dtype
            i = next(order)
            if i == len(bufs):
                bufs.append(torch.empty(0, dtype=torch.uint8))
            if bufs[i].numel() < a.nbytes:
                bufs[i] = torch.empty(a.nbytes, dtype=torch.uint8,
                                      pin_memory=True)
            host = bufs[i][:a.nbytes].view(dtype).view(a.shape)
            np.copyto(host.numpy(), a)
            with torch.cuda.stream(self.stream):
                dev = torch.empty(a.shape, dtype=dtype, device=self.device)
                dev.copy_(host, non_blocking=True)
            dev.record_stream(compute)
            return dev

        step = build(put)
        copied = torch.cuda.Event()
        copied.record(self.stream)
        compute.wait_event(copied)
        return step


class TrainSession:
    """A streaming W2V training session over a batching pipeline.

    Parameters
    ----------
    backend : registry name or ``"auto"``, resolved once at construction
        against ``device`` (``cfg.tile_windows > 1`` selects the
        window-tiled family).
    device : ``None`` (the mesh's device, else the GPU; raises without
        one), ``"cuda"``, ``"cuda:N"`` or ``"cpu"``.
    mesh : a ``repro_torch.launch.mesh.DataMesh`` for Hogwild data
        parallelism (one session per rank, every rank constructing it);
        with ``cfg.vocab_shard`` its ranks are the vocab shards. A
        ``shards=N`` storage spec needs a mesh of N ranks (no mesh: one).
    ckpt_dir / ckpt_every : when set, checkpoint every N batches (atomic,
        pruned) and — unless ``resume=False`` — restore the latest
        checkpoint at construction, continuing words/batches/epoch counts
        and the pipeline's position.
    exchange : overrides the spec's vocab-sharding exchange: ``"exact"``
        (request-exact buckets, the default) or ``"dense"`` (the
        all_gather + psum_scatter reference path).
    on_batch / on_metrics : callbacks after every trained batch, receiving
        the :class:`TrainState` / :class:`StepMetrics` respectively.
    """

    def __init__(
        self,
        pipeline: BatchingPipeline,
        cfg: W2VConfig,
        backend: str = "auto",
        device=None,
        mesh=None,
        on_batch: Optional[Callable[[TrainState], None]] = None,
        on_metrics: Optional[Callable[[StepMetrics], None]] = None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0,
        resume: bool = True,
        exchange: Optional[str] = None,
    ):
        if mesh is not None and not isinstance(mesh, DataMesh):
            raise TypeError(f"mesh must be a repro_torch.launch.mesh."
                            f"DataMesh, got {type(mesh).__name__}")
        self.mesh = mesh
        self.pipeline = pipeline
        self.cfg = cfg
        self.device = resolve_device(device if mesh is None
                                     else mesh.device)
        if mesh is not None and device is not None:
            want = torch.device(device)
            if want.type != self.device.type or want.index not in (
                    None, self.device.index):
                raise ValueError(f"device {want} differs from the mesh "
                                 f"rank's device {self.device}")
        ranks = 1 if mesh is None else mesh.size
        spec = tables_mod.from_config(cfg)
        if exchange is not None:
            spec = dataclasses.replace(spec, exchange=exchange)
        if spec.shards and spec.shards != ranks:
            raise ValueError(
                f"the storage spec asks for shards={spec.shards} but the "
                f"session runs {ranks} rank{'s' if ranks > 1 else ''} "
                f"({'no mesh' if mesh is None else 'its mesh'}); one vocab "
                f"shard per rank: pass a mesh of {spec.shards} ranks "
                f"(repro_torch.launch.mesh.start_ranks)")
        self.spec = spec
        self.exchange = spec.exchange
        # the requested name is kept for dispatch so batches without a plan
        # resolve their sequential variant
        self._requested_backend = backend
        self.backend = registry.resolve(
            backend, tiled=cfg.tile_windows > 1,
            vocab_shard=self.spec.vocab_shard,
            dtypes=() if self.spec.master_copy else self.spec.dtypes,
            frontends=getattr(pipeline, "frontend_features", ()),
            platform=self.device.type).name
        if mesh is not None and not registry.get(self.backend).supports_mesh:
            raise ValueError(
                f"backend {self.backend!r} does not support mesh sharding")
        self.on_batch = on_batch
        self.on_metrics = on_metrics
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        # the trainable table covers the vocabulary plus any frontend
        # extras (doc rows, n-gram buckets — DESIGN.md §12); extras carry
        # zero counts so placement planning stripes them into the cold tail
        table_rows = getattr(pipeline, "table_rows", pipeline.vocab.size)
        self.placement = None
        if self.spec.vocab_shard:
            from repro_torch.distributed.vocab_placement import \
                VocabPlacement
            counts = (pipeline.table_counts()
                      if hasattr(pipeline, "table_counts")
                      else pipeline.vocab.counts)
            # one shard per rank
            self.placement = VocabPlacement.plan(counts, ranks,
                                                 hot_frac=self.spec.hot_frac)
            # the pipeline plans each batch's exchange as it finalizes it
            # (Batch.exchange); _make_step plans inline for batches without
            pipeline.placement = self.placement
        self.state = init_state(table_rows, cfg, cfg.seed, self.device,
                                placement=self.placement, spec=self.spec,
                                mesh=mesh)
        self._tables().check_runnable()
        self.total_words = max(1, pipeline.epoch_words * cfg.epochs)
        self.words_per_sec = 0.0
        self.fetch_seconds = 0.0   # cumulative wait on the host pipeline
        self.wall_seconds = 0.0    # last train() wall time
        self._lift = (_PinnedLift(self.device)
                      if self.device.type == "cuda" else None)
        self.resumed_step: Optional[int] = None
        self._resume_skip = 0
        # poison-batch excision (DESIGN.md §9): stream positions the
        # supervisor decided to skip after a health rollback. Counters
        # still advance (LR schedule + pipeline cursor unchanged); only
        # the table update is excised. Skips are counted, never silent.
        self.poison_skip: Set[Tuple[int, int]] = set()
        self.batches_skipped = 0
        self.last_report = None    # the last train_resilient()'s report
        if ckpt_dir and resume:
            self._maybe_resume()

    # -- learning-rate schedule (classic linear decay) ----------------------
    def _lr_at(self, words_seen: int) -> float:
        frac = 1.0 - words_seen / self.total_words
        return self.cfg.lr * max(frac, self.cfg.min_lr_frac)

    def current_lr(self) -> float:
        return self._lr_at(self.state.words_seen)

    def _tables(self) -> Tables:
        st = self.state
        return Tables(w_in=st.w_in, w_out=st.w_out, cold_in=st.cold_in,
                      cold_out=st.cold_out, scale_in=st.scale_in,
                      scale_out=st.scale_out, spec=self.spec,
                      placement=self.placement)

    def _make_step(self, batch: Batch, lr, put=None) -> StepInputs:
        """Device StepInputs for a batch: the vocab-sharded exchange plan
        when the session shards the vocabulary (``batch.exchange`` from a
        placement-aware pipeline, else planned here), the plain lift
        otherwise. ``put`` replaces the blocking copy of each array. With
        sub-f32 storage the step also carries the batch's rounding key, a
        pure function of (seed, epoch, batch index) computed on the
        host."""
        if self.placement is None:
            step = batch.step_inputs(lr, self.device, put=put, mesh=self.mesh)
        else:
            ex = getattr(batch, "exchange", None)
            if ex is None or ex.placement != self.placement:
                from repro_torch.distributed.vocab_placement import \
                    plan_exchange
                ex = plan_exchange(batch, self.placement)
            step = ex.step_inputs(lr, self.device, put=put, mesh=self.mesh)
        if self.spec.is_mixed:
            step.round_key = quant.round_key(self.cfg.seed, batch.epoch,
                                             batch.index)
        return step

    def synchronize(self) -> None:
        """Wait for the session's device work to finish (no-op on CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- train ---------------------------------------------------------------
    def train_batch(self, batch: Batch,
                    step: Optional[StepInputs] = None,
                    fetch_seconds: float = 0.0) -> StepMetrics:
        """Train one batch. ``step`` may be a pre-built :class:`StepInputs`
        from :meth:`stream`; its lr was computed from the projected word
        count, which equals ``current_lr()`` exactly because word counts
        are known host-side ahead of training."""
        lr = self.current_lr()
        skipped = ((self.state.epoch, self.state.epoch_batch)
                   in self.poison_skip)
        if skipped:
            self.batches_skipped += 1
            log.warning(
                "skipping poison batch (epoch %d, batch %d) — counters "
                "advance, tables untouched (%d skipped so far)",
                self.state.epoch, self.state.epoch_batch,
                self.batches_skipped)
        elif step is None or (self.placement is not None
                              and not step.has_vocab_shard):
            # a plain pre-built step carries global ids; the sharded path
            # needs the exchange plan, so rebuild it from the host batch
            step = self._make_step(batch, lr)
        if not skipped:
            ops.step(self._tables(), step, self.cfg,
                     backend=self._requested_backend, mesh=self.mesh)
        if self._lift is not None:
            self._lift.ended()
        self.state.words_seen += batch.n_words
        self.state.batches_seen += 1
        self.state.epoch_batch += 1
        self.fetch_seconds += fetch_seconds
        metrics = StepMetrics(
            epoch=self.state.epoch, batches_seen=self.state.batches_seen,
            words_seen=self.state.words_seen, batch_words=batch.n_words,
            lr=lr, backend=self.backend, fetch_seconds=fetch_seconds,
            queue_depth=getattr(self.pipeline, "ready_depth", -1),
            skipped=skipped)
        if (self.ckpt_dir and self.ckpt_every
                and self.state.batches_seen % self.ckpt_every == 0):
            self.save_checkpoint()
        if self.on_batch is not None:
            self.on_batch(self.state)
        if self.on_metrics is not None:
            self.on_metrics(metrics)
        return metrics

    def _prepared(self, batch_iter: Iterator[Batch]) -> Iterator[tuple]:
        """Lift host batches onto the device one step ahead: batch k+1's
        StepInputs are built while batch k's kernel still runs (kernel
        launches return before the device finishes). On the GPU the copies
        go through :class:`_PinnedLift` (pinned buffers, a side stream, an
        event the compute stream waits on); on the CPU they are plain tensors. lr
        for batch k+1 is exact — it depends only on cumulative host-side
        word counts."""
        projected = self.state.words_seen
        try:
            for batch in batch_iter:
                lr = self._lr_at(projected)
                if self._lift is None:
                    step = self._make_step(batch, lr)
                else:
                    step = self._lift(
                        lambda put: self._make_step(batch, lr, put))
                projected += batch.n_words
                yield batch, step
        finally:
            close = getattr(batch_iter, "close", None)
            if close is not None:
                close()

    def stream(self, epochs: Optional[int] = None,
               max_batches: Optional[int] = None) -> Iterator[StepMetrics]:
        """Stream the session: train batch by batch, yielding metrics after
        each. Resumed sessions continue from the checkpointed position —
        randomness is keyed by (epoch, batch index), so the pipeline's
        ``skip_batches`` fast-forward reproduces the exact remainder of the
        interrupted epoch without re-finalizing (or re-counting) anything.

        With an async pipeline the loop overlaps three things: the workers
        finalize batches k+2.., batch k+1's copies run on the side stream
        and batch k's kernel runs on the compute stream."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        pad_len = self.cfg.resolved_pad_len
        n_batches = 0
        skip = self._resume_skip  # >0 only right after a mid-epoch restore
        self._resume_skip = 0
        for ep in range(min(self.state.epoch, epochs), epochs):
            self.state.epoch = ep
            if not skip:
                self.state.epoch_batch = 0
            it = self.pipeline.batches(pad_len=pad_len, epoch=ep,
                                       skip_batches=skip)
            skip = 0
            prepared = self._prepared(it)
            try:
                t0 = time.perf_counter()
                cur = next(prepared, None)
                wait = time.perf_counter() - t0
                while cur is not None:
                    batch, step = cur
                    metrics = self.train_batch(batch, step=step,
                                               fetch_seconds=wait)
                    n_batches += 1
                    if max_batches is not None and n_batches >= max_batches:
                        yield metrics
                        return
                    # pull batch k+1 before yielding: the step just launched
                    # is still running on the device
                    t0 = time.perf_counter()
                    cur = next(prepared, None)
                    wait = time.perf_counter() - t0
                    yield metrics
            finally:
                prepared.close()

    def train(self, epochs: Optional[int] = None,
              max_batches: Optional[int] = None) -> TrainState:
        """Drain :meth:`stream` to completion; returns the final state."""
        words0 = self.state.words_seen
        self.fetch_seconds = 0.0
        t0 = time.perf_counter()
        for _ in self.stream(epochs=epochs, max_batches=max_batches):
            pass
        self.synchronize()
        self._timed(words0, time.perf_counter() - t0)
        return self.state

    def train_resilient(self, **kwargs) -> TrainState:
        """Drive :meth:`stream` under the recovery supervisor: restore +
        replay on step failure, health-probe rollback, watchdog timeouts,
        restart budget with refill (``repro_torch.train.supervisor``,
        DESIGN.md §9). Keyword arguments go to :class:`TrainSupervisor`;
        its :class:`SupervisorReport` lands on ``self.last_report``. Under
        a mesh every rank calls it with the same arguments: the ranks
        vote on every batch's outcome and take each rollback together,
        and every rank's report (its times its own) lands there."""
        from repro_torch.train.supervisor import TrainSupervisor
        sup = TrainSupervisor(self, **kwargs)
        words0 = self.state.words_seen
        self.fetch_seconds = 0.0
        t0 = time.perf_counter()
        try:
            state = sup.run()
        finally:
            self.last_report = sup.report
        self.synchronize()
        self._timed(words0, time.perf_counter() - t0)
        return state

    def _timed(self, words0: int, dt: float) -> None:
        self.wall_seconds = dt
        self.words_per_sec = ((self.state.words_seen - words0) / dt
                              if dt else 0.0)

    @property
    def device_busy_frac(self) -> float:
        """Fraction of the last ``train()`` wall time NOT spent blocked on
        the host pipeline."""
        if not self.wall_seconds:
            return 0.0
        return max(0.0, 1.0 - self.fetch_seconds / self.wall_seconds)

    # -- checkpoint / resume --------------------------------------------------
    def _split_across_ranks(self) -> bool:
        return (self.placement is not None and self.mesh is not None
                and self.mesh.size > 1)

    def gathered_params(self) -> Dict[str, torch.Tensor]:
        """:meth:`TrainState.params` in the reference's layout: a
        vocab-sharded session's cold tail (and int8 scales) all-gathered
        into the shard-major ``(cold_pad, ...)`` tables, in storage
        dtypes. A collective every rank of a sharded mesh calls; the
        state's own tensors otherwise (the replicas of a data-parallel
        mesh are equal)."""
        params = self.state.params()
        if not self._split_across_ranks():
            return params
        from repro_torch.distributed import collectives as coll
        return {k: (coll.all_gather(v, self.mesh).reshape(-1, *v.shape[1:])
                    if k.startswith(("cold", "scale")) else v)
                for k, v in params.items()}

    def save_checkpoint(self) -> str:
        """Atomically checkpoint tables + progress counters + the host
        pipeline cursor (exact mid-epoch resume, prefetch or not). The
        tables' device-to-host copy blocks on the compute stream, so it
        sees every kernel launched so far and no later one. Under a mesh
        every rank calls it: rank 0 writes the gathered tables
        (:meth:`gathered_params`) and the ranks leave together."""
        from repro_torch.train import checkpoint as ckpt
        assert self.ckpt_dir, "TrainSession has no ckpt_dir"
        cursor = ckpt.PipelineCursor(
            epoch=self.state.epoch, epoch_batch=self.state.epoch_batch,
            prefetch_workers=self.cfg.prefetch_workers)
        extra = {"words_seen": self.state.words_seen,
                 "batches_seen": self.state.batches_seen,
                 "backend": self.backend, "tables": self.spec.to_extra(),
                 **cursor.to_extra()}
        if self.placement is not None:
            extra["vocab_shard"] = self.placement.to_extra()
        params = self.gathered_params()
        path = os.path.join(self.ckpt_dir,
                            f"step_{self.state.batches_seen:08d}")
        if self.mesh is None or self.mesh.rank == 0:
            path = ckpt.save(self.ckpt_dir, self.state.batches_seen, params,
                             extra=extra)
        if self.mesh is not None:
            self.mesh.barrier()
        return path

    def _full_like(self) -> Dict:
        """The checkpoint leaves this session writes: its tables' shapes
        in the gathered layout, storage dtype names."""
        from repro_torch.train import checkpoint as ckpt
        out = {}
        for k, v in self.state.params().items():
            shape = tuple(v.shape)
            if k.startswith(("cold", "scale")):
                shape = (self.placement.cold_pad, *shape[1:])
            out[k] = ckpt.ArraySpec(shape,
                                    str(v.dtype).removeprefix("torch."))
        return out

    def _restore_tables(self, step: int) -> Dict:
        """Restore embedding tables across table *formats*: split-table
        (vocab-sharded, any shard count) vs replicated, and any
        storage-dtype mix — a mixed-precision checkpoint restores into an
        f32 session and back. Same-format restores (same leaf set, shapes
        and dtypes, and for split tables the same placement, compared
        exactly) load the tables as stored, keeping their exact bytes.
        Cross-format restores decode the writing run's storage to the full
        f32 tables (through its placement and TableSpec, both recorded in
        the checkpoint) and re-encode them round-to-nearest through this
        session's, never copying raw rows between shard counts. A rank of
        a sharded mesh keeps its stripe of the cold tail. Every restored
        table is a new tensor on the session's device."""
        from repro_torch.distributed.vocab_placement import VocabPlacement
        from repro_torch.train import checkpoint as ckpt
        leaves, extra = ckpt.peek(self.ckpt_dir, step=step)
        split_ckpt = "hot_in" in leaves
        like_now = self._full_like()
        same_format = set(leaves) == set(like_now) and all(
            tuple(leaves[k]["shape"]) == like_now[k].shape
            and leaves[k]["dtype"] == like_now[k].dtype for k in like_now)
        if same_format and split_ckpt:
            # shapes alone can coincide across shard counts (equal
            # cold_pad, different stripe order) — the placements must
            # match exactly or the cold rows land on the wrong shards
            meta = extra.get("vocab_shard")
            same_format = (self.placement is not None and meta is not None
                           and VocabPlacement.from_extra(meta)
                           == self.placement)
        st = self.state
        if same_format:
            tree, extra = ckpt.restore(self.ckpt_dir, like_now, step=step)
            if self.placement is None:
                st.w_in, st.w_out = (self._put(tree[k], None)
                                     for k in ("w_in", "w_out"))
                return extra
            rows = _stripe(self.placement, self.mesh)
            st.w_in, st.w_out = (self._put(tree[k], None)
                                 for k in ("hot_in", "hot_out"))
            st.cold_in, st.cold_out, st.scale_in, st.scale_out = (
                self._put(tree.get(k), rows)
                for k in ("cold_in", "cold_out", "scale_in", "scale_out"))
            return extra
        like_ckpt = {k: ckpt.ArraySpec(tuple(m["shape"]), m["dtype"])
                     for k, m in leaves.items()}
        host, extra = ckpt.restore(self.ckpt_dir, like_ckpt, step=step)
        src_spec = TableSpec.from_extra(extra.get("tables", {}))

        def dec(name: str, dtype: str, sname: Optional[str] = None
                ) -> np.ndarray:
            scale = None if sname is None else torch.as_tensor(host[sname])
            return quant.decode(torch.as_tensor(host[name]), scale,
                                dtype).numpy()

        if split_ckpt:
            src = VocabPlacement.from_extra(extra["vocab_shard"])
            int8 = src_spec.cold_dtype == "int8"
            full_in, full_out = (src.merge(
                dec(f"hot_{side}", src_spec.hot_dtype),
                dec(f"cold_{side}", src_spec.cold_dtype,
                    f"scale_{side}" if int8 else None))
                for side in ("in", "out"))
        else:
            full_in, full_out = (dec(k, src_spec.hot_dtype)
                                 for k in ("w_in", "w_out"))
        # restoring through like_ckpt skipped restore()'s shape check
        # against this session — validate before training reads rows
        v_expect = (self.placement.vocab_size if self.placement is not None
                    else int(st.w_in.shape[0]))
        want = (v_expect, self.cfg.dim)
        if full_in.shape != want:
            raise ValueError(
                f"checkpoint tables are {full_in.shape}, session expects "
                f"{want} (vocabulary or dim mismatch — wrong ckpt_dir?)")
        new = _encoded_state(full_in, full_out, self.device, self.placement,
                             self.spec, self.mesh)
        for name in ("w_in", "w_out", "cold_in", "cold_out", "scale_in",
                     "scale_out"):
            setattr(st, name, getattr(new, name))
        return extra

    def _put(self, leaf, rows: Optional[slice]) -> Optional[torch.Tensor]:
        """A restored host leaf (numpy, or a bf16 torch tensor) as a new
        tensor on the session's device; ``rows``: only those rows."""
        if leaf is None:
            return None
        if rows is not None:
            leaf = leaf[rows]
        return torch.as_tensor(leaf).to(self.device, copy=True)

    def restore_latest(self) -> Optional[int]:
        """Roll the session back to the newest *readable* checkpoint.
        Corrupt/partial step directories are quarantined by the checkpoint
        layer and skipped; with no usable checkpoint at all (or no
        ``ckpt_dir``) the session re-initializes from the seed on its
        device — keyed randomness makes replay-from-scratch bit-exact too.
        Returns the restored step, or None when starting over. Sets the
        pipeline fast-forward so the next :meth:`stream` resumes mid-epoch
        exactly where the checkpoint left off. Under a mesh every rank
        calls it: rank 0 alone resolves the step (reading it whole and
        quarantining what it cannot read), broadcasts it, or "start over",
        on the mesh's control group, and every other rank restores exactly
        that step."""
        step = self._restore_newest() if self._leads() else None
        if self.mesh is not None and self.mesh.size > 1:
            step = self._from_rank0(step)
            if not self._leads():
                self._restore_step(step)
        return step

    def _leads(self) -> bool:
        """Whether this process resolves checkpoints: rank 0, or no mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def _from_rank0(self, step: Optional[int]) -> Optional[int]:
        """Rank 0's ``step`` (``None`` travels as -1) on every rank: one
        broadcast on the mesh's control group; the value itself at one
        rank."""
        if self.mesh is None or self.mesh.size == 1:
            return step
        from repro_torch.distributed import collectives as coll
        ctl = self.mesh.control
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                         device=ctl.device)
        got = int(coll.broadcast(t, ctl).item())
        return None if got < 0 else got

    def _restore_newest(self) -> Optional[int]:
        """Restore the newest readable checkpoint (or re-initialize);
        returns its step."""
        from repro_torch.train import checkpoint as ckpt
        while True:
            step = (ckpt.latest_step(self.ckpt_dir) if self.ckpt_dir
                    else None)
            try:
                self._restore_step(step)
            except ckpt.CorruptCheckpoint:
                # quarantined inside restore(); the next latest_step no
                # longer sees it — fall back to the one before
                continue
            return step

    def _restore_step(self, step: Optional[int]) -> None:
        """Restore checkpoint ``step``, or re-initialize from the seed when
        ``None``, with the counters and the pipeline fast-forward."""
        from repro_torch.train import checkpoint as ckpt
        if step is None:
            log.warning("no usable checkpoint — re-initializing from "
                        "seed %d", self.cfg.seed)
            self.state = init_state(
                getattr(self.pipeline, "table_rows",
                        self.pipeline.vocab.size),
                self.cfg, self.cfg.seed, self.device,
                placement=self.placement, spec=self.spec, mesh=self.mesh)
            self._resume_skip = 0
            self.resumed_step = None
            return
        extra = self._restore_tables(step)
        self.state.words_seen = int(extra.get("words_seen", 0))
        self.state.batches_seen = int(extra.get("batches_seen", step))
        cursor = ckpt.PipelineCursor.from_extra(extra)
        self.state.epoch = cursor.epoch
        self.state.epoch_batch = cursor.epoch_batch
        self._resume_skip = cursor.epoch_batch
        self.resumed_step = step

    def _maybe_resume(self) -> None:
        from repro_torch.train import checkpoint as ckpt
        newest = ckpt.latest_step(self.ckpt_dir) if self._leads() else None
        if self._from_rank0(newest) is not None:
            self.restore_latest()
        # else a fresh start: keep the init-state tables as built

    # -- inference helpers ----------------------------------------------------
    def embeddings(self) -> np.ndarray:
        """The input embedding table ``(V, d)`` as f32 numpy (quantized
        storage decodes here; numpy has no bf16); vocab-sharded sessions
        reassemble it from the hot head and the cold tail (a full ``(V,
        d)`` copy on the host: fine for examples and tests, wrong for
        serving, which takes :meth:`embeddings_sharded`). A collective
        that every rank of a sharded mesh calls."""
        hot, cold, placement = self.embeddings_sharded()
        hot = hot.detach().cpu().numpy()
        if placement is None:
            return hot
        return placement.merge(hot, cold.detach().cpu().numpy())

    def embeddings_sharded(self):
        """Shard-aware f32 view of the input table — no ``(V, d)`` gather.

        Returns ``(hot, cold, placement)``: for a vocab-sharded session the
        hot head ``(hot, d)``, the shard-major cold table ``(cold_pad, d)``
        (device tensors, decoded from their storage dtypes; an f32 table
        is returned as trained; on a mesh of several ranks the stripes
        all-gathered, a collective every rank calls) and the
        ``VocabPlacement`` describing the layout; for a replicated session
        ``(w_in, None, None)``."""
        st = self.state
        hot = quant.decode(st.w_in, None, self.spec.hot_dtype)
        if self.placement is None:
            return hot, None, None
        cold = quant.decode(st.cold_in, st.scale_in, self.spec.cold_dtype)
        if self._split_across_ranks():
            from repro_torch.distributed import collectives as coll
            cold = coll.all_gather(cold, self.mesh).reshape(-1, cold.shape[1])
        return hot, cold, self.placement

    def nearest(self, word_id: int, k: int = 5) -> np.ndarray:
        e = self.embeddings()
        e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
        sims = e @ e[word_id]
        sims[word_id] = -np.inf
        return np.argsort(-sims)[:k]
