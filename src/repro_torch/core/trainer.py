"""W2V training sessions: streaming steps, LR decay, metrics callbacks.

The port's counterpart of ``repro.core.trainer``. :class:`TrainSession`
owns everything around the kernel: the classic linear LR schedule, the
batch stream and per-step metrics. The kernel is reached only through the
engine API (``kernels.ops.step`` / ``kernels.registry``); the backend is
resolved once at construction against the session's device, so invalid
combinations — unknown backend, a CUDA kernel on the CPU — fail fast.

The session runs on the GPU unless the caller passes ``device="cpu"``:
with ``device=None`` and no GPU it raises rather than quietly running the
plain versions on the CPU. ``cfg.vocab_shard`` splits the tables into a
replicated hot head and a cold tail on one shard (DESIGN.md §8), with the
row exchange planned per batch by ``repro_torch.distributed
.vocab_placement``. Checkpoints, data-parallel meshes (and with them more
than one vocab shard), mixed-precision tables and supervised recovery
arrive with later slices of the port and raise until then.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.batching import Batch, BatchingPipeline
from repro_torch.kernels import ops, registry
from repro_torch.kernels import tables as tables_mod
from repro_torch.kernels.registry import StepInputs
from repro_torch.kernels.tables import Tables


@dataclasses.dataclass
class TrainState:
    """Training state: float32 tables (updated in place by every step) +
    progress counters.

    Replicated sessions hold the full ``(V, d)`` tables in ``w_in`` /
    ``w_out``. Vocab-sharded sessions hold the replicated hot head there
    instead, plus the striped cold tail in ``cold_in`` / ``cold_out``
    (``(cold_pad, d)``, DESIGN.md §8)."""
    w_in: torch.Tensor
    w_out: torch.Tensor
    words_seen: int = 0
    batches_seen: int = 0
    epoch: int = 0
    epoch_batch: int = 0   # batches completed within the current epoch
    cold_in: Optional[torch.Tensor] = None    # vocab-sharded cold tail
    cold_out: Optional[torch.Tensor] = None

    def params(self) -> Dict[str, torch.Tensor]:
        """The table dict, named as the reference's ``TrainState.params``
        (split names when vocab-sharded)."""
        if self.cold_in is not None:
            return {"hot_in": self.w_in, "hot_out": self.w_out,
                    "cold_in": self.cold_in, "cold_out": self.cold_out}
        return {"w_in": self.w_in, "w_out": self.w_out}


@dataclasses.dataclass
class StepMetrics:
    """Per-batch metrics yielded by :meth:`TrainSession.stream`.

    ``fetch_seconds`` is the time the step loop spent blocked waiting for
    this batch from the host pipeline. ``queue_depth`` is an async
    pipeline's ready-batch depth when this batch was taken (-1 for the
    synchronous pipeline)."""
    epoch: int
    batches_seen: int
    words_seen: int
    batch_words: int
    lr: float
    backend: str
    fetch_seconds: float = 0.0
    queue_depth: int = -1


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
               device=None, placement=None) -> TrainState:
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
    exactly the tables a replicated one would."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    d = cfg.dim
    w_in = (torch.rand((vocab_size, d), generator=gen,
                       dtype=torch.float32) - 0.5) / d
    w_out = torch.zeros((vocab_size, d), dtype=torch.float32)
    if placement is None:
        return TrainState(w_in=w_in.to(device), w_out=w_out.to(device))
    (hot_in, cold_in), (hot_out, cold_out) = (
        placement.split(t.numpy()) for t in (w_in, w_out))
    put = lambda a: torch.from_numpy(a).to(device)          # noqa: E731
    return TrainState(w_in=put(hot_in), w_out=put(hot_out),
                      cold_in=put(cold_in), cold_out=put(cold_out))


def _later_slice(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} arrives with a later slice of the "
                               f"torch port")


class TrainSession:
    """A streaming W2V training session over a batching pipeline.

    Parameters
    ----------
    backend : registry name or ``"auto"``, resolved once at construction
        against ``device`` (``cfg.tile_windows > 1`` selects the
        window-tiled family).
    device : ``None`` (the GPU; raises without one), ``"cuda"``,
        ``"cuda:N"`` or ``"cpu"``.
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
        exchange: Optional[str] = None,
    ):
        if mesh is not None:
            raise _later_slice("data-parallel training (mesh)")
        if ckpt_dir:
            raise _later_slice("checkpointing (ckpt_dir)")
        self.pipeline = pipeline
        self.cfg = cfg
        self.device = resolve_device(device)
        spec = tables_mod.from_config(cfg)
        if exchange is not None:
            spec = dataclasses.replace(spec, exchange=exchange)
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
        self.on_batch = on_batch
        self.on_metrics = on_metrics
        table_rows = getattr(pipeline, "table_rows", pipeline.vocab.size)
        self.placement = None
        if self.spec.vocab_shard:
            from repro_torch.distributed.vocab_placement import \
                VocabPlacement
            # one shard: more need the data-parallel slice's process group
            self.placement = VocabPlacement.plan(pipeline.vocab.counts, 1,
                                                 hot_frac=self.spec.hot_frac)
            # the pipeline plans each batch's exchange as it finalizes it
            # (Batch.exchange); _make_step plans inline for batches without
            pipeline.placement = self.placement
        self.state = init_state(table_rows, cfg, cfg.seed, self.device,
                                placement=self.placement)
        self._tables().check_runnable()
        self.total_words = max(1, pipeline.epoch_words * cfg.epochs)
        self.words_per_sec = 0.0
        self.fetch_seconds = 0.0   # cumulative wait on the host pipeline
        self.wall_seconds = 0.0    # last train() wall time

    # -- learning-rate schedule (classic linear decay) ----------------------
    def _lr_at(self, words_seen: int) -> float:
        frac = 1.0 - words_seen / self.total_words
        return self.cfg.lr * max(frac, self.cfg.min_lr_frac)

    def current_lr(self) -> float:
        return self._lr_at(self.state.words_seen)

    def _tables(self) -> Tables:
        st = self.state
        return Tables(w_in=st.w_in, w_out=st.w_out, cold_in=st.cold_in,
                      cold_out=st.cold_out, spec=self.spec,
                      placement=self.placement)

    def _make_step(self, batch: Batch, lr) -> StepInputs:
        """Device StepInputs for a batch: the vocab-sharded exchange plan
        when the session shards the vocabulary (``batch.exchange`` from a
        placement-aware pipeline, else planned here), the plain lift
        otherwise."""
        if self.placement is None:
            return batch.step_inputs(lr, self.device)
        ex = getattr(batch, "exchange", None)
        if ex is None or ex.placement != self.placement:
            from repro_torch.distributed.vocab_placement import plan_exchange
            ex = plan_exchange(batch, self.placement)
        return ex.step_inputs(lr, self.device)

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
        if step is None or (self.placement is not None
                            and not step.has_vocab_shard):
            # a plain pre-built step carries global ids; the sharded path
            # needs the exchange plan, so rebuild it from the host batch
            step = self._make_step(batch, lr)
        ops.step(self._tables(), step, self.cfg,
                 backend=self._requested_backend)
        self.state.words_seen += batch.n_words
        self.state.batches_seen += 1
        self.state.epoch_batch += 1
        self.fetch_seconds += fetch_seconds
        metrics = StepMetrics(
            epoch=self.state.epoch, batches_seen=self.state.batches_seen,
            words_seen=self.state.words_seen, batch_words=batch.n_words,
            lr=lr, backend=self.backend, fetch_seconds=fetch_seconds,
            queue_depth=getattr(self.pipeline, "ready_depth", -1))
        if self.on_batch is not None:
            self.on_batch(self.state)
        if self.on_metrics is not None:
            self.on_metrics(metrics)
        return metrics

    def _prepared(self, batch_iter: Iterator[Batch]) -> Iterator[tuple]:
        """Lift host batches onto the device one step ahead: batch k+1's
        StepInputs are built while batch k's kernel still runs (kernel
        launches return before the device finishes). lr for batch k+1 is
        exact — it depends only on cumulative host-side word counts."""
        projected = self.state.words_seen
        try:
            for batch in batch_iter:
                lr = self._lr_at(projected)
                step = self._make_step(batch, lr)
                projected += batch.n_words
                yield batch, step
        finally:
            close = getattr(batch_iter, "close", None)
            if close is not None:
                close()

    def stream(self, epochs: Optional[int] = None,
               max_batches: Optional[int] = None) -> Iterator[StepMetrics]:
        """Stream the session: train batch by batch, yielding metrics after
        each. Randomness is keyed by (epoch, batch index), so the stream is
        the reference's for the same corpus and config."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        pad_len = self.cfg.resolved_pad_len
        n_batches = 0
        for ep in range(min(self.state.epoch, epochs), epochs):
            self.state.epoch = ep
            self.state.epoch_batch = 0
            prepared = self._prepared(
                self.pipeline.batches(pad_len=pad_len, epoch=ep))
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
        dt = time.perf_counter() - t0
        self.wall_seconds = dt
        self.words_per_sec = ((self.state.words_seen - words0) / dt
                              if dt else 0.0)
        return self.state

    def train_resilient(self, **kwargs) -> TrainState:
        """Supervised recovery (the reference's ``train_resilient``)."""
        raise _later_slice("supervised recovery (train_resilient)")

    @property
    def device_busy_frac(self) -> float:
        """Fraction of the last ``train()`` wall time NOT spent blocked on
        the host pipeline."""
        if not self.wall_seconds:
            return 0.0
        return max(0.0, 1.0 - self.fetch_seconds / self.wall_seconds)

    # -- inference helpers ----------------------------------------------------
    def embeddings(self) -> np.ndarray:
        """The input embedding table ``(V, d)`` as f32 numpy; vocab-sharded
        sessions reassemble it from the hot head and the cold tail (a full
        ``(V, d)`` copy on the host: fine for examples and tests, wrong for
        serving, which takes :meth:`embeddings_sharded`)."""
        hot = self.state.w_in.detach().cpu().numpy().astype(np.float32)
        if self.placement is None:
            return hot
        return self.placement.merge(hot, self.state.cold_in.detach().cpu()
                                    .numpy())

    def embeddings_sharded(self):
        """Shard-aware view of the input table — no ``(V, d)`` gather.

        Returns ``(hot, cold, placement)``: for a vocab-sharded session the
        hot head ``(hot, d)``, the shard-major cold table ``(cold_pad, d)``
        (device tensors, as trained) and the ``VocabPlacement`` describing
        the layout; for a replicated session ``(w_in, None, None)``."""
        return self.state.w_in, self.state.cold_in, self.placement

    def nearest(self, word_id: int, k: int = 5) -> np.ndarray:
        e = self.embeddings()
        e = e / np.maximum(np.linalg.norm(e, axis=1, keepdims=True), 1e-12)
        sims = e @ e[word_id]
        sims[word_id] = -np.inf
        return np.argsort(-sims)[:k]
