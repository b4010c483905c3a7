"""LM training loop: microbatching, checkpoint/restart, straggler and
failure handling.

The port's counterpart of ``repro.train.loop``. One process, or one rank
of a ``torch.distributed`` ``DeviceMesh`` (``mesh=``): parameters are then
DTensors placed by ``param_shardings`` (role ``"param"``) and the AdamW
moments by role ``"opt"`` (the replicated embed table's state sharded over
the whole mesh); every rank draws the same global batch and trains its
rows of it (``repro_torch.launch.steps``). Checkpoints hold the gathered
``{"params", "opt"}`` tree in the reference's format (rank 0 writes), so
either package resumes the other's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.trainer import resolve_device
from repro_torch.distributed.sharding import Rules, param_shardings
from repro_torch.launch.steps import distribute, gather, make_train_step
from repro_torch.models import lm
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.resilience import (
    FailureInjector,
    RetryPolicy,
    StepTimeout,
    StragglerMonitor,
    Watchdog,
    run_with_recovery,
)
from repro_torch.tree import tree_map

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    microbatches: int = 1
    log_every: int = 10
    # 0 = no watchdog; else a step (its batch, its update and the loss read
    # back) that overruns it fails with StepTimeout and is recovered
    step_timeout_s: float = 0.0
    max_restarts: int = 3


def synthetic_lm_batches(cfg: ArchConfig, batch: int, seq: int,
                         seed: int = 0, device=None) -> Iterator[Dict]:
    """Deterministic synthetic token stream (per-step seeded), the
    reference's numpy draws bit for bit, as tensors on ``device`` (the GPU
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    step = 0
    while True:
        rng = np.random.default_rng(seed + step)
        toks = rng.integers(0, cfg.vocab, (batch, seq + 1), dtype=np.int32)
        out = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}
        if cfg.prefix_len:
            out["prefix_embeds"] = torch.from_numpy(
                rng.normal(0, 1, (batch, cfg.prefix_len, cfg.d_model))
                .astype(np.float32)).to(device)
        yield out
        step += 1


class Trainer:
    def __init__(self, cfg: ArchConfig, opt: AdamWConfig, loop: LoopConfig,
                 mesh=None, batch_fn: Optional[Callable[[int], Dict]] = None,
                 batch: int = 8, seq: int = 128,
                 param_dtype=torch.float32,
                 failure_injector: Optional[FailureInjector] = None,
                 device=None):
        self.cfg = cfg
        self.opt = opt
        self.loop = loop
        self.mesh = mesh
        self.device = resolve_device(device)
        self.monitor = StragglerMonitor()
        self.failure_injector = failure_injector
        self.history: list = []

        self.params = lm.init_params(cfg, seed=0, dtype=param_dtype,
                                     device=self.device)
        self.opt_state = adamw_init(self.params)
        self._place()
        self.step_fn = make_train_step(cfg, opt, loop.microbatches)
        if batch_fn is None:
            it = synthetic_lm_batches(cfg, batch, seq, device=self.device)
            batch_fn = lambda step: next(it)
        self.batch_fn = batch_fn
        self.start_step = 0
        if loop.ckpt_dir and ckpt.latest_step(loop.ckpt_dir) is not None:
            self._restore()

    # ------------------------------------------------------------------
    def _place(self) -> None:
        """On a mesh, the plain parameters and moments as DTensors: role
        "param" for parameters, role "opt" for ``m`` and ``v``."""
        if self.mesh is None:
            return
        rules = Rules(self.mesh)
        p_sh = param_shardings(self.params, rules)
        o_sh = param_shardings(self.params, rules, role="opt")

        def put(tree, sh):
            return tree_map(lambda x, s: distribute(x, self.mesh,
                                                    s.placements), tree, sh)

        self.params = put(self.params, p_sh)
        self.opt_state = AdamWState(step=self.opt_state.step,
                                    m=put(self.opt_state.m, o_sh),
                                    v=put(self.opt_state.v, o_sh))

    def _rank(self) -> int:
        if self.mesh is None:
            return 0
        import torch.distributed as dist
        return dist.get_rank()

    def _barrier(self) -> None:
        if self.mesh is not None:
            import torch.distributed as dist
            dist.barrier()

    def _save(self, step: int) -> None:
        if not self.loop.ckpt_dir:
            return
        # a collective on a mesh: every rank gathers, rank 0 writes
        tree = gather({"params": self.params, "opt": self.opt_state})
        if self._rank() == 0:
            ckpt.save(self.loop.ckpt_dir, step, tree, keep=self.loop.keep,
                      extra={"arch": self.cfg.name})
            log.info("checkpointed step %d", step)
        self._barrier()

    def _restore(self) -> int:
        tree_like = tree_map(
            lambda x: ckpt.ArraySpec(tuple(x.shape),
                                     str(x.dtype).removeprefix("torch.")),
            {"params": self.params, "opt": self.opt_state})
        tree, _ = ckpt.restore(self.loop.ckpt_dir, tree_like,
                               device=self.device)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self._place()
        self.start_step = ckpt.latest_step(self.loop.ckpt_dir) or 0
        log.info("restored checkpoint at step %d", self.start_step)
        return self.start_step

    # ------------------------------------------------------------------
    def train(self) -> Dict:
        if self.loop.ckpt_dir:
            self._save(self.start_step)

        def one_step(step: int) -> None:
            if self.failure_injector is not None:
                self.failure_injector.check(step)
            guard = (Watchdog(self.loop.step_timeout_s)
                     if self.loop.step_timeout_s > 0
                     else contextlib.nullcontext())
            t0 = time.perf_counter()
            with guard:
                batch = self.batch_fn(step)
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])   # waits for the device
                if not np.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss at step {step}")
                self.history.append(loss)
            dt = time.perf_counter() - t0
            self.monitor.report("host0", dt)
            if step % self.loop.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step, loss, dt * 1e3)
            if (self.loop.ckpt_dir and (step + 1) % self.loop.ckpt_every == 0):
                self._save(step + 1)

        def on_failure(step: int, exc: BaseException) -> int:
            if self.loop.ckpt_dir:
                return self._restore()
            # no checkpointing: keep the state and go on; a step that
            # overran its timeout has already applied its update
            return step + 1 if isinstance(exc, StepTimeout) else step

        final = run_with_recovery(
            one_step, start_step=self.start_step, end_step=self.loop.steps,
            on_failure=on_failure,
            policy=RetryPolicy(max_restarts=self.loop.max_restarts))
        if self.loop.ckpt_dir:
            self._save(final)
        return {"final_step": final, "losses": self.history,
                "stragglers": self.monitor.stragglers()}
