"""Optimizer: AdamW for LMs (manual, in place).

The port's counterpart of ``repro.train.optim``. State trees mirror the
parameter tree (``repro_torch.tree``), so ``param_shardings`` places
optimizer state like parameters (ZeRO: state shards with the FSDP'd
parameters). The arithmetic is the reference's, in the same order, in
f32: the gradient clipped by the global norm, the step advanced before
the lr, bias corrections, and decoupled weight decay on every leaf of two
or more dimensions (a layer-stacked ``(n_blocks, d)`` norm scale
included, as in the reference). Updates are in place under
``torch.no_grad()`` (the reference donates its buffers instead).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # scalar int32
    m: Any                    # tree like params (f32)
    v: Any                    # tree like params (f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup times cosine decay to ``min_lr_frac``, in f32 (an int
    ``step`` is taken as a CPU scalar)."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def adamw_init(params: Any) -> AdamWState:
    """f32 zeros like every leaf (on its device) and a step of 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params),
        v=tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), params))


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: Any,
                 state: AdamWState, *, gnorm: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step: ``params``, ``state.m`` and ``state.v`` are updated
    in place (the parameter in its own dtype, computed in f32) and
    returned with the advanced step. ``gnorm`` is the whole gradient's
    global norm when ``grads`` holds only this rank's part of it (a
    sharded update, ``repro_torch.launch.steps``); by default
    ``global_norm(grads)``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        g = g.float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        p32 = p.float()
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v)
