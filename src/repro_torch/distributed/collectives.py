"""Collectives over a :class:`~repro_torch.launch.mesh.DataMesh`.

The port's counterparts of the ``jax.lax`` collectives that the
reference's ``shard_map`` steps call over the ``data`` axis, on a
``torch.distributed`` process group. With no mesh, or a mesh of one rank,
each is an exact identity and touches no group.

* :func:`all_gather` — every rank's ``x`` stacked on a new leading axis
  (``all_gather_into_tensor``).
* :func:`all_to_all` — block ``x[o]`` goes to rank ``o``
  (``all_to_all_single``, equal splits).
* :func:`psum_scatter` — sum ``(n, ...)`` over ranks and keep this rank's
  block (``reduce_scatter_tensor``).
* :func:`broadcast` — rank ``src``'s ``x`` on every rank, in place (the
  serving command stream's).
* :func:`psum` — the sum over ranks in rank order: an ``all_gather`` into
  an ``(n, ...)`` buffer, then a left-to-right sum.
* :func:`pmean` — :func:`psum`, then a true division by ``n``. Its bits
  (and :func:`psum`'s) depend neither on the tensor's size, nor on ``n``,
  nor on the backend's reduction algorithm (a ring ``all_reduce`` chunks
  by size), so every rank gets the same bits and an element's mean is the
  same whether it sits in a full replicated table or in the hot head of a
  split one (DESIGN.md §8's bit-identical head).

int8 and bf16 payloads travel as they are, on the tensors' device. gloo,
the backend of ranks that share one card, runs all four on CUDA tensors
directly in the torch the H100 machine has (2.11.0+cu128:
``tools/torch_gloo_probe.py``, PERF.md §6), and no faster through pinned
host buffers, so nothing is staged on the host.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

# the non-deprecated names where the installed torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _one(mesh) -> bool:
    return mesh is None or mesh.size == 1


def _run(mesh, x: torch.Tensor, out_shape: Tuple[int, ...],
         call: Callable[..., None]) -> torch.Tensor:
    """``call(out, x, group=...)`` into a new ``out`` on ``x``'s
    device."""
    x = x.contiguous()
    out = x.new_empty(out_shape)
    call(out, x, group=mesh.group)
    return out


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis: ``(n, ...)``."""
    if _one(mesh):
        return x.unsqueeze(0)
    n = mesh.size
    flat = x.reshape(1, *x.shape) if x.dim() == 0 else x
    out = _run(mesh, flat, (n * flat.shape[0], *flat.shape[1:]),
               _ALL_GATHER)
    return out.view(n, *x.shape)


def all_to_all(x: torch.Tensor, mesh) -> torch.Tensor:
    """Block ``x[o]`` goes to rank ``o``; returns the blocks addressed to
    this rank, ``(n, ...)`` by sender."""
    if _one(mesh):
        return x
    if x.shape[0] != mesh.size:
        raise ValueError(f"all_to_all takes ({mesh.size}, ...) blocks, got "
                         f"{tuple(x.shape)}")
    return _run(mesh, x, tuple(x.shape), dist.all_to_all_single)


def psum_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum ``(n, ...)`` over ranks and keep this rank's block ``(1, ...)``
    (the reference's tiled ``psum_scatter`` on axis 0)."""
    if _one(mesh):
        return x
    if x.shape[0] != mesh.size:
        raise ValueError(f"psum_scatter takes ({mesh.size}, ...) blocks, "
                         f"got {tuple(x.shape)}")
    return _run(mesh, x, (1, *x.shape[1:]), _REDUCE_SCATTER)


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over ranks, in rank order (see the module docstring);
    a new tensor, the same bits on every rank."""
    if _one(mesh):
        return x
    parts = all_gather(x, mesh)
    acc = parts[0].clone()
    for part in parts[1:]:
        acc += part
    return acc


def pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """Mean of ``x`` over ranks, summed in rank order (see the module
    docstring); a new tensor, the same bits on every rank."""
    if _one(mesh):
        return x
    acc = psum(x, mesh)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which rounds unlike a true division at n=3
    return acc / torch.full((), float(mesh.size), dtype=acc.dtype,
                            device=acc.device)


def broadcast(x: torch.Tensor, mesh, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, written into ``x`` in place
    (``x`` must be contiguous and of the same shape on every rank)."""
    if _one(mesh):
        return x
    if mesh.group is not None:
        src = dist.get_global_rank(mesh.group, src)
    dist.broadcast(x, src=src, group=mesh.group)
    return x
