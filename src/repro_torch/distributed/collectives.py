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

Tensor and expert parallelism over a ``DeviceMesh``'s ``model`` axis (the
LM substrate's, ``repro_torch.models``) compute on local shards with two
autograd pairs on a process group, in the Megatron style:

* :func:`from_replicated` — forward the identity on a value every rank of
  the group holds alike; backward its gradient summed over the group (each
  rank's is the part through its own shard). It marks where a replicated
  value (an activation, a replicated parameter) enters rank-specific
  compute: the input of a column-parallel product, a weight each rank
  uses whole.
* :func:`sum_over_model` — forward the sum of every rank's ``x`` in rank
  order, in ``x``'s dtype (the output of a row-parallel product: the
  reference's ``psum``); backward the identity (what follows it is
  computed alike on every rank).

* :func:`block_of_replicated` — forward this rank's block of such a
  value (a replicated weight each rank slices); backward the blocks'
  gradients gathered from every rank (half a sum's traffic, no zeros).

Composed, ``from_replicated(sum_over_model(x))`` sums both ways (a sum
whose consumers are rank-specific, such as a sharded norm's mean of
squares). :func:`gather_cat` and :func:`max_over` carry no gradient.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

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


# --------------------------------------------------------------------------
# tensor and expert parallelism: the autograd pairs (module docstring)
# --------------------------------------------------------------------------
def _gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` of ``group``, in group-rank order (bf16 goes as
    its bytes, which every backend carries)."""
    n = dist.get_world_size(group)
    bits = x.contiguous()
    if x.dtype == torch.bfloat16:
        bits = bits.view(torch.uint8)
    out = [torch.empty_like(bits) for _ in range(n)]
    dist.all_gather(out, bits, group=group)
    if x.dtype == torch.bfloat16:
        out = [o.view(torch.bfloat16) for o in out]
    return out


def _rank_order_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` of ``group``, each element added in
    rank order in ``x``'s dtype (the same bits on every rank), moving what
    a ring all-reduce moves: an all-to-all hands each rank one block of
    every rank's ``x`` (the tensor flattened and padded to a multiple of
    the group's size), each rank sums its block in rank order, and an
    all-gather returns the summed blocks. Tensors travel as their bytes,
    which every backend carries."""
    n = dist.get_world_size(group)
    flat = x.contiguous().reshape(-1)
    k = -(-flat.numel() // n)
    if k * n != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(k * n - flat.numel())])
    send = flat.reshape(n, k).view(torch.uint8)
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    parts = got.view(x.dtype)
    acc = parts[0]
    for r in range(1, n):
        acc = acc + parts[r]
    out = torch.empty((n, acc.numel() * acc.element_size()),
                      dtype=torch.uint8, device=x.device)
    _ALL_GATHER(out, acc.contiguous().view(torch.uint8).reshape(1, -1),
                group=group)
    return out.view(x.dtype).reshape(-1)[:x.numel()].reshape(x.shape)


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum of every rank's ``x`` in rank order, in ``x``'s
    dtype (the reference's ``psum`` over ``model``;
    :func:`_rank_order_sum`). Backward: the identity (the sum's consumers
    compute alike on every rank)."""

    @staticmethod
    def forward(ctx, x, group):
        if dist.get_world_size(group) == 1:
            return x.clone()
        return _rank_order_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FromReplicated(torch.autograd.Function):
    """Forward: the identity on an input every rank holds alike.
    Backward: its gradient summed over the group (each rank's is the part
    through its own shard)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _BlockOfReplicated(torch.autograd.Function):
    """Forward: this rank's block along ``dim`` of a value every rank
    holds alike (an even split, in rank order). Backward: every rank's
    block of the gradient gathered along ``dim`` (the whole value's
    gradient: each rank's is its block's)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        n = dist.get_world_size(group)
        k = x.shape[dim] // n
        ctx.dim, ctx.group = dim, group
        return x.narrow(dim, dist.get_rank(group) * k, k)

    @staticmethod
    def backward(ctx, g):
        return gather_cat(g.contiguous(), ctx.group, ctx.dim), None, None


def block_of_replicated(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """:class:`_BlockOfReplicated` of ``x`` along ``dim`` over ``group``."""
    return _BlockOfReplicated.apply(x, dim, group)


def sum_over_model(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`_SumOverModel` of ``x`` over ``group``."""
    return _SumOverModel.apply(x, group)


def from_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`_FromReplicated` of ``x`` over ``group``."""
    return _FromReplicated.apply(x, group)


def gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` concatenated along ``dim`` in rank
    order (no gradient)."""
    return torch.cat(_gather_list(x, group), dim=dim)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (a new tensor, no
    gradient)."""
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out
