"""Mixture-of-Experts FFN with capacity-factor dense dispatch.

The port's counterpart of ``repro.models.moe``: top-k routing,
position-in-expert via cumsum, scatter into a per-expert (E, C, d) buffer,
grouped expert GEMMs, gather+combine. Token-overflow beyond capacity is
dropped (standard Switch/GShard semantics): the dropped tokens land in an
overflow slot that is discarded. Arctic-style ``dense_residual`` adds a
small always-on MLP in parallel.

Capacity is counted per dispatch group, so which tokens share a group
decides which drop. Under active sharding rules the reference gives each
data shard its own group, on both of its paths, and so does the port:

* **The local path** (no rules, one ``model`` rank, experts that do not
  divide over ``model``, or the pure-DP rules): ``_dispatch_groups``
  groups, one per data shard of the step's batch. A caller that already
  computes on its data rank's rows (the mesh steps) says so with
  :func:`token_shards`, and its rows are then its own groups. Expert
  leaves that come as a model rank's ``ff`` block (the rules split
  ``ff`` where the experts do not divide over ``model``) raise.
* **Expert parallelism** (``_moe_ep``, the reference's ``_moe_shardmap``),
  taken on the reference's condition: rules active, ``model`` > 1, the
  experts dividing over it and the ``experts`` axis resolving. Each model
  rank routes its data shard's tokens against all experts and runs its
  own experts ``[e0, e0 + e_loc)`` (``_local_expert_pass``); the partial
  outputs are cast to bf16 and summed over ``model`` in rank order (an
  all-gather, then the sum), then cast back, as the reference's bf16
  ``psum``. The expert leaves come in as this model rank's block (the
  mesh steps keep them sharded over ``model``; a caller with the whole
  set has it sliced here). Backward, in the Megatron style: the block
  input and ``w_router`` enter through an identity whose backward sums
  their gradients over ``model`` once (each model rank holds only its
  experts' part), the sum's backward is the identity (what follows it is
  computed alike on every model rank), and the casts round the cotangent
  to bf16 as jax's do. The dense residual sits outside the sum, and so
  does its gradient (the residual runs tensor-parallel where its ``ff``
  splits). A caller holding the whole batch (a direct call under the
  rules) takes its data shard's rows first and gathers the outputs
  over the data axes after (backward: the rows' slice, a gather of the
  input's gradient, and the weights' gradients summed over the data
  shards, so every rank ends with the whole batch's).

The autograd pairs are ``repro_torch.distributed.collectives``'s, shared
with tensor parallelism. The ``expert_groups``/``experts`` ``constrain``
sites are the reference's; on the plain tensors the models compute on
they are the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.collectives import (
    _FromReplicated,
    _SumOverModel,
)
from repro_torch.distributed.sharding import (
    constrain,
    current_rules,
    model_shard,
    on_local_shards,
)
from repro_torch.models.layers import Draw, init_mlp, mlp_block

Params = Dict[str, torch.Tensor]

DATA_AXES = ("pod", "data")


def init_moe(cfg: ArchConfig, draw: Draw, dtype=torch.float32,
             lead: Tuple[int, ...] = ()) -> Params:
    moe = cfg.moe
    d, ff, e = cfg.d_model, cfg.d_ff, moe.num_experts
    p = {
        "w_router": draw(lead + (d, e), d ** -0.5, torch.float32),
        "we_gate": draw(lead + (e, d, ff), d ** -0.5, dtype),
        "we_up": draw(lead + (e, d, ff), d ** -0.5, dtype),
        "we_down": draw(lead + (e, ff, d), ff ** -0.5, dtype),
    }
    if moe.dense_residual:
        p["residual"] = init_mlp(d, moe.dense_residual_ff, draw, dtype, lead)
    return p


# --------------------------------------------------------------------------
# which tokens a call sees
# --------------------------------------------------------------------------
_TOKEN_SHARDS: contextvars.ContextVar[int] = contextvars.ContextVar(
    "moe_token_shards", default=1)


@contextlib.contextmanager
def token_shards(n: int):
    """Inside, a ``moe_block`` call's tokens are one of ``n`` equal
    contiguous row blocks of the step's batch, split over the data axes in
    mesh order (the mesh train step runs its data rank's rows)."""
    tok = _TOKEN_SHARDS.set(n)
    try:
        yield
    finally:
        _TOKEN_SHARDS.reset(tok)


def _dispatch_groups(t: int) -> int:
    """The reference's number of independent dispatch groups for ``t``
    tokens of a step: the data-shard count (GShard's G dim) when the rules
    are active and it divides ``t``, else 1."""
    rules = current_rules()
    if rules is None:
        return 1
    g = rules._axes_size(rules._present(DATA_AXES))
    return g if g > 1 and t % g == 0 else 1


def _local_groups(t: int) -> int:
    """Groups among the ``t`` tokens this call sees: the reference's groups
    of the whole step (``t`` times the :func:`token_shards` count) that
    fall in this call's rows. Rows split finer than the groups (the pure-DP
    rules split the batch over ``model`` too) are a group of their own."""
    n = _TOKEN_SHARDS.get()
    g = _dispatch_groups(t * n)
    if n == 1:
        return g
    return g // n if g % n == 0 else 1


def _ep_rules(cfg: ArchConfig):
    """The active rules when the reference takes its expert-parallel path
    (``moe.py``'s condition), else None."""
    rules = current_rules()
    e = cfg.moe.num_experts
    m = rules.shape.get("model", 1) if rules is not None else 1
    if (m > 1 and e % m == 0
            and rules.resolve("experts", e, allow_uneven=False) is not None):
        return rules
    return None


# --------------------------------------------------------------------------
# routing and the local expert pass
# --------------------------------------------------------------------------
def _route(p: Params, xf: torch.Tensor,
           k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax routing in f32: the top-``k`` gates, renormalised, and their
    expert ids ``gidx`` (ties aside, ``torch.topk`` picks what
    ``jax.lax.top_k`` picks, in the same descending order)."""
    logits = xf.float() @ p["w_router"]                       # (G, Tg, E)
    gates = torch.softmax(logits, dim=-1)
    gvals, gidx = torch.topk(gates, k, dim=-1)                # (G, Tg, K)
    gvals = gvals / torch.clamp(gvals.sum(-1, keepdim=True), min=1e-9)
    return gvals, gidx


def _local_expert_pass(cfg: ArchConfig, x: torch.Tensor,
                       router: torch.Tensor, we_gate: torch.Tensor,
                       we_up: torch.Tensor, we_down: torch.Tensor, e0: int,
                       n_experts: int) -> torch.Tensor:
    """One shard's expert pass: route ALL of its tokens ``x`` (T, d),
    process the experts it owns (``[e0, e0+e_loc)``), return its partial
    output (T, d). Local ops only, no collectives."""
    moe = cfg.moe
    k = moe.top_k
    t, d = x.shape
    e_loc = we_gate.shape[0]

    gvals, gidx = _route({"w_router": router}, x, k)           # (T, K)
    rel = gidx - e0
    mine = (rel >= 0) & (rel < e_loc)
    rel_flat = torch.where(mine, rel, e_loc).reshape(t * k)    # overflow row
    onehot = F.one_hot(rel_flat, e_loc + 1).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1   # (T*K,)
    cap = min(max(1, int(k * t * moe.capacity_factor / n_experts)), t)
    keep = mine.reshape(t * k) & (pos < cap)
    safe_pos = torch.where(keep, pos, cap)

    xrep = torch.repeat_interleave(x, k, dim=0)                # (T*K, d)
    buf = torch.zeros((e_loc + 1, cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf = buf.index_put((rel_flat, safe_pos), xrep, accumulate=True)
    buf = buf[:e_loc, :cap]                                    # (E_loc, C, d)

    h = F.silu(torch.einsum("ecd,edf->ecf", buf, we_gate))
    h = h * torch.einsum("ecd,edf->ecf", buf, we_up)
    h = torch.einsum("ecf,efd->ecd", h, we_down)               # (E_loc, C, d)

    hpad = F.pad(h, (0, 0, 0, 1, 0, 1))
    out = hpad[torch.clamp(rel_flat, max=e_loc), safe_pos]     # (T*K, d)
    out = out * (gvals.reshape(t * k, 1).to(out.dtype)
                 * keep[:, None].to(out.dtype))
    return out.reshape(t, k, d).sum(1)                         # (T, d) partial


# --------------------------------------------------------------------------
# the data shards' rows (the model axis's pairs are shared with tensor
# parallelism: ``repro_torch.distributed.collectives``)
# --------------------------------------------------------------------------
def _data_groups(mesh, axes: Sequence[str]):
    """(index, [(group, size), ...]) of this rank's data shard over
    ``axes`` (mesh order, the first the major one), the groups inner
    first."""
    import torch.distributed as dist
    idx, groups = 0, []
    for a in axes:
        g = mesh.get_group(a)
        idx = idx * dist.get_world_size(g) + mesh.get_local_rank(a)
        groups.append((g, dist.get_world_size(g)))
    return idx, groups[::-1]


def _gather_rows(x: torch.Tensor, groups) -> torch.Tensor:
    for g, n in groups:
        x = collectives.gather_cat(x, g, 0) if n > 1 else x
    return x


class _Rows(torch.autograd.Function):
    """Forward: this data shard's rows of a batch every rank holds whole.
    Backward: the rows' gradients gathered from every data shard."""

    @staticmethod
    def forward(ctx, x, idx, n, groups):
        ctx.groups = groups
        rows = x.shape[0] // n
        return x[idx * rows:(idx + 1) * rows].clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_rows(g.contiguous(), ctx.groups), None, None, None


class _GatherRows(torch.autograd.Function):
    """Forward: every data shard's rows, gathered in shard order.
    Backward: this shard's rows of the gradient (what consumes the
    gathered batch computes alike on every rank)."""

    @staticmethod
    def forward(ctx, x, idx, groups):
        ctx.idx, ctx.rows = idx, x.shape[0]
        return _gather_rows(x.contiguous(), groups)

    @staticmethod
    def backward(ctx, g):
        return (g[ctx.idx * ctx.rows:(ctx.idx + 1) * ctx.rows].contiguous(),
                None, None)


def _experts_here(w: torch.Tensor, e: int, e_loc: int,
                  mi: int) -> torch.Tensor:
    """This model rank's expert block of an expert leaf: as it comes
    inside ``local_shards`` (the caller passes this rank's block), else
    sliced out of all ``e`` experts."""
    want = e_loc if on_local_shards() else e
    if w.shape[0] != want:
        raise ValueError(f"an expert leaf of {w.shape[0]} experts where "
                         f"{want} come")
    return w if want == e_loc else w[mi * e_loc:(mi + 1) * e_loc]


def _moe_ep(cfg: ArchConfig, p: Params, x: torch.Tensor,
            rules) -> torch.Tensor:
    """Expert parallelism on ``rules.mesh`` (a ``DeviceMesh``; module
    docstring)."""
    mesh = rules.mesh
    moe = cfg.moe
    b, s, d = x.shape
    e = moe.num_experts
    e_loc = e // rules.shape["model"]
    mi = mesh.get_local_rank("model")
    model_group = mesh.get_group("model")

    axes = [a for a in DATA_AXES if a in rules.shape]
    n_data = rules._axes_size(tuple(axes)) if axes else 1
    n = _TOKEN_SHARDS.get()
    split = n_data > 1 and (b * n) % n_data == 0   # the reference's blocks
    if n > 1 and (not split or n != n_data):
        raise ValueError(
            f"expert parallelism on rows split {n} ways, where the "
            f"reference's batch blocks are {n_data if split else 1}")
    xb, router = x, p["w_router"]
    wg, wu, wd = (_experts_here(p[k], e, e_loc, mi)
                  for k in ("we_gate", "we_up", "we_down"))
    if split and n == 1:
        idx, groups = _data_groups(mesh, axes)
        xb = _Rows.apply(x, idx, n_data, groups)
        # every data shard's part of these weights' gradients, summed
        for g, _ in groups:
            router, wg, wu, wd = (_FromReplicated.apply(w, g)
                                  for w in (router, wg, wu, wd))
    t_loc = xb.shape[0] * s
    xin = _FromReplicated.apply(xb.reshape(t_loc, d), model_group)
    router = _FromReplicated.apply(router, model_group)
    part = _local_expert_pass(cfg, xin, router, wg, wu, wd, mi * e_loc, e)
    out = _SumOverModel.apply(part.to(torch.bfloat16), model_group)
    out = out.reshape(xb.shape).to(x.dtype)
    if xb is not x:
        out = _GatherRows.apply(out, idx, groups)
    if moe.dense_residual:
        out = out + mlp_block(p["residual"], x.reshape(b * s, d),
                              cfg.bf16_reduce,
                              moe.dense_residual_ff).reshape(b, s, d)
    return out


# --------------------------------------------------------------------------
# the block
# --------------------------------------------------------------------------
def moe_block(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    rules = _ep_rules(cfg)
    if rules is not None:
        return _moe_ep(cfg, p, x, rules)
    moe = cfg.moe
    e, k = moe.num_experts, moe.top_k
    b, s, d = x.shape
    t = b * s
    grp = _local_groups(t)
    tg = t // grp                                              # tokens/group
    xf = x.reshape(grp, tg, d)
    xf = constrain(xf, "expert_groups", None, None)

    # --- route ---
    gvals, gidx = _route(p, xf, k)

    # --- position-in-expert: group-local cumsum ---
    flat_e = gidx.reshape(grp, tg * k)                         # (G, Tg*K)
    onehot = F.one_hot(flat_e, e).to(torch.int32)              # (G, Tg*K, E)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1   # (G, Tg*K)
    cap = min(max(1, int(k * tg * moe.capacity_factor / e)), tg)
    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap)                     # overflow slot

    # --- dispatch: (G, E, C+1, d) buffer; each kept slot gets one token,
    # only the discarded overflow slot sums many ---
    xrep = torch.repeat_interleave(xf, k, dim=1)               # (G, Tg*K, d)
    gi = torch.arange(grp, device=x.device)[:, None].expand(grp, tg * k)
    buf = torch.zeros((grp, e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((gi, flat_e, safe_pos), xrep, accumulate=True)
    buf = constrain(buf, "expert_groups", None, None, None)
    buf = buf[:, :, :cap]                                      # (G, E, C, d)
    buf = constrain(buf, "expert_groups", "experts", None, None)

    # --- expert GEMMs ---
    ms = model_shard()
    if ms is not None and ms.sharded("ff", cfg.d_ff):
        raise ValueError(f"{e} experts do not split over {ms.size} model "
                         f"ranks: the local path runs whole experts, not "
                         f"their ff blocks")
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["we_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", buf, p["we_up"])
    h = torch.einsum("gecf,efd->gecd", h, p["we_down"])        # (G, E, C, d)
    h = constrain(h, "expert_groups", None, None, None)

    # --- combine (group-local gather) ---
    hpad = torch.cat([h, torch.zeros((grp, e, 1, d), dtype=h.dtype,
                                     device=h.device)], dim=2)
    out = hpad[gi, flat_e, safe_pos]                           # (G, Tg*K, d)
    out = out * (gvals.reshape(grp, tg * k, 1).to(out.dtype)
                 * keep[..., None].to(out.dtype))
    out = out.reshape(grp, tg, k, d).sum(2)                    # (G, Tg, d)

    if moe.dense_residual:
        out = out + mlp_block(p["residual"], xf, cfg.bf16_reduce,
                              moe.dense_residual_ff)
    return out.reshape(b, s, d)
