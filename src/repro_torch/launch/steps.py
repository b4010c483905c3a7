"""Train, prefill and serve steps, and abstract inputs for every
(architecture × input shape) cell.

The port's counterpart of ``repro.launch.steps``. ``input_specs`` gives
meta tensors (shapes and dtypes, no allocation: the counterpart of
``ShapeDtypeStruct``); ``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` build the step functions; ``build_cell`` assembles a
(cfg, shape, mesh) cell with the reference's rule choices.

On a mesh (parameters stored as DTensors by ``param_shardings``) the
steps gather each leaf at its use and compute on plain tensors: storage
is ZeRO-3/FSDP-style, compute is redundant over ``model`` (tensor-parallel
compute is not ported). The MoE expert leaves are the exception: where
the models take their expert-parallel path they are gathered over the
data axes only and stay sharded over ``model`` (each model rank computes
its experts, ``repro_torch.models.moe``), as the reference gathers them
over fsdp inside its ``shard_map``. A train step runs this rank's rows of
the batch (the ``batch`` rule's data axes) under the rules, averages the
gradients over those axes explicitly (DTensor would not: the replicated
gradients differ between data ranks that ran different rows), and
updates each leaf in its optimizer-state layout before redistributing
the new parameter to its own; an expert leaf's gradient is its model
rank's slice and takes the same mean. Prefill and serve gather the batch
and compute it whole on every rank; the MoE's dispatch groups are still
one data shard's tokens, as the reference's.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, InputShape
from repro_torch.distributed.sharding import (
    NamedSharding,
    Rules,
    activate_rules,
    current_rules,
    param_shardings,
    placements,
)
from repro_torch.models import lm
from repro_torch.models.moe import token_shards
from repro_torch.train.optim import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
)
from repro_torch.tree import (
    tree_leaves,
    tree_map,
    tree_map_with_path,
    tree_unflatten,
)


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape,
                param_dtype=torch.bfloat16) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every input of the step function."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((b, s), torch.int32)
        specs["labels"] = _meta((b, s), torch.int32)
        if cfg.prefix_len:
            specs["prefix_embeds"] = _meta((b, cfg.prefix_len, cfg.d_model),
                                           param_dtype)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((b, s), torch.int32)
        if cfg.prefix_len:
            specs["prefix_embeds"] = _meta((b, cfg.prefix_len, cfg.d_model),
                                           param_dtype)
    elif shape.kind == "decode":
        specs["tokens"] = _meta((b, 1), torch.int32)
        specs["cache"] = lm.init_cache(cfg, b, s, torch.bfloat16)
        specs["cache_len"] = _meta((), torch.int32)
    else:
        raise ValueError(shape.kind)
    return specs


def batch_shardings(cfg: ArchConfig, shape: InputShape, rules: Rules):
    """Shardings matching input_specs."""
    specs = input_specs(cfg, shape)
    out: Dict[str, Any] = {}
    for name, sd in specs.items():
        if name == "cache":
            out[name] = lm.cache_shardings(cfg, rules, shape.global_batch,
                                           shape.seq_len)
        elif name == "cache_len":
            out[name] = NamedSharding(rules.mesh, (),
                                      placements(rules.mesh, ()))
        elif name == "prefix_embeds":
            out[name] = rules.sharding(("batch", None, None), sd.shape)
        else:
            out[name] = rules.sharding(("batch", None), sd.shape)
    return out


# --------------------------------------------------------------------------
# DTensor helpers
# --------------------------------------------------------------------------
def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def distribute(x: torch.Tensor, mesh, place) -> Any:
    """The DTensor of ``place`` whose global value is ``x``, which every
    rank holds alike: each rank keeps its own chunk (no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    rep = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    return rep.redistribute(mesh, tuple(place))


def gather(tree: Any) -> Any:
    """``tree`` with every DTensor leaf gathered into a plain tensor (a
    collective on every rank of its mesh)."""
    return tree_map(lambda x: x.full_tensor() if _is_dtensor(x) else x, tree)


_EXPERT_LEAF = re.compile(r"we_(gate|up|down)$")


def _compute_placements(path: str, x) -> tuple:
    """The placements a step computes the DTensor leaf ``x`` at ``path``
    in: ``Replicate()`` on every mesh dim, except that a MoE expert leaf
    keeps its ``model`` placement (its model rank's experts, where the
    rules shard them)."""
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names or ()
    keep = _EXPERT_LEAF.search(path.split("/")[-1]) is not None
    return tuple(pl if keep and name == "model" else Replicate()
                 for name, pl in zip(names, x.placements))


def gather_at_use(params: Any) -> Any:
    """``params`` as a step computes with them (module docstring): each
    DTensor leaf gathered whole, an expert leaf gathered over the data
    axes into its model rank's block."""
    def one(path, x):
        if not _is_dtensor(x):
            return x
        return x.redistribute(x.device_mesh,
                              _compute_placements(path, x)).to_local()
    return tree_map_with_path(one, params)


def _relayout(x: torch.Tensor, like, src: tuple, dst: tuple) -> torch.Tensor:
    """This rank's shard, in placements ``dst``, of the global tensor shaped
    as the DTensor ``like`` whose shard in placements ``src`` is ``x``
    (a local slice: ``src`` replicates every dim ``dst`` shards)."""
    from torch.distributed.tensor import DTensor
    placed = DTensor.from_local(x, like.device_mesh, src, run_check=False,
                                shape=like.shape, stride=like.stride())
    return placed.redistribute(like.device_mesh, dst).to_local()


def _rows(x: torch.Tensor, mesh, rules: Rules) -> torch.Tensor:
    """This rank's rows of a global batch leaf, as ``batch`` resolves."""
    if _is_dtensor(x):
        return x.to_local()
    sh = rules.sharding(("batch",) + (None,) * (x.ndim - 1), x.shape)
    return distribute(x, mesh, sh.placements).to_local()


# --------------------------------------------------------------------------
# steps
# --------------------------------------------------------------------------
def _value_and_grad(cfg: ArchConfig, params, tokens, labels, prefix):
    """``lm_loss`` and the gradient of every leaf (plain tensors, in each
    leaf's dtype), on detached copies of the leaves."""
    work = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = lm.lm_loss(cfg, tree_unflatten(params, work), tokens, labels,
                          prefix)
        grads = torch.autograd.grad(loss, work)
    return loss.detach(), list(grads)


def _loss_and_grads(cfg: ArchConfig, microbatches: int, params, batch):
    tokens, labels = batch["tokens"], batch["labels"]
    prefix = batch.get("prefix_embeds")
    if microbatches == 1:
        return _value_and_grad(cfg, params, tokens, labels, prefix)
    b = tokens.shape[0]
    if b % microbatches:
        raise ValueError(f"a batch of {b} rows does not split into "
                         f"{microbatches} microbatches")
    mb_sz = b // microbatches
    grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in tree_leaves(params)]
    loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for i in range(microbatches):
        def sl(x):
            return x[i * mb_sz:(i + 1) * mb_sz]
        l, g = _value_and_grad(cfg, params, sl(tokens), sl(labels),
                               None if prefix is None else sl(prefix))
        for acc, gi in zip(grads, g):
            acc.add_(gi)
        loss = loss + l
    return loss / microbatches, [g / microbatches for g in grads]


def make_train_step(cfg: ArchConfig, opt: AdamWConfig,
                    microbatches: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Microbatch ``i`` takes rows ``[i·b/m, (i+1)·b/m)``; gradients
    accumulate into f32 buffers whatever the parameter dtype and are
    divided by ``m``; the loss is the mean of the microbatch losses.
    ``params``, ``opt_state.m`` and ``opt_state.v`` are updated in place.
    With DTensor parameters (a mesh) see the module docstring."""

    def train_step(params, opt_state, batch):
        if _is_dtensor(tree_leaves(params)[0]):
            return _mesh_train_step(cfg, opt, microbatches, params,
                                    opt_state, batch)
        loss, grads = _loss_and_grads(cfg, microbatches, params, batch)
        params, opt_state = adamw_update(
            opt, params, tree_unflatten(params, grads), opt_state)
        return params, opt_state, {"loss": loss, "step": opt_state.step}

    return train_step


@torch.no_grad()
def _mesh_train_step(cfg, opt, microbatches, params, opt_state, batch):
    """The train step on DTensor parameters and optimizer state (module
    docstring): the same numbers as one rank's step on the whole batch,
    up to the order of the gradient sums (and, for a MoE, up to its
    dispatch groups, which are the data shards' rows, and the bf16 sum of
    its expert-parallel outputs)."""
    import torch.distributed as dist

    leaves = tree_leaves(params)
    mesh = leaves[0].device_mesh
    rules = current_rules() or Rules(mesh)
    local = {k: _rows(v, mesh, rules) for k, v in batch.items()}

    # the mesh dims the rows were split over
    tok = batch["tokens"]
    row_place = (tok.placements if _is_dtensor(tok) else rules.sharding(
        ("batch", None), tok.shape).placements)
    split = [mesh.mesh_dim_names[i] for i, p in enumerate(row_place)
             if p.is_shard(0)]
    n = 1
    for axis in split:
        n *= mesh.size(mesh.mesh_dim_names.index(axis))

    places = []
    tree_map_with_path(lambda path, x: places.append(
        _compute_placements(path, x)), params)
    full = gather_at_use(params)
    with activate_rules(rules), token_shards(n):
        loss, grads = _loss_and_grads(cfg, microbatches, full, local)
    grads = [g.contiguous() for g in grads]

    # the mean over the mesh dims the rows were split over
    for axis in split:
        group = mesh.get_group(axis)
        for t in grads + [loss]:
            dist.all_reduce(t, group=group)
    if n > 1:
        grads = [g / n for g in grads]
        loss = loss / n

    # the global norm: a leaf computed in its model rank's slice adds its
    # squares from every model rank
    sharded = [any(p.is_shard() for p in pl) for pl in places]
    sq = sum(torch.sum(torch.square(g.float()))
             for g, sh in zip(grads, sharded) if not sh)
    if any(sharded):
        part = sum(torch.sum(torch.square(g.float()))
                   for g, sh in zip(grads, sharded) if sh)
        dist.all_reduce(part, group=mesh.get_group("model"))
        sq = sq + part
    gnorm = torch.sqrt(sq)

    # each leaf updated in its optimizer-state layout, then redistributed
    # to its parameter layout
    ms, vs = tree_leaves(opt_state.m), tree_leaves(opt_state.v)
    p_sl = [_relayout(f, p, pl, m.placements)
            for f, p, pl, m in zip(tree_leaves(full), leaves, places, ms)]
    g_sl = [_relayout(g, p, pl, m.placements)
            for g, p, pl, m in zip(grads, leaves, places, ms)]
    step = opt_state.step
    if _is_dtensor(step):
        step = step.to_local()              # replicated: the whole value
    _, local_state = adamw_update(
        opt, p_sl, g_sl,
        AdamWState(step, [m.to_local() for m in ms],
                   [v.to_local() for v in vs]), gnorm=gnorm)
    for p, new, m in zip(leaves, p_sl, ms):
        p.to_local().copy_(_relayout(new, p, m.placements, p.placements))
    opt_state = AdamWState(step=local_state.step, m=opt_state.m,
                           v=opt_state.v)
    return params, opt_state, {"loss": loss, "step": opt_state.step}


def make_prefill_step(cfg: ArchConfig):
    def prefill_step(params, batch):
        params, batch = gather_at_use(params), gather(batch)
        logits, cache, clen = lm.prefill(cfg, params, batch["tokens"],
                                         batch.get("prefix_embeds"))
        return {"logits": logits, "cache": cache, "cache_len": clen}

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One-token decode against a seq_len KV/state cache."""

    def serve_step(params, batch):
        params, batch = gather_at_use(params), gather(batch)
        logits, cache = lm.decode_step(cfg, params, batch["cache"],
                                       batch["cache_len"], batch["tokens"])
        return {"logits": logits, "cache": cache}

    return serve_step


# --------------------------------------------------------------------------
# assembly for a (cfg, shape, mesh) cell
# --------------------------------------------------------------------------
class Cell:
    """A built cell's step: plain tensor arguments are placed by
    ``in_shardings`` (every rank passes the same global values; a DTensor
    is taken as it is), the step runs under the cell's rules, and outputs
    with an entry in ``out_shardings`` come back placed by it (``None``:
    as the step returns them). The counterpart of the reference's jitted
    cell with its argument and output shardings."""

    def __init__(self, fn, rules: Rules, in_shardings, out_shardings=None):
        self.fn = fn
        self.rules = rules
        self.in_shardings = in_shardings
        self.out_shardings = out_shardings

    def _place(self, tree, shardings):
        if shardings is None:
            return tree
        return tree_map(
            lambda x, sh: (x if _is_dtensor(x)
                           or not isinstance(x, torch.Tensor)
                           else distribute(x, sh.mesh, sh.placements)),
            tree, shardings)

    def place(self, *args):
        """``args`` placed by the cell's argument shardings."""
        return tuple(self._place(a, sh)
                     for a, sh in zip(args, self.in_shardings))

    def __call__(self, *args):
        args = self.place(*args)
        with activate_rules(self.rules):
            out = self.fn(*args)
        if self.out_shardings is None:
            return out
        return {k: self._place(v, self.out_shardings.get(k))
                for k, v in out.items()}


def build_cell(cfg: ArchConfig, shape_name: str, mesh,
               opt: Optional[AdamWConfig] = None,
               param_dtype=torch.bfloat16, microbatches: int = 1,
               zero_stage: int = 3, rule_overrides: Optional[Dict] = None):
    """Returns (:class:`Cell`, example abstract args as meta tensors,
    rules).

    Perf knobs (the reference's):
      zero_stage=3 — params FSDP-sharded over data;
      zero_stage=2 — params data-replicated, optimizer state still sharded;
      rule_overrides — logical-axis table overrides (e.g. {"head_dim":
                     (None,)}).
    Serving replicates parameters over ``data`` whenever the TP-sharded
    copy fits (param_count · 2 / model ≤ 12e9), else keeps ZeRO-3.
    """
    shape = SHAPES[shape_name]
    overrides = dict(rule_overrides or {})
    if zero_stage == 2:
        overrides["fsdp"] = (None,)
    rules = Rules(mesh, overrides or None)
    opt_rules = Rules(mesh, rule_overrides or None)  # opt state stays sharded
    if shape.kind != "train":
        model_par = rules.shape.get("model", 1)
        if cfg.param_count() * 2 / model_par <= 12e9:
            rules = Rules(mesh, overrides={"fsdp": (None,)})
    p_abs = lm.abstract_params(cfg, param_dtype)
    p_shard = param_shardings(p_abs, rules)
    b_specs = input_specs(cfg, shape, param_dtype)
    b_shard = batch_shardings(cfg, shape, rules)

    if shape.kind == "train":
        opt = opt or AdamWConfig()
        o_abs = adamw_init(p_abs)
        opt_leaf_shard = param_shardings(p_abs, opt_rules, role="opt")
        o_shard = AdamWState(
            step=NamedSharding(mesh, (), placements(mesh, ())),
            m=opt_leaf_shard, v=opt_leaf_shard)
        cell = Cell(make_train_step(cfg, opt, microbatches), rules,
                    (p_shard, o_shard, b_shard))
        args = (p_abs, o_abs, b_specs)
    elif shape.kind == "prefill":
        cell = Cell(make_prefill_step(cfg), rules, (p_shard, b_shard))
        args = (p_abs, b_specs)
    else:
        out_shard = {"logits": rules.sharding(("batch", "vocab"),
                                              (shape.global_batch,
                                               cfg.vocab)),
                     "cache": lm.cache_shardings(cfg, rules,
                                                 shape.global_batch,
                                                 shape.seq_len)}
        cell = Cell(make_serve_step(cfg), rules, (p_shard, b_shard),
                    out_shard)
        args = (p_abs, b_specs)
    return cell, args, rules
