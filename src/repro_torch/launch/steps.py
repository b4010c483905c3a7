"""Train, prefill and serve steps, and abstract inputs for every
(architecture × input shape) cell.

The port's counterpart of ``repro.launch.steps``. ``input_specs`` gives
meta tensors (shapes and dtypes, no allocation: the counterpart of
``ShapeDtypeStruct``); ``make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` build the step functions; ``build_cell`` assembles a
(cfg, shape, mesh) cell with the reference's rule choices.

On a mesh (parameters stored as DTensors by ``param_shardings``) the
steps compute on local shards, as the reference's jitted cells compute
each product on its shards. A leaf whose spec shards a dimension over
``model`` along one of ``sharding.TP_AXES`` (``heads``, ``kv_heads``,
``ff``, ``inner``, ``experts``) is gathered over the data axes only, the
reference's FSDP, and the models run on this model rank's block of it
(tensor and expert parallelism: ``repro_torch.models``, inside
``sharding.local_shards``); it is never gathered over ``model`` in a
step. Every other leaf is gathered whole
(those the rules shard over ``head_dim`` among them: their attention
computes whole). Gathers and relayouts go through c10d calls in rank
order (``_redistribute``), not DTensor's collectives.

A train step runs this rank's rows of the batch (the ``batch`` rule's
data axes) under the rules, averages the gradients over those axes
explicitly (DTensor would not: the replicated gradients differ between
data ranks that ran different rows), and updates each leaf in its
optimizer-state layout before redistributing the new parameter to its
own; a model-sharded leaf's gradient is its model rank's slice and takes
the same mean, and the global norm adds those slices' squares over
``model``. Prefill and serve run this data rank's rows too, their MoE
dispatch groups the data shards' rows as the reference's; the cache
stays DTensors placed by ``lm.cache_shardings`` and is never gathered
(each rank reads and writes its own block), and the logits come out as
this rank's (``batch``, ``vocab``) block.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, InputShape
from repro_torch.distributed.collectives import gather_cat
from repro_torch.distributed.sharding import (
    TP_AXES,
    NamedSharding,
    Rules,
    _leaf_logical_axes,
    activate_rules,
    current_rules,
    local_shards,
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


def _shard_axes(place: tuple, dim: int) -> list:
    """The mesh dims (in mesh order) whose placement shards tensor dim
    ``dim``."""
    return [i for i, p in enumerate(place) if p.is_shard(dim)]


def _redistribute(x: torch.Tensor, like, src: tuple,
                  dst: tuple) -> torch.Tensor:
    """This rank's shard, in placements ``dst``, of the global tensor shaped
    as the DTensor ``like`` whose shard in placements ``src`` is ``x``
    (even shards). A tensor dim whose mesh dims differ is gathered over
    the mesh dims ``src`` splits it over and ``dst`` does not (c10d
    all-gathers in rank order, the inner mesh dim first; a mesh dim of
    one rank moves nothing), then sliced over those ``dst`` splits it
    over and ``src`` did not."""
    mesh = like.device_mesh
    names = mesh.mesh_dim_names
    for d in range(x.ndim):
        have, want = _shard_axes(src, d), _shard_axes(dst, d)
        keep = 0
        while (keep < min(len(have), len(want))
               and have[keep] == want[keep]):
            keep += 1
        for i in reversed(have[keep:]):
            if mesh.size(i) > 1:
                x = gather_cat(x, mesh.get_group(names[i]), d)
        for i in want[keep:]:
            n = mesh.size(i)
            k = x.shape[d] // n
            x = x.narrow(d, mesh.get_local_rank(names[i]) * k, k)
    return x.contiguous()


def _even(x) -> bool:
    """Whether every dim of the DTensor ``x`` splits evenly."""
    mesh = x.device_mesh
    for d, size in enumerate(x.shape):
        n = 1
        for i in _shard_axes(x.placements, d):
            n *= mesh.size(i)
        if size % n:
            return False
    return True


def gather(tree: Any) -> Any:
    """``tree`` with every DTensor leaf gathered into a plain tensor (c10d
    collectives on every rank of its mesh; even shards only)."""
    from torch.distributed.tensor import Replicate

    def one(x):
        if not _is_dtensor(x):
            return x
        if not _even(x):
            raise ValueError(f"a DTensor of {tuple(x.shape)} in uneven "
                             f"shards {x.placements}: gather takes even "
                             f"shards")
        return _redistribute(x.to_local(), x, tuple(x.placements),
                             (Replicate(),) * x.device_mesh.ndim)
    return tree_map(one, tree)


def _compute_placements(path: str, x) -> tuple:
    """The placements a step computes the DTensor leaf ``x`` at ``path``
    in: its ``model`` placement where that shards a dimension along one of
    ``TP_AXES`` (this model rank's block), ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names or ()
    logical = _leaf_logical_axes(path, x.ndim)

    def keep(name, pl):
        return (name == "model" and pl.is_shard()
                and logical[pl.dim] in TP_AXES)
    return tuple(pl if keep(name, pl) else Replicate()
                 for name, pl in zip(names, x.placements))


def gather_at_use(params: Any) -> Any:
    """``params`` as a step computes with them (module docstring): each
    DTensor leaf in its compute placements, as a plain tensor."""
    def one(path, x):
        if not _is_dtensor(x):
            return x
        return _redistribute(x.to_local(), x, tuple(x.placements),
                             _compute_placements(path, x))
    return tree_map_with_path(one, params)


def _place_local(x: torch.Tensor, sharding: NamedSharding,
                 shape) -> Any:
    """The DTensor placed by ``sharding`` of global ``shape`` whose shard
    on this rank is ``x``."""
    from torch.distributed.tensor import DTensor
    stride, acc = [], 1
    for size in reversed(tuple(shape)):
        stride.append(acc)
        acc *= size
    return DTensor.from_local(x.contiguous(), sharding.mesh,
                              sharding.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def _rows(x: torch.Tensor, mesh, rules: Rules) -> torch.Tensor:
    """This rank's rows of a global batch leaf, as ``batch`` resolves."""
    if _is_dtensor(x):
        return x.to_local()
    sh = rules.sharding(("batch",) + (None,) * (x.ndim - 1), x.shape)
    return distribute(x, mesh, sh.placements).to_local()


def _row_split(tok, mesh, rules: Rules):
    """The mesh dims a batch's rows split over (by the tokens' placement,
    or the ``batch`` rule for a plain tensor) and their product."""
    row_place = (tok.placements if _is_dtensor(tok) else rules.sharding(
        ("batch", None), tok.shape).placements)
    split = [mesh.mesh_dim_names[i] for i, p in enumerate(row_place)
             if p.is_shard(0)]
    n = 1
    for axis in split:
        n *= mesh.size(mesh.mesh_dim_names.index(axis))
    return split, n


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
    up to the order of the sums over ``model`` and of the gradient sums
    (and, for a MoE, up to its dispatch groups, which are the data shards'
    rows, and the bf16 sum of its expert-parallel outputs)."""
    import torch.distributed as dist

    leaves = tree_leaves(params)
    mesh = leaves[0].device_mesh
    rules = current_rules() or Rules(mesh)
    local = {k: _rows(v, mesh, rules) for k, v in batch.items()}
    split, n = _row_split(batch["tokens"], mesh, rules)

    places = []
    tree_map_with_path(lambda path, x: places.append(
        _compute_placements(path, x)), params)
    full = gather_at_use(params)
    with activate_rules(rules), local_shards(), token_shards(n):
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
    p_sl = [_redistribute(f, p, pl, tuple(m.placements))
            for f, p, pl, m in zip(tree_leaves(full), leaves, places, ms)]
    g_sl = [_redistribute(g, p, pl, tuple(m.placements))
            for g, p, pl, m in zip(grads, leaves, places, ms)]
    step = opt_state.step
    if _is_dtensor(step):
        step = step.to_local()              # replicated: the whole value
    _, local_state = adamw_update(
        opt, p_sl, g_sl,
        AdamWState(step, [m.to_local() for m in ms],
                   [v.to_local() for v in vs]), gnorm=gnorm)
    for p, new, m in zip(leaves, p_sl, ms):
        p.to_local().copy_(_redistribute(new, p, tuple(m.placements),
                                         tuple(p.placements)))
    opt_state = AdamWState(step=local_state.step, m=opt_state.m,
                           v=opt_state.v)
    return params, opt_state, {"loss": loss, "step": opt_state.step}


def _mesh_of(params):
    """The mesh of DTensor ``params``, or None (plain tensors)."""
    first = tree_leaves(params)[0]
    return first.device_mesh if _is_dtensor(first) else None


def _placed_cache(cfg, shard, b: int, max_len: int, cache):
    """``cache`` (this rank's blocks of a (b, max_len) cache) as the
    DTensors its shardings ``shard`` place."""
    return tree_map(lambda c, sh, m: _place_local(c, sh, m.shape), cache,
                    shard, lm.cache_shapes(cfg, b, max_len))


def _placed_logits(cfg, rules: Rules, b: int, logits):
    return _place_local(logits, rules.sharding(("batch", "vocab"),
                                               (b, cfg.vocab)),
                        (b, cfg.vocab))


def make_prefill_step(cfg: ArchConfig):
    """Full-context forward that builds the decode cache. On DTensor
    parameters see the module docstring: this data rank's rows, the
    cache and the logits as DTensors of their rank's blocks."""

    def prefill_step(params, batch):
        mesh = _mesh_of(params)
        if mesh is None:
            batch = gather(batch)
            logits, cache, clen = lm.prefill(cfg, params, batch["tokens"],
                                             batch.get("prefix_embeds"))
            return {"logits": logits, "cache": cache, "cache_len": clen}
        rules = current_rules() or Rules(mesh)
        local = {k: _rows(v, mesh, rules) for k, v in batch.items()}
        _, n = _row_split(batch["tokens"], mesh, rules)
        b = batch["tokens"].shape[0]
        s_total = batch["tokens"].shape[1] + cfg.prefix_len * (
            "prefix_embeds" in batch)
        shard = lm.cache_shardings(cfg, rules, b, s_total)
        with activate_rules(rules), local_shards(), token_shards(n):
            logits, cache, clen = lm.prefill(
                cfg, gather_at_use(params), local["tokens"],
                local.get("prefix_embeds"), shardings=shard)
        return {"logits": _placed_logits(cfg, rules, b, logits),
                "cache": _placed_cache(cfg, shard, b, s_total, cache),
                "cache_len": clen}

    return prefill_step


def _kv_len(cfg: ArchConfig, cache) -> int:
    """The KV cache's length (1 where the arch has no attention)."""
    for blk, kind in zip(cache, lm.block_pattern(cfg)):
        if kind == "attn":
            return int(blk["k"].shape[2])
    return 1


def make_serve_step(cfg: ArchConfig):
    """One-token decode against a seq_len KV/state cache. On DTensor
    parameters see the module docstring: the cache (DTensors, or plain
    tensors every rank holds alike) is read and written in this rank's
    block."""

    def serve_step(params, batch):
        mesh = _mesh_of(params)
        if mesh is None:
            batch = gather(batch)
            logits, cache = lm.decode_step(cfg, params, batch["cache"],
                                           batch["cache_len"],
                                           batch["tokens"])
            return {"logits": logits, "cache": cache}
        rules = current_rules() or Rules(mesh)
        tokens = _rows(batch["tokens"], mesh, rules)
        _, n = _row_split(batch["tokens"], mesh, rules)
        b = batch["tokens"].shape[0]
        max_len = _kv_len(cfg, batch["cache"])
        shard = lm.cache_shardings(cfg, rules, b, max_len)

        def block(c, sh):
            if _is_dtensor(c):
                return _redistribute(c.to_local(), c, tuple(c.placements),
                                     sh.placements)
            return distribute(c, mesh, sh.placements).to_local()

        cache = tree_map(block, batch["cache"], shard)
        clen = batch["cache_len"]
        clen = clen.to_local() if _is_dtensor(clen) else clen
        with activate_rules(rules), local_shards(), token_shards(n):
            logits, cache = lm.decode_step(cfg, gather_at_use(params),
                                           cache, clen, tokens,
                                           shardings=shard)
        return {"logits": _placed_logits(cfg, rules, b, logits),
                "cache": _placed_cache(cfg, shard, b, max_len, cache)}

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
