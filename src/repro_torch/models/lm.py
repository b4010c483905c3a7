"""Decoder LM assembly: forward over stacked blocks, loss, prefill, decode.

The port's counterpart of ``repro.models.lm``. Layers are stacked along a
leading ``n_blocks`` dim with the reference's tree keys (``embed``, the
``blocks`` tuple of per-position stacks, ``final_norm``, ``unembed`` unless
tied), so ``repro_torch.convert.lm_params_from_reference`` carries a
reference tree across. Hybrid archs (Jamba) loop over repeating
``len(pattern)``-layer blocks with per-position parameter stacks. Where the
reference scans (``lax.scan``) the port loops in Python; ``scan_layers``
True and False are the same loop. ``cfg.remat`` checkpoints each block
(``torch.utils.checkpoint``, non-reentrant) while grads are on;
``remat_policy="dots"`` saves the plain matmuls' outputs (the reference's
``dots_with_no_batch_dims_saveable``). ``constrain`` marks the
reference's activation placements (identity on plain tensors), and
``cache_shardings`` places the decode cache by the sharding rules.

Inside ``sharding.local_shards`` on a mesh whose rules shard ``model``
the blocks compute on this rank's shards (``layers``, ``ssm``, ``moe``),
the logits are this rank's ``vocab`` block (the replicated unembed
sliced, as GSPMD's back-propagated sharding of the reference's
constrained logits) and ``lm_loss`` is a vocab-parallel cross entropy.
``prefill`` and ``decode_step`` take the cache's shardings and then
return, and read, this rank's block of every cache leaf.

``[audio]``/``[vlm]`` archs prepend precomputed ``prefix_embeds`` (the
modality-frontend stub) to the token embeddings.
"""
from __future__ import annotations

import contextvars
import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.core.trainer import resolve_device
from repro_torch.distributed.collectives import (
    block_of_replicated,
    from_replicated,
    max_over,
    sum_over_model,
)
from repro_torch.distributed.sharding import (
    constrain,
    current_rules,
    local_block,
    model_shard,
)
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    attention_block,
    attention_decode,
    init_attention,
    init_mlp,
    mlp_block,
    rms_norm,
)
from repro_torch.tree import tree_leaves, tree_map

Params = Dict


def block_pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    kinds = cfg.layer_kinds()
    pat = cfg.hybrid_pattern or (kinds[0],)
    return tuple(pat)


def n_blocks(cfg: ArchConfig) -> int:
    return cfg.n_layers // len(block_pattern(cfg))


def _uses_moe(cfg: ArchConfig, pos: int) -> bool:
    return cfg.moe is not None and cfg.d_ff > 0 and pos % cfg.moe_every == 0


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _init_layer(cfg: ArchConfig, kind: str, pos: int, nb: int, draw, full,
                dtype) -> Params:
    """One pattern position's parameters, stacked over ``nb`` blocks."""
    d = cfg.d_model
    lead = (nb,)
    p: Params = {"pre_norm": full(lead + (d,), 1.0, dtype)}
    if kind == "attn":
        p["mixer"] = init_attention(cfg, draw, full, dtype, lead)
    else:
        p["mixer"] = ssm_mod.init_mamba(cfg, draw, full, dtype, lead)
    if cfg.d_ff > 0:
        p["post_norm"] = full(lead + (d,), 1.0, dtype)
        if _uses_moe(cfg, pos):
            p["ffn"] = moe_mod.init_moe(cfg, draw, dtype, lead)
        else:
            p["ffn"] = init_mlp(d, cfg.d_ff, draw, dtype, lead)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, dtype=torch.float32,
                device=None) -> Params:
    """Parameters with the reference's keys, shapes and dtypes, drawn from a
    ``torch.Generator`` on ``device`` seeded with ``seed`` (the same seed
    draws other numbers than the reference's ``jax.random``; start from
    ``convert.lm_params_from_reference`` for parity). ``device`` is the GPU
    unless the caller asks for the CPU (``"meta"`` allocates nothing)."""
    device = resolve_device(device)
    gen = (None if device.type == "meta"
           else torch.Generator(device=device).manual_seed(seed))

    def draw(shape, scale, dt):
        return torch.randn(shape, generator=gen, dtype=dt,
                           device=device) * scale

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    pat = block_pattern(cfg)
    nb = n_blocks(cfg)
    blocks = tuple(_init_layer(cfg, kind, pos, nb, draw, full, dtype)
                   for pos, kind in enumerate(pat))
    params: Params = {
        "embed": draw((cfg.vocab, cfg.d_model), cfg.d_model ** -0.5, dtype),
        "blocks": blocks,
        "final_norm": full((cfg.d_model,), 1.0, dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = draw((cfg.d_model, cfg.vocab),
                                 cfg.d_model ** -0.5, dtype)
    return params


def abstract_params(cfg: ArchConfig, dtype=torch.bfloat16) -> Params:
    """Meta tensors of the reference's shapes and dtypes: dry-run
    parameters that allocate nothing."""
    return init_params(cfg, dtype=dtype, device="meta")


# --------------------------------------------------------------------------
# the loop over stacked blocks
# --------------------------------------------------------------------------
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy: keep plain (unbatched) matmul outputs,
    recompute everything else."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _loop_blocks(cfg: ArchConfig, body, carry, blocks_xs, remat=True):
    """``body(carry, xs_i) -> (carry, y_i)`` over the stacked blocks, each
    block checkpointed while grads are on and ``remat`` and ``cfg.remat``
    hold; returns the carry and the ys stacked along a new leading dim (or
    None).

    A checkpointed block runs in a copy of the caller's context: its
    recompute runs where the backward does, on CUDA the autograd engine's
    device thread, which does not inherit the caller's context variables
    (the active sharding rules, ``local_shards``, the MoE's
    ``token_shards``)."""
    nb = tree_leaves(blocks_xs)[0].shape[0]
    remat = remat and cfg.remat and torch.is_grad_enabled()
    kw = {}
    if remat and cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _save_dots)
    if remat:
        caller = contextvars.copy_context()

        def block(*a):
            return caller.copy().run(body, *a)
    ys = []
    for i in range(nb):
        xs = tree_map(lambda x: x[i], blocks_xs)
        if remat:
            carry, y = ckpt.checkpoint(block, carry, xs, use_reentrant=False,
                                       **kw)
        else:
            carry, y = body(carry, xs)
        ys.append(y)
    if all(y is None for y in ys):
        return carry, None
    return carry, tree_map(lambda *ls: torch.stack(ls), *ys)


# --------------------------------------------------------------------------
# forward (train / scoring)
# --------------------------------------------------------------------------
def _ffn(cfg: ArchConfig, pos: int, p: Params,
         h: torch.Tensor) -> torch.Tensor:
    if cfg.d_ff > 0:
        x = rms_norm(h, p["post_norm"], cfg.norm_eps)
        if _uses_moe(cfg, pos):
            h = h + moe_mod.moe_block(cfg, p["ffn"], x)
        else:
            h = h + mlp_block(p["ffn"], x, cfg.bf16_reduce, cfg.d_ff)
    return h


def _apply_layer(cfg: ArchConfig, kind: str, pos: int, p: Params,
                 h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = rms_norm(h, p["pre_norm"], cfg.norm_eps)
    if kind == "attn":
        mix = attention_block(cfg, p["mixer"], x, positions)
    else:
        mix = ssm_mod.mamba_block(cfg, p["mixer"], x)
    return constrain(_ffn(cfg, pos, p, h + mix), "batch", "seq", "embed")


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding lookup against a replicated table (the parameter rules
    keep ``embed`` replicated and shard its optimizer state)."""
    return constrain(F.embedding(tokens, embed), "batch", "seq", "embed")


def _embed(params: Params, tokens: torch.Tensor,
           prefix_embeds: Optional[torch.Tensor]):
    """Token embeddings with the prefix prepended, and their positions."""
    h = embed_lookup(params["embed"], tokens)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    h = constrain(h, "batch", "seq", "embed")
    b, s_total, _ = h.shape
    positions = torch.arange(s_total, device=h.device)[None].expand(
        b, s_total)
    return h, positions


def _unembed(params: Params) -> torch.Tensor:
    unembed = params.get("unembed")
    return params["embed"].T if unembed is None else unembed


def _vocab_tp(cfg: ArchConfig):
    """The model shard when the rules split the logits' ``vocab`` over
    ``model``, else None."""
    ms = model_shard()
    if ms is not None and ms.sharded("vocab", cfg.vocab):
        return ms
    return None


def _logits(cfg: ArchConfig, params: Params, h: torch.Tensor):
    """``h @ unembed``: this rank's vocab block of the logits on a model
    shard (module docstring)."""
    ms = _vocab_tp(cfg)
    if ms is None:
        return h @ _unembed(params)
    w = block_of_replicated(_unembed(params), 1, ms.group)
    return from_replicated(h, ms.group) @ w


def forward(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S_total, V), or this rank's vocab block
    of them on a model shard."""
    pat = block_pattern(cfg)
    h, positions = _embed(params, tokens, prefix_embeds)

    def body(hh, xs):
        for pos, kind in enumerate(pat):
            hh = _apply_layer(cfg, kind, pos, xs[pos], hh, positions)
        return hh, None

    h, _ = _loop_blocks(cfg, body, h, params["blocks"])
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return constrain(_logits(cfg, params, h), "batch", "seq", "vocab")


def lm_loss(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            labels: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next-token cross entropy over the token region (prefix excluded):
    the reference's max-shifted log-sum-exp, the gold logit taken with
    ``gather`` (the same value as the reference's select-and-sum). On a
    vocab-split model shard: the max over ``model`` (detached, as ``m``
    is), the exponentials' sum over ``model``, the gold logit from the
    rank holding the label."""
    logits = forward(cfg, params, tokens, prefix_embeds)
    if prefix_embeds is not None:
        logits = logits[:, prefix_embeds.shape[1]:]
    ms = _vocab_tp(cfg)
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    if ms is not None:
        m = max_over(m.float(), ms.group).to(m.dtype)
    shifted = constrain((logits - m).float(), "batch", "seq", "vocab")
    total = torch.sum(torch.exp(shifted), dim=-1)
    if ms is None:
        logz = torch.log(total)
        gold = torch.gather(shifted, -1, labels[..., None].long())[..., 0]
        return torch.mean(logz - gold)
    lo, hi = ms.block(cfg.vocab)
    logz = torch.log(sum_over_model(total, ms.group))
    rel = labels.long() - lo
    here = (rel >= 0) & (rel < hi - lo)
    gold = torch.gather(shifted, -1,
                        rel.clamp(0, hi - lo - 1)[..., None])[..., 0]
    gold = sum_over_model(torch.where(here, gold, 0.0), ms.group)
    return torch.mean(logz - gold)


# --------------------------------------------------------------------------
# KV / state caches, prefill, decode
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafShape:
    """A cache leaf's shape and dtype, with no tensor behind it."""
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def cache_shapes(cfg: ArchConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16):
    """The decode cache's tree of :class:`LeafShape`: per pattern
    position, stacked over the blocks."""
    pat = block_pattern(cfg)
    nb = n_blocks(cfg)
    hd = cfg.resolved_head_dim()
    s = cfg.ssm

    cache = []
    for kind in pat:
        if kind == "attn":
            shape = (nb, batch, max_len, cfg.n_kv_heads, hd)
            cache.append({"k": LeafShape(shape, dtype),
                          "v": LeafShape(shape, dtype)})
        else:
            conv_ch = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
            cache.append({
                "conv": LeafShape((nb, batch, s.d_conv - 1, conv_ch), dtype),
                "ssm": LeafShape((nb, batch, s.n_heads(cfg.d_model),
                                  s.head_dim, s.d_state), torch.float32),
            })
    return tuple(cache)


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="meta"):
    """The decode cache's tree: per pattern position, stacked over the
    blocks. Meta tensors by default (shapes and dtypes only)."""
    return tree_map(
        lambda leaf: torch.zeros(leaf.shape, dtype=leaf.dtype,
                                 device=device),
        cache_shapes(cfg, batch, max_len, dtype))


def zero_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """A zero cache on ``device`` (the GPU unless the caller asks for the
    CPU)."""
    return init_cache(cfg, batch, max_len, dtype, resolve_device(device))


def cache_shardings(cfg: ArchConfig, rules, batch: int, max_len: int):
    """Shardings (``repro_torch.distributed.sharding.NamedSharding``) for
    the decode cache.

    Attention KV: batch over the data axes; the sequence dim additionally
    shards over `model` when the KV heads can't (GQA kv < 16, most archs),
    and over `data` when the batch itself is unshardable (long-context
    batch=1 → sequence parallelism). Conv caches shard ``inner``, SSM
    states ``ssm_heads``."""

    def leaf(sd):
        shape = tuple(sd.shape)
        if sd.ndim == 5 and shape[2] == max_len:   # (nb,B,S,kv,hd) KV
            nb_, b, s_len, kv, hd = shape
            batch_ok = b % rules._axes_size(
                rules._present(("pod", "data"))) == 0
            kv_ok = kv % rules._axes_size(rules._present("model")) == 0
            if batch_ok and kv_ok:
                axes = ("stack", "batch", None, "kv_heads", None)
            elif batch_ok:
                axes = ("stack", "batch", "kv_seq_model", "kv_heads", None)
            else:
                axes = ("stack", None, "kv_seq", "kv_heads", None)
            return rules.sharding(axes, shape)
        if sd.ndim == 4:        # (nb, B, W, conv_ch) conv cache
            return rules.sharding(("stack", "batch", None, "inner"), shape)
        return rules.sharding(("stack", "batch", "ssm_heads", None, None),
                              shape)

    return tree_map(leaf, cache_shapes(cfg, batch, max_len))


def _spec(shardings, pos: int, key: str):
    """The spec of cache leaf ``key`` at pattern position ``pos`` without
    its stack dim, or None (one process)."""
    return None if shardings is None else shardings[pos][key].spec[1:]


def prefill(cfg: ArchConfig, params: Params, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            cache_dtype=torch.bfloat16, shardings=None):
    """Full-context forward that also builds the decode cache.

    Returns (last-token logits (B, V), cache, cache_len). With
    ``shardings`` (``cache_shardings`` of the global batch and length on
    the active rules' mesh) the cache is this rank's block of every leaf
    and the logits its vocab block (module docstring).
    """
    pat = block_pattern(cfg)
    h, positions = _embed(params, tokens, prefix_embeds)
    s_total = h.shape[1]

    def body(hh, xs):
        out_cache = []
        for pos, kind in enumerate(pat):
            p = xs[pos]
            x = rms_norm(hh, p["pre_norm"], cfg.norm_eps)
            if kind == "attn":
                mix, k, v = attention_block(cfg, p["mixer"], x, positions,
                                            return_kv=True)
                spec = _spec(shardings, pos, "k")
                if spec is not None:        # this rank's positions
                    mesh = current_rules().mesh
                    k = local_block(k, 1, spec[1], mesh)
                    v = local_block(v, 1, spec[1], mesh)
                out_cache.append({"k": k.to(cache_dtype),
                                  "v": v.to(cache_dtype)})
            else:
                mix, (conv_tail, state) = ssm_mod.mamba_block(
                    cfg, p["mixer"], x, return_cache=True,
                    conv_spec=_spec(shardings, pos, "conv"))
                out_cache.append({"conv": conv_tail.to(cache_dtype),
                                  "ssm": state})
            hh = constrain(_ffn(cfg, pos, p, hh + mix),
                           "batch", "seq", "embed")
        return hh, tuple(out_cache)

    h, cache = _loop_blocks(cfg, body, h, params["blocks"])
    h = rms_norm(h[:, -1], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h), cache, s_total


def decode_step(cfg: ArchConfig, params: Params, cache, cache_len,
                tokens: torch.Tensor, shardings=None):
    """One-token decode at position ``cache_len`` (an int). tokens (B, 1)
    -> (logits (B, V), new cache). With ``shardings`` (as ``prefill``'s)
    ``cache`` is this rank's block of every leaf, and so is the new one."""
    pat = block_pattern(cfg)
    h = constrain(embed_lookup(params["embed"], tokens),  # (B, 1, d)
                  "batch", "seq", "embed")
    cache_len = int(cache_len)

    def body(hh, xs):
        bp, cb = xs
        new_cb = []
        for pos, kind in enumerate(pat):
            p = bp[pos]
            c = cb[pos]
            x = rms_norm(hh, p["pre_norm"], cfg.norm_eps)
            if kind == "attn":
                mix, k_c, v_c = attention_decode(
                    cfg, p["mixer"], x, c["k"], c["v"], cache_len,
                    _spec(shardings, pos, "k"))
                new_cb.append({"k": k_c, "v": v_c})
            else:
                mix, conv_c, ssm_c = ssm_mod.mamba_decode(
                    cfg, p["mixer"], x, c["conv"], c["ssm"],
                    _spec(shardings, pos, "conv"))
                new_cb.append({"conv": conv_c, "ssm": ssm_c})
            hh = _ffn(cfg, pos, p, hh + mix)
        return hh, tuple(new_cb)

    # the reference's decode scan checkpoints nothing
    h, new_cache = _loop_blocks(cfg, body, h, (params["blocks"], cache),
                                remat=False)
    h = rms_norm(h[:, 0], params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, h), new_cache
