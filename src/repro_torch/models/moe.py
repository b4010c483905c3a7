"""Mixture-of-Experts FFN with capacity-factor dense dispatch.

The port's counterpart of ``repro.models.moe``'s local path (one dispatch
group): top-k routing, position-in-expert via cumsum, scatter into a
per-expert (E, C, d) buffer, grouped expert GEMMs, gather+combine.
Token-overflow beyond capacity is dropped (standard Switch/GShard
semantics): the dropped tokens land in an overflow slot that is discarded.
Arctic-style ``dense_residual`` adds a small always-on MLP in parallel.
Expert parallelism (the reference's ``shard_map`` path) is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import Draw, init_mlp, mlp_block

Params = Dict[str, torch.Tensor]


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


def moe_block(cfg: ArchConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    moe = cfg.moe
    e, k = moe.num_experts, moe.top_k
    b, s, d = x.shape
    t = b * s
    grp = 1                                  # no sharding rules: one group
    tg = t // grp                                              # tokens/group
    xf = x.reshape(grp, tg, d)

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
    buf = buf[:, :, :cap]                                      # (G, E, C, d)

    # --- expert GEMMs ---
    h = F.silu(torch.einsum("gecd,edf->gecf", buf, p["we_gate"]))
    h = h * torch.einsum("gecd,edf->gecf", buf, p["we_up"])
    h = torch.einsum("gecf,efd->gecd", h, p["we_down"])        # (G, E, C, d)

    # --- combine (group-local gather) ---
    hpad = torch.cat([h, torch.zeros((grp, e, 1, d), dtype=h.dtype,
                                     device=h.device)], dim=2)
    out = hpad[gi, flat_e, safe_pos]                           # (G, Tg*K, d)
    out = out * (gvals.reshape(grp, tg * k, 1).to(out.dtype)
                 * keep[..., None].to(out.dtype))
    out = out.reshape(grp, tg, k, d).sum(2)                    # (G, Tg, d)

    if moe.dense_residual:
        out = out + mlp_block(p["residual"], xf, cfg.bf16_reduce)
    return out.reshape(b, s, d)
