"""Core transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU.

The port's counterpart of ``repro.models.layers``, in plain torch ops (the
reference computes these outside any Pallas kernel). Attention keeps the
reference's algorithm: an online softmax over statically unrolled query and
key chunks, so the full S×S score matrix is never materialized and the
rounding order stays close to the reference's. No fused attention library
is used: it would be another algorithm.

Inside ``sharding.local_shards`` on a mesh whose rules shard ``model``
the blocks compute on this rank's shards: attention on its q heads (and
its KV heads where the rules shard them, else the KV groups its heads
read out of K/V computed alike on every rank), the SwiGLU MLP on its
``ff`` block, each closed by a row-parallel product summed over
``model`` in rank order; the input and every replicated weight enter
through ``from_replicated`` (``repro_torch.distributed.collectives``).
Where the rules do not shard the heads (``head_dim`` instead: the step
gathers those leaves), attention computes whole on every rank. Decode
reads and writes only this rank's block of the KV cache; where the
cache's positions are split over mesh axes, each rank's partial softmax
is combined over them.

Parameters are trees of tensors with the reference's keys and shapes;
``init_*`` take a ``draw(shape, scale, dtype)`` function (a seeded normal
times ``scale``) and the tensor factory ``full(shape, value, dtype)``, so
the same code builds real tensors and meta tensors (``lm.abstract_params``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.collectives import (
    from_replicated,
    gather_cat,
    max_over,
    sum_over_model,
)
from repro_torch.distributed.sharding import (
    ModelShard,
    axes_of,
    constrain,
    current_rules,
    mesh_index,
    model_shard,
)

Params = Dict[str, torch.Tensor]
Draw = Callable[[Tuple[int, ...], float, torch.dtype], torch.Tensor]
Full = Callable[[Tuple[int, ...], float, torch.dtype], torch.Tensor]


def _promote(*xs: torch.Tensor):
    """The tensors in their common dtype (jnp's promotion: f32 with bf16
    is f32), as an einsum of mixed dtypes needs."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return tuple(x.to(dt) for x in xs)


# --------------------------------------------------------------------------
# norms / rotary
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rms_norm_sharded(x: torch.Tensor, scale: torch.Tensor, eps: float,
                     n: int, group) -> torch.Tensor:
    """:func:`rms_norm` over a last dim of ``n`` split across ``group``:
    ``x`` and ``scale`` are this rank's block, and the mean of squares
    sums over the group both ways (its consumers are rank-specific)."""
    dt = x.dtype
    x = x.float()
    ss = torch.sum(x * x, dim=-1, keepdim=True)
    var = from_replicated(sum_over_model(ss, group), group) / n
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Half-split
    rotary (the first and second halves of ``hd`` rotate together)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., :, None, None].float() * freqs    # (...,S,1,hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, causal, chunked)
# --------------------------------------------------------------------------
def init_attention(cfg: ArchConfig, draw: Draw, full: Full,
                   dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    d, nh, nkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim()
    s = d ** -0.5
    p = {
        "wq": draw(lead + (d, nh, hd), s, dtype),
        "wk": draw(lead + (d, nkv, hd), s, dtype),
        "wv": draw(lead + (d, nkv, hd), s, dtype),
        "wo": draw(lead + (nh, hd, d), (nh * hd) ** -0.5, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = full(lead + (hd,), 1.0, dtype)
        p["k_norm"] = full(lead + (hd,), 1.0, dtype)
    return p


def _qkv(cfg: ArchConfig, p: Params, x: torch.Tensor,
         positions: torch.Tensor, ms: Optional[ModelShard] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v, normed and roped. On a model shard ``ms`` (heads split
    over ``model``) q is this rank's heads and k, v its KV heads where the
    rules shard them, else every KV head; ``x`` and the replicated
    weights enter through ``from_replicated``."""
    wq, wk, wv = p["wq"], p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if ms is not None:
        g = ms.group
        x = from_replicated(x, g)
        if not ms.sharded("kv_heads", cfg.n_kv_heads):
            wk, wv = from_replicated(wk, g), from_replicated(wv, g)
        if cfg.qk_norm:
            q_norm, k_norm = from_replicated(q_norm, g), from_replicated(
                k_norm, g)
    q = torch.einsum("bsd,dhk->bshk", x, wq)
    k = torch.einsum("bsd,dhk->bshk", x, wk)
    v = torch.einsum("bsd,dhk->bshk", x, wv)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    v = constrain(v, "batch", "seq", "kv_heads", None)
    if cfg.qk_norm:
        q = rms_norm(q, q_norm, cfg.norm_eps)
        k = rms_norm(k, k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _heads_tp(cfg: ArchConfig, p: Params) -> Optional[ModelShard]:
    """The model shard when the rules split the q heads over ``model``
    (attention then runs on this rank's heads; ``wq`` must come as its
    block), else None."""
    ms = model_shard()
    if ms is None or not ms.sharded("heads", cfg.n_heads):
        return None
    ms.check(p["wq"], 1, cfg.n_heads)
    return ms


def _kv_lo(cfg: ArchConfig, ms: Optional[ModelShard]) -> int:
    """The first KV head this rank holds (its block where the rules shard
    the KV heads, else 0: all of them)."""
    if ms is not None and ms.sharded("kv_heads", cfg.n_kv_heads):
        return ms.block(cfg.n_kv_heads)[0]
    return 0


def head_groups(t: torch.Tensor, h_lo: int, nq: int, g: int,
                lo: int = 0) -> torch.Tensor:
    """The heads (dim 2 of ``t``, whose first is head ``lo``) that the q
    heads ``[h_lo, h_lo + nq)`` read, head ``j`` reading ``j // g``: the
    groups themselves where the q heads cover whole groups or fall in
    one, else one per q head. The q heads pair with them as
    ``q.reshape(..., n, nq // n, hd)``, ``n`` the heads returned."""
    first, last = h_lo // g, (h_lo + nq - 1) // g
    if h_lo % g == 0 and nq % g == 0:
        return t[:, :, first - lo:last + 1 - lo]
    if first == last:
        return t[:, :, first - lo:first + 1 - lo]
    idx = torch.arange(h_lo, h_lo + nq, device=t.device) // g - lo
    return t.index_select(2, idx)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     n_q_chunks: int = 16,
                     n_kv_chunks: int = 8) -> torch.Tensor:
    """Flash-style causal attention, statically unrolled.

    Online softmax over kv chunks inside a python loop over q chunks: the
    full S×S probability matrix is never materialized (the transient is
    qc×kc per step), and causally dead kv chunks are skipped. GQA is
    flattened: k/v are repeated to the full head count. Products accumulate
    in f32; the softmax state (m, l, acc) is f32.

    q: (B,Sq,nh,hd), k/v: (B,Sk,nkv,hd); self-attention (q_offset = 0).
    """
    b, sq, nh, hd = q.shape
    sk = k.shape[1]
    nkv = k.shape[2]
    scale = hd ** -0.5
    k = constrain(torch.repeat_interleave(k, nh // nkv, dim=2),
                  "batch", "seq", "heads", None)
    v = constrain(torch.repeat_interleave(v, nh // nkv, dim=2),
                  "batch", "seq", "heads", None)
    qc = max(1, _ceil_div(sq, n_q_chunks))
    kc = max(1, _ceil_div(sk, n_kv_chunks))

    out_chunks = []
    for qi in range(_ceil_div(sq, qc)):
        q0, q1 = qi * qc, min((qi + 1) * qc, sq)
        q_blk = q[:, q0:q1]
        qlen = q1 - q0
        m = torch.full((b, qlen, nh), float("-inf"), dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, qlen, nh), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, qlen, nh, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(_ceil_div(min(q1, sk), kc)):
            k0, k1 = ki * kc, min((ki + 1) * kc, sk)
            k_blk = k[:, k0:k1]
            v_blk = v[:, k0:k1]
            logits = torch.einsum("bqhd,bkhd->bqhk",
                                  q_blk.float(), k_blk.float()) * scale
            if k1 > q0:                          # chunk touches the diagonal
                qpos = q0 + torch.arange(qlen, device=q.device)
                kpos = k0 + torch.arange(k1 - k0, device=q.device)
                mask = kpos[None, :] <= qpos[:, None]
                logits = torch.where(mask[:, None, :][None], logits,
                                     float("-inf"))
            m_new = torch.maximum(m, logits.amax(-1))
            safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(logits - safe_m[..., None])
            p = torch.where(torch.isfinite(logits), p, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - safe_m),
                                0.0)
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bqhk,bkhd->bqhd", p.to(v_blk.dtype).float(),
                              v_blk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out_chunks.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.cat(out_chunks, dim=1)
    return constrain(out.to(q.dtype), "batch", "seq", "heads", None)


def attention_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor, return_kv: bool = False):
    """Causal self-attention and its output projection. On a model shard
    (module docstring) this rank's heads, ``wo`` row-parallel and summed
    over ``model``; ``return_kv`` gives the K/V this rank computed (its
    KV heads, or all of them)."""
    ms = _heads_tp(cfg, p)
    q, k, v = _qkv(cfg, p, x, positions, ms)
    if ms is None:
        o = causal_attention(q, k, v)
    else:
        h_lo, h_hi = ms.block(cfg.n_heads)
        g, lo = cfg.n_heads // cfg.n_kv_heads, _kv_lo(cfg, ms)
        o = causal_attention(q, head_groups(k, h_lo, h_hi - h_lo, g, lo),
                             head_groups(v, h_lo, h_hi - h_lo, g, lo))
    b, s, nh, hd = o.shape
    out = rp_dot(o.reshape(b, s, nh * hd), p["wo"].reshape(nh * hd, -1),
                 cfg.bf16_reduce)
    if ms is not None:
        out = sum_over_model(out, ms.group)
    if return_kv:
        return out, k, v
    return out


def _softmax_over(logits: torch.Tensor, valid: torch.Tensor,
                  vc: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``softmax(logits) @ vc`` over positions split across the ranks of
    ``groups`` (each holding its block; logits (B,1,k,g,S_loc), vc
    (B,S_loc,k,hd)): the max over every rank, then the sum of the
    exponentials and the weighted V summed over them in rank order. A
    rank with no valid position adds nothing."""
    m = logits.amax(-1, keepdim=True).float()
    for grp in groups:
        m = max_over(m, grp)
    p = torch.where(valid, torch.exp(logits.float() - m), 0.0)
    den = p.sum(-1, keepdim=True)
    for grp in groups:
        den = sum_over_model(den, grp)
    w = (p / den).to(vc.dtype)
    o = torch.einsum("bqkgs,bskh->bqkgh", w.float(), vc.float())
    for grp in groups:
        o = sum_over_model(o, grp)
    return o.to(vc.dtype)


def attention_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, spec: Optional[Tuple] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode. x: (B,1,d); caches: (B,S,nkv,hd); returns the
    output and the updated caches (new tensors, as the reference's).

    ``spec``: the caches' spec (batch, seq, kv_heads, None) on the active
    rules' mesh, where the caller holds this rank's block of them. The
    new K/V goes only into the block holding position ``cache_len``.
    Where the positions are split over mesh axes, every head this rank
    needs attends over its positions and the partial softmax combines
    over those axes; split over ``model`` with the heads split too, that
    is every head (q gathered over ``model``), and each rank keeps its
    own for the row-parallel ``wo``."""
    b, _, d = x.shape
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    s_loc = k_cache.shape[1]
    cache_len = int(cache_len)
    ms = _heads_tp(cfg, p)
    seq_axes = axes_of(spec[1]) if spec is not None else ()
    s_idx, n_seq = (mesh_index(current_rules().mesh, seq_axes)
                    if seq_axes else (0, 1))
    s0, s_max = s_idx * s_loc, s_loc * n_seq
    pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, pos, ms)
    # dynamic_update_slice clamps the start so the update fits
    at = min(max(cache_len, 0), s_max - 1) - s0
    if 0 <= at < s_loc:
        k_cache = torch.cat([k_cache[:, :at], k.to(k_cache.dtype),
                             k_cache[:, at + 1:]], dim=1)
        v_cache = torch.cat([v_cache[:, :at], v.to(v_cache.dtype),
                             v_cache[:, at + 1:]], dim=1)
    h_lo, nq = 0, nh
    if ms is not None:
        h_lo, h_hi = ms.block(nh)
        nq = h_hi - h_lo
    # the q heads that attend here: every head where the positions are
    # split over ``model`` (q gathered), else this rank's
    qa_lo, nqa = h_lo, nq
    if ms is not None and "model" in seq_axes:
        q = gather_cat(q, ms.group, 2)
        qa_lo, nqa = 0, nh
    g, lo = nh // nkv, _kv_lo(cfg, ms)
    kc = head_groups(k_cache, qa_lo, nqa, g, lo)
    vc = head_groups(v_cache, qa_lo, nqa, g, lo)
    qg = q.reshape(b, 1, kc.shape[2], nqa // kc.shape[2], q.shape[-1])
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgh,bskh->bqkgs", *_promote(qg, kc)) * scale
    valid = s0 + torch.arange(s_loc, device=x.device) <= cache_len   # (S,)
    valid = valid[None, None, None, None, :]
    logits = torch.where(valid, logits, -1e30)
    if seq_axes:
        mesh = current_rules().mesh
        o = _softmax_over(logits, valid, vc,
                          [mesh.get_group(a) for a in seq_axes[::-1]])
    else:
        w = torch.softmax(logits.float(), -1).to(vc.dtype)
        o = torch.einsum("bqkgs,bskh->bqkgh", w, vc)
    o = o.reshape(b, 1, nqa, q.shape[-1])
    if ms is None:
        return (torch.einsum("bshk,hkd->bsd", *_promote(o, p["wo"])),
                k_cache, v_cache)
    o = o[:, :, h_lo - qa_lo:h_lo - qa_lo + nq]
    out = sum_over_model(torch.einsum("bshk,hkd->bsd",
                                      *_promote(o, p["wo"])), ms.group)
    return out, k_cache, v_cache


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------
def init_mlp(d: int, ff: int, draw: Draw, dtype=torch.float32,
             lead: Tuple[int, ...] = ()) -> Params:
    return {
        "w_gate": draw(lead + (d, ff), d ** -0.5, dtype),
        "w_up": draw(lead + (d, ff), d ** -0.5, dtype),
        "w_down": draw(lead + (ff, d), ff ** -0.5, dtype),
    }


def rp_dot(a: torch.Tensor, b: torch.Tensor, bf16_out: bool) -> torch.Tensor:
    """Row-parallel projection (contraction over the last dim of ``a``).
    ``bf16_out`` casts the f32 product to bf16, as the reference's
    ``preferred_element_type`` (which may round the last bit otherwise)."""
    out = torch.matmul(a, b)
    return out.to(torch.bfloat16) if bf16_out else out


def mlp_block(p: Params, x: torch.Tensor, bf16_reduce: bool = False,
              ff: Optional[int] = None) -> torch.Tensor:
    """SwiGLU. On a model shard whose rules split ``ff`` (the leaves'
    hidden width, which a caller on a model-sharded mesh must give) over
    ``model``, given this rank's blocks of the leaves: ``w_gate``/``w_up``
    column-parallel, ``w_down`` row-parallel, its partials (bf16 with
    ``bf16_reduce``) summed over ``model``."""
    ms = model_shard()
    if ms is not None and ff is None:
        raise ValueError("mlp_block on a model-sharded mesh needs ff, the "
                         "leaves' hidden width")
    if ms is not None and not ms.sharded("ff", ff):
        ms = None
    if ms is not None:
        ms.check(p["w_gate"], -1, ff)
        x = from_replicated(x, ms.group)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    out = rp_dot(h, p["w_down"], bf16_reduce)
    return out if ms is None else sum_over_model(out, ms.group)
