"""Core transformer layers: RMSNorm, RoPE, GQA attention, SwiGLU.

The port's counterpart of ``repro.models.layers``, in plain torch ops (the
reference computes these outside any Pallas kernel). Attention keeps the
reference's algorithm: an online softmax over statically unrolled query and
key chunks, so the full S×S score matrix is never materialized and the
rounding order stays close to the reference's. No fused attention library
is used: it would be another algorithm.

Parameters are trees of tensors with the reference's keys and shapes;
``init_*`` take a ``draw(shape, scale, dtype)`` function (a seeded normal
times ``scale``) and the tensor factory ``full(shape, value, dtype)``, so
the same code builds real tensors and meta tensors (``lm.abstract_params``).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import constrain

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
         positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    v = constrain(v, "batch", "seq", "kv_heads", None)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _grouped(q: torch.Tensor, nkv: int) -> torch.Tensor:
    """(B,S,nh,hd) -> (B,S,nkv,group,hd)."""
    b, s, nh, hd = q.shape
    return q.reshape(b, s, nkv, nh // nkv, hd)


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
    q, k, v = _qkv(cfg, p, x, positions)
    o = causal_attention(q, k, v)
    b, s, nh, hd = o.shape
    out = rp_dot(o.reshape(b, s, nh * hd),
                 p["wo"].reshape(nh * hd, -1), cfg.bf16_reduce)
    if return_kv:
        return out, k, v
    return out


def attention_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token decode. x: (B,1,d); caches: (B,S,nkv,hd); returns the
    output and the updated caches (new tensors, as the reference's)."""
    b, _, d = x.shape
    s_max = k_cache.shape[1]
    cache_len = int(cache_len)
    pos = torch.full((b, 1), cache_len, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, pos)
    # dynamic_update_slice clamps the start so the update fits
    at = min(max(cache_len, 0), s_max - 1)
    k_cache = torch.cat([k_cache[:, :at], k.to(k_cache.dtype),
                         k_cache[:, at + 1:]], dim=1)
    v_cache = torch.cat([v_cache[:, :at], v.to(v_cache.dtype),
                         v_cache[:, at + 1:]], dim=1)
    nkv = k_cache.shape[2]
    qg = _grouped(q, nkv)                                     # (B,1,nkv,g,hd)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqkgh,bskh->bqkgs", *_promote(qg, k_cache)) * scale
    valid = torch.arange(s_max, device=x.device) <= cache_len     # (S,)
    logits = torch.where(valid[None, None, None, None, :], logits, -1e30)
    w = torch.softmax(logits.float(), -1).to(v_cache.dtype)
    o = torch.einsum("bqkgs,bskh->bqkgh", w, v_cache)
    o = o.reshape(b, 1, cfg.n_heads, q.shape[-1])
    return (torch.einsum("bshk,hkd->bsd", *_promote(o, p["wo"])),
            k_cache, v_cache)


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


def mlp_block(p: Params, x: torch.Tensor,
              bf16_reduce: bool = False) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return rp_dot(h, p["w_down"], bf16_reduce)
