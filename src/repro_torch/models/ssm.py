"""Mamba2 (SSD — state-space duality) mixer, chunked dual form + decode step.

The port's counterpart of ``repro.models.ssm``. Train/prefill uses the SSD
block decomposition (arXiv:2405.21060): the sequence is split into chunks
(python-unrolled); within a chunk the quadratic "attention-like" dual form
runs as products, between chunks a small recurrent state (H, hd, S) is
carried in f32. Decode is the O(1) recurrent update.

The canonical packed in_proj/conv are split into per-stream parameters
(z, x, B, C, dt — mathematically identical for a depthwise conv), with the
reference's keys.

Inside ``sharding.local_shards`` on a mesh whose rules split ``inner``
over ``model`` each rank runs its block of channels and heads:
``w_x``/``w_z`` column-parallel, ``w_out`` row-parallel summed over
``model``; the replicated leaves enter through ``from_replicated``
(``w_bc`` and B/C's conv weights: B and C are computed alike on every
rank) or ``block_of_replicated`` (``w_dt``, x's conv weights, ``A_log``,
``D``, ``dt_bias``, ``norm``: this rank's channels or heads); the gated
RMSNorm's mean of squares sums over ``model``. The decode conv cache keeps
the reference's placement, an even split of the ``[x | B, C]`` channels
over ``model`` whose blocks do not line up with the x/BC boundary: each
step gathers the small (B, d_conv - 1, ·) window over ``model`` and keeps
its own block of the new one (prefill gathers the window's x part
likewise).

One deviation: the intra-chunk decay is masked before its ``exp`` rather
than after. The forward values are the reference's; the gradients stay
finite where the reference's turn NaN (a chunk long enough for the
masked ``exp`` to overflow, as the published 256 does).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, SSMConfig
from repro_torch.distributed.collectives import (
    block_of_replicated,
    from_replicated,
    gather_cat,
    sum_over_model,
)
from repro_torch.distributed.sharding import (
    ModelShard,
    axes_of,
    current_rules,
    local_block,
    model_shard,
)
from repro_torch.models.layers import (
    Draw,
    Full,
    _promote,
    head_groups,
    rms_norm,
    rms_norm_sharded,
)

Params = Dict[str, torch.Tensor]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def init_mamba(cfg: ArchConfig, draw: Draw, full: Full,
               dtype=torch.float32, lead: Tuple[int, ...] = ()) -> Params:
    s = cfg.ssm or SSMConfig()
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gs = s.n_groups * s.d_state
    sc = d ** -0.5
    f32 = torch.float32
    return {
        "w_z": draw(lead + (d, di), sc, dtype),
        "w_x": draw(lead + (d, di), sc, dtype),
        "w_bc": draw(lead + (d, 2 * gs), sc, dtype),
        "w_dt": draw(lead + (d, nh), sc, dtype),
        "conv_x": draw(lead + (s.d_conv, di), 0.1, dtype),
        "conv_bc": draw(lead + (s.d_conv, 2 * gs), 0.1, dtype),
        "conv_x_b": full(lead + (di,), 0.0, dtype),
        "conv_bc_b": full(lead + (2 * gs,), 0.0, dtype),
        "A_log": full(lead + (nh,), 0.0, f32),
        "D": full(lead + (nh,), 1.0, f32),
        "dt_bias": full(lead + (nh,), 0.0, f32),
        "norm": full(lead + (di,), 1.0, dtype),
        "w_out": draw(lead + (di, d), di ** -0.5, dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) with kernel (W, C)."""
    wlen = w.shape[0]
    pad = F.pad(x, (0, 0, wlen - 1, 0))
    out = torch.zeros_like(x)
    for j in range(wlen):
        out = out + pad[:, j:j + x.shape[1], :] * w[j]
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bmat: torch.Tensor, cmat: torch.Tensor, chunk: int,
                state0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD over (B, L, H, P) with chunk-wise dual form.

    x (B,L,H,P); dt (B,L,H) post-softplus; a (H,) negative;
    bmat/cmat (B,L,G,S) with G groups broadcast over H.
    Returns (y (B,L,H,P), final state (B,H,P,S)).
    """
    bsz, l, h, p = x.shape
    g, s = bmat.shape[2], bmat.shape[3]
    rep = h // g
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of chunk {chunk}")
    n = l // chunk
    f32 = torch.float32

    if state0 is None:
        state0 = torch.zeros((bsz, h, p, s), dtype=f32, device=x.device)

    ii = torch.arange(chunk, device=x.device)
    causal = ii[:, None] >= ii[None, :]

    def chunk_step(state, xk, dtk, bk, ck):
        dta = dtk * a                          # (B,c,H)
        cum = torch.cumsum(dta, dim=1)         # (B,c,H)
        bh = torch.repeat_interleave(bk, rep, dim=2).to(f32)   # (B,c,H,S)
        ch = torch.repeat_interleave(ck, rep, dim=2).to(f32)   # (B,c,H,S)

        # ---- intra-chunk (dual quadratic form) ----
        scores = torch.einsum("bihs,bjhs->bhij", ch, bh)      # (B,H,c,c)
        cum_t = cum.permute(0, 2, 1)                          # (B,H,c)
        # masked before the exp: above the diagonal cum_i - cum_j > 0 can
        # overflow (a long chunk), and the reference's where-after-exp then
        # backpropagates 0 * inf = NaN into every gradient; the forward
        # values are the same either way
        m = torch.exp(torch.where(
            causal[None, None],
            cum_t[:, :, :, None] - cum_t[:, :, None, :], float("-inf")))
        w = scores * m * dtk.permute(0, 2, 1)[:, :, None, :]  # × dt_j
        y_intra = torch.einsum("bhij,bjhp->bihp", w, xk.to(f32))

        # ---- inter-chunk ----
        seg = torch.exp(cum[:, -1:, :] - cum)                 # (B,c,H)
        contrib = torch.einsum("bjh,bjhs,bjhp->bhps", (seg * dtk).to(f32),
                               bh, xk.to(f32))                # (B,H,P,S)
        y_inter = torch.einsum("bihs,bhps,bih->bihp", ch, state,
                               torch.exp(cum))
        new_state = state * torch.exp(cum[:, -1])[..., None, None] + contrib
        return new_state, (y_intra + y_inter).to(x.dtype)

    state = state0
    ys = []
    for ci in range(n):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        state, yk = chunk_step(state, x[:, sl], dt[:, sl], bmat[:, sl],
                               cmat[:, sl])
        ys.append(yk)
    y = torch.cat(ys, dim=1)
    return y, state


def _project(cfg: ArchConfig, p: Params, x: torch.Tensor):
    z = x @ p["w_z"]
    xin = x @ p["w_x"]
    bcx = x @ p["w_bc"]
    dt = x @ p["w_dt"]
    return z, xin, bcx, dt


def _inner_tp(cfg: ArchConfig, p: Params) -> Optional[ModelShard]:
    """The model shard when the rules split ``inner`` over ``model`` (the
    mixer then runs on this rank's channels and heads; ``w_x`` must come
    as its block), else None; raises where the heads do not split with
    the channels."""
    ms = model_shard()
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    if ms is None or not ms.sharded("inner", di):
        return None
    ms.check(p["w_x"], 1, di)
    if s.n_heads(cfg.d_model) % ms.size:
        raise ValueError(f"{s.n_heads(cfg.d_model)} SSM heads do not split "
                         f"over {ms.size} model ranks with the channels")
    return ms


def _shard_params(cfg: ArchConfig, p: Params, ms: ModelShard) -> Params:
    """This rank's view of the mixer's leaves (module docstring)."""
    g = ms.group

    def rep(k):
        return from_replicated(p[k], g)

    def block(k, dim):
        return block_of_replicated(p[k], dim, g)

    return {"w_z": p["w_z"], "w_x": p["w_x"], "w_out": p["w_out"],
            "w_bc": rep("w_bc"), "conv_bc": rep("conv_bc"),
            "conv_bc_b": rep("conv_bc_b"), "w_dt": block("w_dt", 1),
            "conv_x": block("conv_x", 1), "conv_x_b": block("conv_x_b", 0),
            "A_log": block("A_log", 0), "D": block("D", 0),
            "dt_bias": block("dt_bias", 0), "norm": block("norm", 0)}


def _gated_norm(cfg: ArchConfig, p: Params, y: torch.Tensor,
                z: torch.Tensor, ms: Optional[ModelShard]) -> torch.Tensor:
    if ms is None:
        return rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return rms_norm_sharded(y * F.silu(z), p["norm"], cfg.norm_eps,
                            cfg.ssm.d_inner(cfg.d_model), ms.group)


def _out(p: Params, y: torch.Tensor, ms: Optional[ModelShard]):
    out = y @ p["w_out"]
    return out if ms is None else sum_over_model(out, ms.group)


def mamba_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                state0=None, return_state: bool = False,
                return_cache: bool = False, conv_spec=None):
    """Full Mamba2 mixer. x: (B, L, d). On a model shard (module
    docstring) the returned state is this rank's heads, and the conv tail
    this rank's block by ``conv_spec`` (the conv cache's spec, (batch, W,
    channels), on the active rules' mesh)."""
    s = cfg.ssm
    bsz, l, d = x.shape
    nh = s.n_heads(d)
    di = s.d_inner(d)
    gs = s.n_groups * s.d_state
    ms = _inner_tp(cfg, p)
    h_lo = 0
    if ms is not None:
        p = _shard_params(cfg, p, ms)
        x = from_replicated(x, ms.group)
        h_lo, h_hi = ms.block(nh)
        nh, di = h_hi - h_lo, di // ms.size

    z, xin, bcx, dt = _project(cfg, p, x)
    if return_cache:
        # raw (pre-conv) stream tail feeds the decode conv window
        tail = xin[:, -(s.d_conv - 1):]
        if ms is not None:
            tail = gather_cat(tail, ms.group, -1)
        conv_tail = torch.cat([tail, bcx[:, -(s.d_conv - 1):]], dim=-1)
        if conv_spec is not None:
            conv_tail = local_block(conv_tail, -1, conv_spec[-1],
                                    current_rules().mesh)
    xin = _causal_conv(xin, p["conv_x"], p["conv_x_b"])
    bcx = _causal_conv(bcx, p["conv_bc"], p["conv_bc_b"])
    xh = xin.reshape(bsz, l, nh, s.head_dim)
    hpg = s.n_heads(d) // s.n_groups               # heads a group
    bmat = head_groups(bcx[..., :gs].reshape(bsz, l, s.n_groups, s.d_state),
                       h_lo, nh, hpg)
    cmat = head_groups(bcx[..., gs:].reshape(bsz, l, s.n_groups, s.d_state),
                       h_lo, nh, hpg)
    dt = F.softplus(dt.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])

    # adaptive chunk: at most 32 chunks (python-unrolled), at least s.chunk
    chunk = min(max(s.chunk, _ceil_div(l, 32)), l)
    pad = (-l) % chunk
    if pad:
        # zero-pad to a chunk multiple; dt=0 on padding makes it a no-op for
        # the carried state (decay 1, contribution 0)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, state = ssd_chunked(xh, dt, a, bmat, cmat, chunk, state0)
    if pad:
        y = y[:, :l]
        xh = xh[:, :l]
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(bsz, l, di)
    out = _out(p, _gated_norm(cfg, p, y, z, ms), ms)
    if return_cache:
        return out, (conv_tail, state)
    if return_state:
        return out, state
    return out


def mamba_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor,
                 conv_spec=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.

    x: (B,1,d); conv_state: (B, d_conv-1, di + 2*G*S); ssm_state: (B,H,P,S).
    On a model shard the SSM state is this rank's heads, and where
    ``conv_spec`` splits the conv cache's channels over ``model`` the
    window is gathered and this rank's block of the new one returned.
    """
    s = cfg.ssm
    bsz, _, d = x.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gs = s.n_groups * s.d_state
    f32 = torch.float32
    ms = _inner_tp(cfg, p)
    split = conv_spec is not None and "model" in axes_of(conv_spec[-1])
    h_lo, h_hi, c_lo, c_hi = 0, nh, 0, di
    if ms is not None:
        p = _shard_params(cfg, p, ms)
        x = from_replicated(x, ms.group)
        h_lo, h_hi = ms.block(nh)
        c_lo, c_hi = ms.block(di)
    if split:
        conv_state = gather_cat(conv_state, current_rules().mesh.get_group(
            "model"), -1)

    z, xin, bcx, dt = _project(cfg, p, x)                     # (B,1,·)
    if ms is not None:
        xin = gather_cat(xin, ms.group, -1)
    stream = torch.cat([xin, bcx], dim=-1)[:, 0]              # (B, di+2gs)
    # the window (and the returned conv state) take the promoted dtype, as
    # the reference's concatenate gives them
    window = torch.cat(_promote(conv_state, stream[:, None]), dim=1)
    conv_state = window[:, 1:]
    if split:
        conv_state = local_block(conv_state, -1, "model",
                                 current_rules().mesh)
    wcat = torch.cat([p["conv_x"], p["conv_bc"]], dim=1)
    bcat = torch.cat([p["conv_x_b"], p["conv_bc_b"]], dim=0)
    if ms is not None:
        window = torch.cat([window[..., c_lo:c_hi], window[..., di:]], -1)
    conv = F.silu((window * wcat[None]).sum(1) + bcat)        # (B, c+2gs)
    c = c_hi - c_lo
    xh = conv[:, :c].reshape(bsz, h_hi - h_lo, s.head_dim)
    bvec = torch.repeat_interleave(
        conv[:, c:c + gs].reshape(bsz, s.n_groups, s.d_state),
        nh // s.n_groups, dim=1)[:, h_lo:h_hi]                # (B,H,S)
    cvec = torch.repeat_interleave(
        conv[:, c + gs:].reshape(bsz, s.n_groups, s.d_state),
        nh // s.n_groups, dim=1)[:, h_lo:h_hi]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])          # (B,H)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)                                 # (B,H)
    ssm_state = (ssm_state * decay[..., None, None]
                 + torch.einsum("bh,bhs,bhp->bhps", dt, bvec.to(f32),
                                xh.to(f32)))
    y = torch.einsum("bhs,bhps->bhp", cvec.to(f32), ssm_state)
    y = y + p["D"][:, None] * xh.to(f32)
    y = y.reshape(bsz, 1, c).to(x.dtype)
    return (_out(p, _gated_norm(cfg, p, y, z, ms), ms), conv_state,
            ssm_state)
