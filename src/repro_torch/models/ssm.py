"""Mamba2 (SSD — state-space duality) mixer, chunked dual form + decode step.

The port's counterpart of ``repro.models.ssm``. Train/prefill uses the SSD
block decomposition (arXiv:2405.21060): the sequence is split into chunks
(python-unrolled); within a chunk the quadratic "attention-like" dual form
runs as products, between chunks a small recurrent state (H, hd, S) is
carried in f32. Decode is the O(1) recurrent update.

The canonical packed in_proj/conv are split into per-stream parameters
(z, x, B, C, dt — mathematically identical for a depthwise conv), with the
reference's keys.

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
from repro_torch.models.layers import Draw, Full, _promote, rms_norm

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


def mamba_block(cfg: ArchConfig, p: Params, x: torch.Tensor,
                state0=None, return_state: bool = False,
                return_cache: bool = False):
    """Full Mamba2 mixer. x: (B, L, d)."""
    s = cfg.ssm
    bsz, l, d = x.shape
    nh = s.n_heads(d)
    gs = s.n_groups * s.d_state

    z, xin, bcx, dt = _project(cfg, p, x)
    if return_cache:
        # raw (pre-conv) stream tail feeds the decode conv window
        conv_tail = torch.cat([xin, bcx], dim=-1)[:, -(s.d_conv - 1):]
    xin = _causal_conv(xin, p["conv_x"], p["conv_x_b"])
    bcx = _causal_conv(bcx, p["conv_bc"], p["conv_bc_b"])
    xh = xin.reshape(bsz, l, nh, s.head_dim)
    bmat = bcx[..., :gs].reshape(bsz, l, s.n_groups, s.d_state)
    cmat = bcx[..., gs:].reshape(bsz, l, s.n_groups, s.d_state)
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
    y = y.reshape(bsz, l, s.d_inner(d))
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if return_cache:
        return out, (conv_tail, state)
    if return_state:
        return out, state
    return out


def mamba_decode(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 conv_state: torch.Tensor, ssm_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token recurrent step.

    x: (B,1,d); conv_state: (B, d_conv-1, di + 2*G*S); ssm_state: (B,H,P,S).
    """
    s = cfg.ssm
    bsz, _, d = x.shape
    di = s.d_inner(d)
    nh = s.n_heads(d)
    gs = s.n_groups * s.d_state
    f32 = torch.float32

    z, xin, bcx, dt = _project(cfg, p, x)                     # (B,1,·)
    stream = torch.cat([xin, bcx], dim=-1)[:, 0]              # (B, di+2gs)
    # the window (and the returned conv state) take the promoted dtype, as
    # the reference's concatenate gives them
    window = torch.cat(_promote(conv_state, stream[:, None]), dim=1)
    conv_state = window[:, 1:]
    wcat = torch.cat([p["conv_x"], p["conv_bc"]], dim=1)
    bcat = torch.cat([p["conv_x_b"], p["conv_bc_b"]], dim=0)
    conv = F.silu((window * wcat[None]).sum(1) + bcat)        # (B, di+2gs)
    xh = conv[:, :di].reshape(bsz, nh, s.head_dim)
    bvec = torch.repeat_interleave(
        conv[:, di:di + gs].reshape(bsz, s.n_groups, s.d_state),
        nh // s.n_groups, dim=1)                              # (B,H,S)
    cvec = torch.repeat_interleave(
        conv[:, di + gs:].reshape(bsz, s.n_groups, s.d_state),
        nh // s.n_groups, dim=1)
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])          # (B,H)
    a = -torch.exp(p["A_log"])
    decay = torch.exp(dt * a)                                 # (B,H)
    ssm_state = (ssm_state * decay[..., None, None]
                 + torch.einsum("bh,bhs,bhp->bhps", dt, bvec.to(f32),
                                xh.to(f32)))
    y = torch.einsum("bhs,bhps->bhp", cvec.to(f32), ssm_state)
    y = y + p["D"][:, None] * xh.to(f32)
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"], conv_state, ssm_state
