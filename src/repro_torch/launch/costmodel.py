"""Analytic per-device HBM-traffic model for the roofline memory term.

The port's copy of ``repro.launch.costmodel``: the reference's analytic
accounting, kept float for float, not a measurement of the port's own
traffic. The reference adopted it because its dry-run compiled on the
CPU backend, whose unfused elementwise chains overstate a TPU's HBM
traffic; the port's dry-run runs on fake tensors and has no measured
byte count at all, so the memory term comes from this model too. Its
terms follow standard roofline accounting for a step that computes on
sharded tensors (the reference's design); the port's mesh steps gather
each leaf at use instead, so for them it is a floor, not an estimate.

  * params: bf16 reads ×(fwd + remat-fwd + bwd), f32 grad RW, AdamW m/v RW,
    param write (train); single bf16 read (serve).
  * activations: per-layer residual/projection tensors RW, flash-attention
    KV block re-reads (n_q/2 passes over the causal prefix), MoE dispatch
    buffers, SSD chunk states — each counted at its sharded (per-device)
    size, forward counted twice under remat (recompute) plus backward.
  * embed/loss: one-hot contraction + vocab-sharded logits RW (f32 CE).
  * decode: full KV/state-cache read per token + params read (the classic
    decode bound), one cache-position write.

All formulas are per device per step, in bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ArchConfig, InputShape

BF16 = 2
F32 = 4


@dataclasses.dataclass
class Shards:
    batch: int      # devices sharding the batch/tokens
    model: int      # tensor-parallel degree
    fsdp: int       # parameter sharding over the data axis

    @classmethod
    def for_mesh(cls, multi_pod: bool) -> "Shards":
        return cls(batch=32 if multi_pod else 16, model=16,
                   fsdp=32 if multi_pod else 16)


def _attn_layer_bytes(cfg: ArchConfig, t_loc: int, s_ctx: int,
                      sh: Shards, training: bool) -> float:
    """Flash-attention layer activation traffic (per device)."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    nh_loc = max(1, -(-cfg.n_heads // sh.model))     # ceil: GSPMD padding
    n_q = 16
    # q,k,v,o tensors RW once each (repeated-KV layout, head-sharded)
    qkvo = 4 * t_loc * nh_loc * hd * BF16 * 2
    # flash: each q chunk re-reads its causal KV prefix -> ~n_q/2 passes
    kv_rereads = 2 * t_loc * nh_loc * hd * BF16 * (n_q / 2)
    # residual + norms on the (t, d) stream
    stream = 4 * t_loc * d * BF16
    fwd = qkvo + kv_rereads + stream
    if not training:
        return fwd
    # remat recompute + backward (dq,dk,dv + second kv sweep)
    return fwd * 2 + (qkvo + kv_rereads)


def _mlp_layer_bytes(cfg: ArchConfig, t_loc: int, sh: Shards,
                     training: bool) -> float:
    d, ff = cfg.d_model, cfg.d_ff
    ff_loc = max(1, ff // sh.model)
    fwd = (2 * t_loc * ff_loc * BF16          # gate*up hidden RW
           + 2 * t_loc * d * BF16)            # in/out stream
    return fwd * 3 if training else fwd


def _moe_layer_bytes(cfg: ArchConfig, t_loc: int, sh: Shards,
                     training: bool) -> float:
    moe = cfg.moe
    d, ff = cfg.d_model, cfg.d_ff
    e_loc = max(1, moe.num_experts // sh.model)
    t_glob = t_loc * sh.batch
    cap = max(1, int(moe.top_k * t_glob * moe.capacity_factor
                     / moe.num_experts))
    cap_loc = max(1, cap // sh.batch)
    # router logits + one-hot cumsum + dispatch/combine buffers
    route = t_loc * moe.num_experts * (F32 + 4)          # logits + position
    buf = e_loc * cap_loc * d * BF16 * 2 * 2             # dispatch+combine RW
    hidden = e_loc * cap_loc * (ff // 1) * BF16 * 2      # expert hidden
    fwd = route + buf + hidden
    if moe.dense_residual:
        ffr = moe.dense_residual_ff // sh.model
        fwd += 2 * t_loc * max(ffr, 1) * BF16 + 2 * t_loc * d * BF16
    return fwd * 3 if training else fwd


def _ssm_layer_bytes(cfg: ArchConfig, t_loc: int, sh: Shards,
                     training: bool) -> float:
    s = cfg.ssm
    d = cfg.d_model
    di_loc = max(1, s.d_inner(d) // sh.model)
    nh_loc = max(1, s.n_heads(d) // sh.model)
    gs = s.n_groups * s.d_state
    # z, x streams + conv + B,C,dt + chunked states
    streams = (2 * t_loc * di_loc * BF16 * 2     # z, x RW
               + 2 * t_loc * gs * BF16 * 2       # B, C
               + t_loc * nh_loc * F32 * 2)       # dt
    chunk = max(s.chunk, 1)
    n_chunks = max(1, t_loc // max(chunk, 1))
    states = n_chunks * nh_loc * s.head_dim * s.d_state * F32 * 2
    scores = t_loc * chunk * nh_loc * F32        # intra-chunk quadratic blocks
    fwd = streams + states + scores + 2 * t_loc * d * BF16
    return fwd * 3 if training else fwd


def _embed_loss_bytes(cfg: ArchConfig, t_loc: int, sh: Shards,
                      training: bool) -> float:
    v_loc = max(1, cfg.vocab // sh.model)
    d = cfg.d_model
    emb = cfg.vocab * d // (sh.model) * BF16          # table read (sharded)
    onehot = t_loc * v_loc * BF16
    logits = t_loc * v_loc * (BF16 + F32)             # logits + f32 shifted
    fwd = emb + onehot + logits + t_loc * d * BF16
    if not training:
        return fwd
    return fwd * 2 + logits                           # bwd softmax pass


def _param_opt_bytes(cfg: ArchConfig, sh: Shards, training: bool) -> float:
    n_loc = cfg.param_count() / (sh.model * (sh.fsdp if training else 1))
    if not training:
        # serving: params sharded over model only, read once
        return cfg.param_count() / sh.model * BF16
    reads = 3 * BF16          # fwd + remat + bwd
    grad = 2 * F32            # write + read
    opt = 4 * F32             # m RW + v RW
    upd = BF16                # param write
    return n_loc * (reads + grad + opt + upd)


def _cache_bytes(cfg: ArchConfig, shape: InputShape, sh: Shards) -> float:
    """Decode: the whole cache is read once per token (+1 position write)."""
    b_loc = max(1, shape.global_batch // sh.batch)
    s_ctx = shape.seq_len
    hd = cfg.resolved_head_dim()
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            kv_loc = max(1, cfg.n_kv_heads // sh.model) \
                if cfg.n_kv_heads % sh.model == 0 else cfg.n_kv_heads
            seq_shard = 1
            if shape.global_batch < sh.batch:      # batch unshardable ->
                seq_shard = sh.batch               # kv_seq sharding
            total += 2 * b_loc * (s_ctx / seq_shard) * kv_loc * hd * BF16
        else:
            s = cfg.ssm
            nh_loc = max(1, s.n_heads(cfg.d_model) // sh.model)
            total += b_loc * nh_loc * s.head_dim * s.d_state * F32 * 2
            total += b_loc * (s.d_conv - 1) * (
                s.d_inner(cfg.d_model) // sh.model + 2 * s.n_groups
                * s.d_state) * BF16
    return total


def memory_bytes(cfg: ArchConfig, shape: InputShape,
                 multi_pod: bool = False) -> Dict[str, float]:
    """Per-device HBM bytes for one step of this cell."""
    sh = Shards.for_mesh(multi_pod)
    training = shape.kind == "train"
    if shape.kind == "decode":
        t_loc = max(1, shape.global_batch // sh.batch)   # 1 token/seq
    else:
        t_loc = shape.global_batch * shape.seq_len // sh.batch

    layers = 0.0
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "attn" and shape.kind != "decode":
            layers += _attn_layer_bytes(cfg, t_loc, shape.seq_len, sh,
                                        training)
        elif kind == "mamba" and shape.kind != "decode":
            layers += _ssm_layer_bytes(cfg, t_loc, sh, training)
        if cfg.d_ff > 0 and shape.kind != "decode":
            if cfg.moe is not None and i % cfg.moe_every == 0:
                layers += _moe_layer_bytes(cfg, t_loc, sh, training)
            else:
                layers += _mlp_layer_bytes(cfg, t_loc, sh, training)

    out = {
        "params_opt": _param_opt_bytes(cfg, sh, training),
        "layers": layers,
        "embed_loss": _embed_loss_bytes(cfg, t_loc, sh, training),
        "cache": _cache_bytes(cfg, shape, sh) if shape.kind == "decode"
                 else 0.0,
    }
    out["total"] = sum(out.values())
    return out
