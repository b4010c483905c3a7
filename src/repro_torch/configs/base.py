"""Configuration system: architecture configs, input shapes, registry.

The port's copy of ``repro.configs.base`` (same classes, field names,
defaults and registry). Every assigned architecture is a selectable config
(``--arch <id>``); each config file under ``repro_torch/configs`` registers
a full-size config (built only as meta tensors by
``repro_torch.models.lm.abstract_params``, no allocation) and a reduced
``smoke()`` variant for CPU tests. Pure dataclasses: importing it loads
neither torch nor jax.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # Snowflake-Arctic style dense residual MLP alongside the MoE branch.
    dense_residual: bool = False
    dense_residual_ff: int = 0
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """A decoder-style LM backbone configuration."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # Hybrid layout: repeating block pattern, e.g. Jamba 1:7 attn:mamba.
    # Entries: "attn" | "mamba". Empty -> all-attn (or all-mamba for ssm).
    hybrid_pattern: Tuple[str, ...] = ()
    # MoE interleave: apply MoE FFN every `moe_every` layers (1 = all).
    moe_every: int = 1
    tie_embeddings: bool = False
    # vlm/audio modality stub: number of precomputed frontend embeddings
    # prepended to the token sequence (0 = none).
    prefix_len: int = 0
    norm_eps: float = 1e-5
    # --- scaling / perf knobs (not architecture identity) ---
    remat: bool = True
    remat_policy: str = "nothing"  # nothing | dots (save matmul outputs)
    # force bf16 outputs on row-parallel projections so TP partial sums
    # all-reduce in bf16 instead of XLA's f32 accumulators (halves the
    # dominant stream-collective wire bytes; perf variant)
    bf16_reduce: bool = False
    scan_layers: bool = True       # False -> python-unrolled (exact HLO cost)
    pipeline_stages: int = 1       # documented extension point (pod axis = DP)

    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def layer_kinds(self) -> List[str]:
        """Per-layer mixer kind for the full depth."""
        if self.family == "ssm":
            return ["mamba"] * self.n_layers
        if self.hybrid_pattern:
            pat = list(self.hybrid_pattern)
            assert self.n_layers % len(pat) == 0, (self.name, self.n_layers, len(pat))
            return pat * (self.n_layers // len(pat))
        return ["attn"] * self.n_layers

    def is_attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_kinds())

    def supports_long_context(self) -> bool:
        """Sub-quadratic context: pure SSM or hybrid (sparse attention layers
        use the seq-sharded decode path)."""
        kinds = self.layer_kinds()
        return ("mamba" in kinds)

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS roofline terms)."""
        d = self.d_model
        hd = self.resolved_head_dim()
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        total = emb + d  # final norm
        for i, kind in enumerate(self.layer_kinds()):
            total += d  # pre-mixer norm
            if kind == "attn":
                q = d * self.n_heads * hd
                kv = 2 * d * self.n_kv_heads * hd
                o = self.n_heads * hd * d
                total += q + kv + o
                if self.qk_norm:
                    total += 2 * hd
            else:
                s = self.ssm or SSMConfig()
                di = s.d_inner(d)
                nh = s.n_heads(d)
                # in_proj -> (z, x, B, C, dt), conv over (x, B, C), out_proj
                conv_ch = di + 2 * s.n_groups * s.d_state
                total += d * (2 * di + 2 * s.n_groups * s.d_state + nh)
                total += conv_ch * (s.d_conv + 1)   # conv weights + biases
                total += nh * 3          # A_log, D, dt_bias
                total += di              # gated norm
                total += di * d
            if self.d_ff:
                total += d  # pre-ffn norm
                ffn = 3 * d * self.d_ff  # SwiGLU
                if self.moe is not None and i % self.moe_every == 0:
                    total += d * self.moe.num_experts  # router
                    total += ffn * self.moe.num_experts
                    if self.moe.dense_residual:
                        total += 3 * d * self.moe.dense_residual_ff
                else:
                    total += ffn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of num_experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        full_ffn = 3 * d * self.d_ff
        per_layer_saving = full_ffn * (self.moe.num_experts - self.moe.top_k)
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if self.d_ff and i % self.moe_every == 0
        )
        return self.param_count() - n_moe_layers * per_layer_saving


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

_ARCH_MODULES = [
    "mamba2_1p3b",
    "moonshot_v1_16b_a3b",
    "arctic_480b",
    "starcoder2_3b",
    "deepseek_67b",
    "phi3_medium_14b",
    "qwen3_8b",
    "musicgen_large",
    "jamba_1p5_large_398b",
    "internvl2_76b",
]

_REGISTRY: Dict[str, "ArchEntry"] = {}


@dataclasses.dataclass(frozen=True)
class ArchEntry:
    config: ArchConfig
    smoke: Callable[[], ArchConfig]


def register(config: ArchConfig, smoke: Callable[[], ArchConfig]) -> ArchConfig:
    _REGISTRY[config.name] = ArchEntry(config=config, smoke=smoke)
    return config


def _load_all() -> None:
    for mod in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_arch(name: str) -> ArchConfig:
    _load_all()
    return _REGISTRY[name].config


def get_smoke(name: str) -> ArchConfig:
    _load_all()
    return _REGISTRY[name].smoke()


def list_archs() -> List[str]:
    _load_all()
    return sorted(_REGISTRY)


def cells(include_skips: bool = False) -> List[Tuple[str, str]]:
    """All (arch, shape) dry-run cells; long_500k only for sub-quadratic
    archs unless include_skips."""
    out = []
    for arch in list_archs():
        cfg = get_arch(arch)
        for shape in SHAPES:
            if shape == "long_500k" and not cfg.supports_long_context():
                if include_skips:
                    out.append((arch, shape))
                continue
            out.append((arch, shape))
    return out


def shrink(cfg: ArchConfig, **kw) -> ArchConfig:
    """Build a reduced same-family smoke config."""
    return dataclasses.replace(cfg, **kw)
