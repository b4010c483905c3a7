"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Jamba places one attention layer per 8-layer block (index 4 per the paper's
figure) and applies MoE every other layer.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, register, shrink

_PATTERN = ("mamba", "mamba", "mamba", "mamba", "attn", "mamba", "mamba", "mamba")

CONFIG = register(
    ArchConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=24576,
        vocab=65536,
        moe=MoEConfig(num_experts=16, top_k=2),
        moe_every=2,
        hybrid_pattern=_PATTERN,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, n_groups=1),
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="jamba-smoke",
        n_layers=8,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16),
    ),
)
