"""moonshot-v1-16b-a3b (Moonlight) — MoE 64 experts top-6.

[hf:moonshotai/Moonlight-16B-A3B; hf] 48L d_model=2048 16H (GQA kv=16)
d_ff=1408 (per expert) vocab=163840.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab=163840,
        moe=MoEConfig(num_experts=64, top_k=6),
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="moonshot-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=96,
        vocab=256,
        moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=4.0),
    ),
)
