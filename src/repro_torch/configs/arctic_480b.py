"""arctic-480b — 128 experts top-2 + dense residual MLP.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 (per expert) vocab=32000.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab=32000,
        moe=MoEConfig(num_experts=128, top_k=2, dense_residual=True,
                      dense_residual_ff=4864),
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="arctic-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=96,
        vocab=256,
        moe=MoEConfig(num_experts=4, top_k=2, dense_residual=True,
                      dense_residual_ff=96, capacity_factor=4.0),
    ),
)
