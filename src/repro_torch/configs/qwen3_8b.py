"""qwen3-8b — dense, qk_norm, GQA kv=8.

[hf:Qwen/Qwen3-8B; hf] 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936.
"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=12288,
        vocab=151936,
        qk_norm=True,
        head_dim=128,
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="qwen3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        head_dim=16,
    ),
)
