"""phi3-medium-14b — dense, RoPE SwiGLU GQA kv=10.

[arXiv:2404.14219; unverified] 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352.
"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        d_ff=17920,
        vocab=100352,
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="phi3-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
    ),
)
