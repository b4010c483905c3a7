"""internvl2-76b — InternViT + InternLM2 (VLM backbone).

[arXiv:2404.16821; unverified] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. The InternViT frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings via ``prefix_embeds``.
"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="internvl2-76b",
        family="vlm",
        n_layers=80,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab=128256,
        prefix_len=256,  # ViT patch embeddings (frontend stub)
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="internvl2-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=160,
        vocab=256,
        prefix_len=8,
    ),
)
