"""deepseek-67b — dense llama-arch, GQA kv=8.

[arXiv:2401.02954; hf] 95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab=102400,
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="deepseek-smoke",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab=256,
    ),
)
