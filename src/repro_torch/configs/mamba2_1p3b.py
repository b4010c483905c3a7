"""mamba2-1.3b — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified] 48L d_model=2048 d_ff=0 vocab=50280,
ssm_state=128. Mamba2 blocks have no separate MLP (d_ff=0): the SSD mixer is
the whole layer.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="mamba2-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1),
        tie_embeddings=True,
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="mamba2-smoke",
        n_layers=2,
        d_model=64,
        vocab=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=16),
    ),
)
