"""musicgen-large — decoder-only over EnCodec tokens (audio backbone).

[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048.
The EnCodec frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings via ``prefix_embeds``; training operates on audio-codec tokens.
"""
from repro_torch.configs.base import ArchConfig, register, shrink

CONFIG = register(
    ArchConfig(
        name="musicgen-large",
        family="audio",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=2048,
        prefix_len=64,  # precomputed conditioning frames (frontend stub)
    ),
    smoke=lambda: shrink(
        CONFIG,
        name="musicgen-smoke",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=256,
        prefix_len=4,
    ),
)
