"""The LM substrate's models in torch: layers (RMSNorm, RoPE, chunked GQA
attention, SwiGLU), the Mamba2 SSD mixer, the capacity-factor MoE and the
decoder assembly (forward, loss, prefill, decode) — counterparts of
``repro.models`` with the reference's parameter tree."""
from repro_torch.models.lm import (
    abstract_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    lm_loss,
    prefill,
    zero_cache,
)

__all__ = [
    "abstract_params", "decode_step", "forward", "init_cache",
    "init_params", "lm_loss", "prefill", "zero_cache",
]
