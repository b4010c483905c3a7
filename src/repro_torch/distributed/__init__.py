"""Distributed pieces of the torch port: vocabulary placement and the
per-batch row-exchange plan (numpy, bit-identical to the reference's)."""
from repro_torch.distributed.vocab_placement import (
    VocabExchange,
    VocabPlacement,
    plan_exchange,
)

__all__ = ["VocabExchange", "VocabPlacement", "plan_exchange"]
