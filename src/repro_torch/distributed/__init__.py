"""Distributed pieces of the torch port: vocabulary placement and the
per-batch row-exchange plan (numpy, bit-identical to the reference's) and
the logical-axis sharding rules (``sharding``: resolution, parameter and
cache placements, ``constrain``), re-exported here; ``collectives``,
``elastic`` (mesh plans after device loss, ``build`` into a device mesh)
and ``compression`` (int8 error feedback) are imported by name, so that
this package's import stays torch-free for the prefetch workers."""
from repro_torch.distributed.sharding import (
    axis_rules,
    constrain,
    current_rules,
    param_shardings,
    vocab_shard_sharding,
)
from repro_torch.distributed.vocab_placement import (
    VocabExchange,
    VocabPlacement,
    plan_exchange,
)

__all__ = ["axis_rules", "constrain", "current_rules", "param_shardings",
           "vocab_shard_sharding", "VocabExchange", "VocabPlacement",
           "plan_exchange"]
