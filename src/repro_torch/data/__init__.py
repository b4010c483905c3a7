"""Host batching pipeline: numpy copies of ``repro.data`` modules.

The reference's exports, each imported with its module on first use, so
that importing this package (as a process prefetch worker does) loads
no torch.
"""
import importlib

_EXPORTS = {
    "Batch": "repro_torch.data.batching",
    "BatchingPipeline": "repro_torch.data.batching",
    "NegativeSampler": "repro_torch.data.negatives",
    "Vocab": "repro_torch.data.vocab",
    "synthetic_cluster_corpus": "repro_torch.data.corpus",
    "synthetic_zipf_corpus": "repro_torch.data.corpus",
}
__all__ = list(_EXPORTS)


def __getattr__(name: str):
    """Import the module that defines an exported name on its first use."""
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_EXPORTS[name]), name)
    globals()[name] = value
    return value
