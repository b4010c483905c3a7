"""Workload frontends: corpus adapters + config presets over the W2V
engine (DESIGN.md §12) — node2vec/DeepWalk random walks, PV-DM doc2vec,
and fastText-style subword bags, all emitting the existing batch schema.

The port's copy of ``repro.frontends``: numpy-only, so walks, documents,
bag tables and batches are bit-identical to the reference's."""
from repro_torch.frontends.registry import (FrontendSpec, Workload, get, names,
                                      register, specs)

__all__ = ["FrontendSpec", "Workload", "get", "names", "register", "specs"]
