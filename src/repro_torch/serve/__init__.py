"""Embedding query serving (DESIGN.md §10): the port's counterpart of
``repro.serve``.

Trained tables leave ``TrainSession`` through the split-checkpoint format
(the reference's bytes) and are served as batched nearest-neighbour /
analogy top-k directly over the *sharded* layout — per-rank partial top-k
plus a cross-rank merge, never reassembling the ``(V, d)`` table on one
device. The normalized tables stay resident in device memory and every
query batch amortizes the sweep over B queries. Serving runs on the GPU
unless the CPU is asked for by name; under a mesh, one process per rank.

Modules:

* :mod:`repro_torch.serve.index`    — :class:`EmbeddingIndex`: checkpoint
  → per-rank pre-normalized device buffers.
* :mod:`repro_torch.serve.query`    — the sharded top-k (+ the dense
  single-process oracle the parity tests compare against).
* :mod:`repro_torch.serve.snapshot` — :class:`SnapshotWatcher`: hot-swap
  from an in-progress training run's checkpoint stream.
* :mod:`repro_torch.serve.server`   — :class:`EmbeddingServer`: deadline/
  max-batch request coalescing; under a mesh, rank 0's command stream and
  the other ranks' ``serve_follower``.
* :mod:`repro_torch.serve.chaos`    — deterministic serve-side chaos
  harness (watcher kill/restart mid-swap; no dropped or torn queries).
"""
from repro_torch.serve.index import EmbeddingIndex
from repro_torch.serve.query import dense_topk, make_topk_fn
from repro_torch.serve.server import EmbeddingServer
from repro_torch.serve.snapshot import SnapshotWatcher

__all__ = ["EmbeddingIndex", "EmbeddingServer", "SnapshotWatcher",
           "dense_topk", "make_topk_fn"]
