"""Workload-frontend registry (DESIGN.md §12).

A *frontend* adapts a non-word2vec workload into the engine's existing
batch schema: it provides a corpus (sentences of integer "tokens" — words,
graph nodes, anything SGNS-shaped), a config preset, and optionally
frontend state the batching pipeline threads through to the kernels:

* ``features`` — the ``StepInputs`` extensions this workload's batches
  carry (``"static_ctx"`` for an always-in-window doc row, ``"bags"`` for
  per-token member bags). ``registry.resolve(frontends=...)`` gates
  backends on them, so a workload can never silently run on a kernel that
  ignores half its inputs.
* ``prepare(pipeline)`` — attaches table extras after the vocabulary is
  built: ``pipeline.extra_rows`` (doc rows / n-gram buckets appended at
  ``[vocab.size, table_rows)``) and ``pipeline.bag_table``.

Everything downstream — tiling, prefetch workers, vocab sharding, mixed
precision, checkpointing — is untouched: a frontend's batches
are pure functions of ``(corpus, cfg, epoch, index)`` exactly like plain
w2v batches, so bit-determinism across worker counts is inherited, not
re-proven per workload.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.corpus import Corpus


@dataclasses.dataclass
class Workload:
    """One buildable workload: corpus + (possibly adjusted) config, plus
    the frontend state to attach to the batching pipeline."""
    name: str
    corpus: Corpus
    cfg: W2VConfig
    features: Tuple[str, ...] = ()
    # called with the constructed pipeline (vocabulary built) to attach
    # extra_rows / bag_table; None for pure corpus adapters
    prepare: Optional[Callable] = None

    def attach(self, pipeline) -> None:
        """Attach this workload's frontend state to a batching pipeline
        (idempotent; call once, right after pipeline construction)."""
        pipeline.frontend_features = self.features
        if self.prepare is not None:
            self.prepare(pipeline)


@dataclasses.dataclass(frozen=True)
class FrontendSpec:
    """Registry descriptor for one workload frontend.

    ``build(cfg, **knobs)`` returns a :class:`Workload`; every knob has a
    default so ``build(cfg)`` always works (CLI flags override). The
    ``description`` / ``corpus`` / ``features`` fields describe the
    workload for documentation tables.
    """
    name: str
    description: str      # one line, for the generated docs table
    corpus: str           # what the adapter consumes
    features: Tuple[str, ...]
    build: Callable[..., Workload]


_REGISTRY: Dict[str, FrontendSpec] = {}


def register(spec: FrontendSpec) -> FrontendSpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"frontend {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> FrontendSpec:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown workload frontend {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}")
    return _REGISTRY[name]


def names() -> Tuple[str, ...]:
    """Registered frontend names, ``w2v`` first (the default workload)."""
    _ensure_loaded()
    rest = sorted(n for n in _REGISTRY if n != "w2v")
    return ("w2v", *rest)


def specs() -> Tuple[FrontendSpec, ...]:
    """All registered specs in :func:`names` order (docs generation)."""
    return tuple(_REGISTRY[n] for n in names())


def _ensure_loaded() -> None:
    """Import the built-in frontend modules (each registers itself)."""
    from repro_torch.frontends import doc2vec, node2vec, subword  # noqa: F401


# ---------------------------------------------------------------------------
# The identity frontend: plain FULL-W2V on the synthetic cluster corpus.
# ---------------------------------------------------------------------------

def _build_w2v(cfg: W2VConfig, *, vocab: int = 8192, clusters: int = 64,
               sentences: int = 20_000, mean_len: int = 24,
               seed: int = 0, **_ignored) -> Workload:
    from repro_torch.data.corpus import synthetic_cluster_corpus
    corpus = synthetic_cluster_corpus(
        n_clusters=clusters,
        words_per_cluster=max(vocab // clusters, 1),
        n_sentences=sentences, mean_len=mean_len, seed=seed)
    return Workload(name="w2v", corpus=corpus, cfg=cfg)


register(FrontendSpec(
    name="w2v",
    description="FULL-W2V SGNS on words (the paper's workload)",
    corpus="planted-cluster sentences",
    features=(),
    build=_build_w2v))
