"""node2vec / DeepWalk frontend: biased random walks over a graph.

Grover & Leskovec's node2vec is SGNS over node "sentences": walks sampled
from a graph with a second-order bias — from edge ``(prev, cur)``, the
next hop ``x`` is drawn from ``cur``'s neighbours with unnormalized weight

    1/p  if x == prev          (return)
    1    if x ~ prev           (stay close: x adjacent to prev)
    1/q  otherwise             (explore)

``p`` small → BFS-ish (structural roles), ``q`` small → DFS-ish
(communities); ``p = q = 1`` degenerates to DeepWalk's uniform walks.

The frontend is a *pure corpus adapter*: walks are generated host-side
with keyed randomness — walk ``i`` draws from
``SeedSequence([seed, _WALK_TAG, i])`` and nothing else — so the walk
corpus is a pure function of ``(graph, cfg.seed, knobs)``, and every
downstream guarantee (bit-determinism across prefetch worker counts,
vocab sharding, mixed precision) is inherited from the batching layer
unchanged, exactly like plain w2v batches. Per-epoch variation comes from
the pipeline's keyed subsample/negative streams, not from re-walking.

The port's copy of ``repro.frontends.node2vec``. Its walk steps run on
Python lists (a set of the previous node's neighbours, a running sum and
``bisect``) instead of small numpy arrays, several times faster per step,
and draw the same numbers: the same generator calls in the same order, the
same float64 weights summed in the same order and the same right-side
search, so the walks are the reference's, step for step.
"""
from __future__ import annotations

import bisect
import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.corpus import Corpus
from repro_torch.frontends.registry import FrontendSpec, Workload, register

# domain-separation tag for the per-walk rng keys (cf. data.batching's
# _SUBSAMPLE_TAG / _NEGATIVES_TAG)
_WALK_TAG = 0x4E32


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable CSR adjacency: ``indices[indptr[v]:indptr[v+1]]`` are
    node v's neighbours, sorted ascending (binary-searchable, so the
    "adjacent to prev" test in the walk bias is O(log deg))."""
    indptr: np.ndarray    # (n_nodes + 1,) int64
    indices: np.ndarray   # (n_edges,) int64, sorted within each row

    @property
    def n_nodes(self) -> int:
        return int(self.indptr.shape[0] - 1)

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def degree(self, v: int) -> int:
        return int(self.indptr[v + 1] - self.indptr[v])

    @classmethod
    def from_edges(cls, edges: Sequence[Tuple[int, int]],
                   n_nodes: Optional[int] = None,
                   undirected: bool = True) -> "Graph":
        """Build from an edge list. Duplicate edges collapse; self-loops
        are kept (a legal node2vec input — the walk can revisit)."""
        e = np.asarray(list(edges), dtype=np.int64).reshape(-1, 2)
        if undirected and e.size:
            e = np.concatenate([e, e[:, ::-1]], axis=0)
        n = int(n_nodes if n_nodes is not None
                else (e.max() + 1 if e.size else 0))
        if e.size:
            e = np.unique(e, axis=0)
            if e.min() < 0 or e.max() >= n:
                raise ValueError(f"edge endpoint out of range [0, {n})")
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, e[:, 0] + 1, 1)
        indptr = np.cumsum(indptr)
        return cls(indptr=indptr, indices=e[:, 1].copy())


def community_graph(n_communities: int = 16, nodes_per: int = 24,
                    extra_edges: int = 0, seed: int = 0) -> Graph:
    """Ring-of-cliques community graph: ``n_communities`` cliques of
    ``nodes_per`` nodes, consecutive cliques bridged by one edge (node 0
    of each to node 0 of the next), plus ``extra_edges`` random
    inter-community edges. Ground truth for quality eval: node v belongs
    to community ``v // nodes_per`` — node2vec with small q must embed
    same-clique nodes nearby."""
    edges: List[Tuple[int, int]] = []
    n = n_communities * nodes_per
    for c in range(n_communities):
        base = c * nodes_per
        for i in range(nodes_per):
            for j in range(i + 1, nodes_per):
                edges.append((base + i, base + j))
        edges.append((base, ((c + 1) % n_communities) * nodes_per))
    rng = np.random.default_rng(seed)
    for _ in range(extra_edges):
        u, v = rng.integers(0, n, 2)
        if u != v:
            edges.append((int(u), int(v)))
    return Graph.from_edges(edges, n_nodes=n)


def node2vec_walk(graph: Graph, start: int, length: int,
                  p: float, q: float,
                  rng: np.random.Generator) -> List[int]:
    """One biased walk from ``start``. Ends early at a sink (no out-
    neighbours). Pure given the rng — the determinism tests key it.

    The hop from ``(prev, cur)`` draws ``rng.random()`` once and takes the
    first neighbour whose running weight sum exceeds the draw times the
    total (the reference's ``np.searchsorted(np.cumsum(w), u,
    side="right")``); the first hop draws ``rng.integers(deg)``."""
    indptr, indices = graph.indptr, graph.indices
    w_back, w_out = 1.0 / p, 1.0 / q
    walk = [int(start)]
    prev = -1
    cur = int(start)
    prev_nbrs: List[int] = []
    for _ in range(length - 1):
        nbrs = indices[indptr[cur]:indptr[cur + 1]].tolist()
        if not nbrs:
            break
        if prev < 0:
            nxt = nbrs[rng.integers(len(nbrs))]
        else:
            adj = set(prev_nbrs)
            cdf = list(itertools.accumulate(
                w_back if x == prev else (1.0 if x in adj else w_out)
                for x in nbrs))
            i = bisect.bisect_right(cdf, rng.random() * cdf[-1])
            nxt = nbrs[min(i, len(nbrs) - 1)]
        walk.append(int(nxt))
        prev, cur, prev_nbrs = cur, int(nxt), nbrs
    return walk


def walk_corpus(graph: Graph, walks_per_node: int = 10,
                walk_length: int = 40, p: float = 1.0, q: float = 1.0,
                seed: int = 0,
                clusters: Optional[np.ndarray] = None) -> Corpus:
    """The full walk corpus: ``walks_per_node`` walks from every node, walk
    ``i`` (global index, node-major) keyed by
    ``SeedSequence([seed, _WALK_TAG, i])`` — any subset of walks can be
    regenerated independently and identically."""
    if p <= 0 or q <= 0:
        raise ValueError(f"p and q must be positive, got p={p}, q={q}")
    sentences: List[List[int]] = []
    n = graph.n_nodes
    for v in range(n):
        for r in range(walks_per_node):
            i = v * walks_per_node + r
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, _WALK_TAG, i]))
            sentences.append(node2vec_walk(graph, v, walk_length, p, q, rng))
    return Corpus(sentences=sentences, vocab_size=n, clusters=clusters)


def _build(cfg: W2VConfig, *, communities: int = 16, nodes_per: int = 24,
           walks_per_node: int = 10, walk_length: int = 40,
           p: float = 1.0, q: float = 0.5, graph: Optional[Graph] = None,
           seed: int = 0, **_ignored) -> Workload:
    if graph is None:
        graph = community_graph(communities, nodes_per, seed=seed)
        clusters = np.arange(graph.n_nodes) // nodes_per
    else:
        clusters = None
    corpus = walk_corpus(graph, walks_per_node=walks_per_node,
                         walk_length=walk_length, p=p, q=q,
                         seed=seed if seed else cfg.seed, clusters=clusters)
    # node "words" are uniform-ish in walk corpora — subsampling would only
    # delete signal, so the preset disables it (node2vec's own choice)
    cfg = dataclasses.replace(cfg, min_count=1, subsample_t=0.0)
    return Workload(name="node2vec", corpus=corpus, cfg=cfg)


register(FrontendSpec(
    name="node2vec",
    description="biased p/q random walks over a graph (DeepWalk at p=q=1)",
    corpus="edge-list graph → keyed walks",
    features=(),
    build=_build))
