"""Logical-axis sharding rules with divisibility-adaptive resolution.

The port's counterpart of ``repro.distributed.sharding``. Models annotate
activations with logical axis names via ``constrain`` and stay
mesh-agnostic; a surrounding ``axis_rules(mesh)`` context resolves the
names to mesh axes. Resolution drops a mesh axis when the dimension is not
divisible by it (e.g. starcoder2's 2 KV heads on a 16-way ``model`` axis →
replicated), so every architecture shards on the production mesh without
per-arch special cases. The tables and the first-fit resolution are the
reference's.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
``mesh_dim_names``, or a plain ``{name: size}`` mapping in mesh-dim order:
:class:`Rules` reads only each axis's name and size, so the 256- and
512-device production shapes resolve without a process group. ``spec``
gives the reference's per-dimension mesh axes (``None``, a name, or a
tuple of two or more names, as jax's ``PartitionSpec`` holds them);
:meth:`Rules.sharding` adds the DTensor ``placements`` on the mesh, one
per mesh dim (``Shard(tensor_dim)`` or ``Replicate()``; a dimension over
several mesh axes is split over them in mesh-dim order, the first the
major one, as jax splits it).

Parameter shardings (`param_shardings`) describe TP over ``model`` ×
FSDP/ZeRO over ``data``; optimizer state follows parameters. The port
stores parameters and optimizer state with these placements
(``repro_torch.launch.steps``) and computes on local shards: a leaf that
the rules shard over ``model`` along one of :data:`TP_AXES` is gathered
over the data axes only, and the models run their products on this
rank's block of it, with explicit sums over ``model``
(``repro_torch.distributed.collectives``). The steps say so by entering
:func:`local_shards`; inside it :func:`model_shard` gives a model
function the mesh's ``model`` group, and a leaf the rules shard over
``model`` that comes whole raises. Outside it (one process, or a caller
of a model function that holds whole leaves) the models compute whole.
Every other leaf is gathered whole. ``constrain`` redistributes only a
``DTensor`` and is the identity on the plain tensors the models compute
on.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.tree import tree_map_with_path

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# logical name -> candidate mesh axes (first-fit by divisibility)
DEFAULT_RULES: Dict[str, Tuple[MeshAxes, ...]] = {
    "batch":     (("pod", "data"), ("data",)),
    "seq":       (None,),
    "kv_seq":    (("pod", "data"), ("data",)),   # long-context KV sharding
    "kv_seq_model": ("model",),  # KV seq over model when kv heads can't
    "expert_groups": (("pod", "data"), ("data",)),  # local MoE dispatch
    "embed":     (None,),
    "heads":     ("model",),
    "kv_heads":  ("model",),
    "head_dim":  ("model",),
    "ff":        ("model",),
    "experts":   ("model",),
    "capacity":  (("pod", "data"), ("data",)),
    "vocab":     ("model",),
    # W2V cold-tail embedding rows (hot head replicated): shard over data,
    # the vocab-scaling axis of distributed.vocab_placement (DESIGN.md §8).
    # "data" only: the W2V step's collectives run over that one axis name.
    "cold_vocab": (("data",),),
    "fsdp":      (("pod", "data"), ("data",)),
    "ssm_heads": ("model",),
    "inner":     ("model",),                     # mamba d_inner
    "stack":     (None,),                        # layer-stacked leading dim
    # ZeRO sharding of the replicated embed table's optimizer state
    "vocab_opt": (("pod", "data", "model"), ("data", "model"), ("data",)),
    "d_opt":     ("model",),
}

# Right-sized parallelism for models whose per-chip compute is too small to
# amortize 16-way TP stream collectives: the whole mesh becomes one
# ZeRO-data-parallel domain.
PURE_DP_OVERRIDES: Dict[str, Tuple[MeshAxes, ...]] = {
    "batch":        (("pod", "data", "model"),),
    "fsdp":         (("pod", "data", "model"),),
    "expert_groups": (("pod", "data", "model"),),
    "vocab_opt":    (("pod", "data", "model"),),
    "heads": (None,), "kv_heads": (None,), "head_dim": (None,),
    "ff": (None,), "experts": (None,), "vocab": (None,),
    "inner": (None,), "ssm_heads": (None,), "capacity": (None,),
    "d_opt": (None,), "kv_seq_model": (None,),
}


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """``{name: size}`` of a mesh's dims in order: a ``DeviceMesh`` (by
    its ``mesh_dim_names``) or a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for the sharding rules needs "
                         "mesh_dim_names")
    return dict(zip(names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``spec`` as the reference's ``PartitionSpec``
    (one entry per tensor dim) and ``placements`` as DTensor takes them
    (one per mesh dim)."""
    mesh: Any
    spec: Spec
    placements: Tuple[Any, ...]


def placements(mesh: Any, spec: Spec) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    owner: Dict[str, int] = {}
    for d, axes in enumerate(spec):
        axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            # DTensor splits a dim over its mesh dims in mesh order
            raise ValueError(f"spec entry {axes} is not in the mesh's dim "
                             f"order {tuple(names)}")
        owner.update((a, d) for a in axes)
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


class Rules:
    def __init__(self, mesh: Any, overrides: Optional[Dict] = None):
        self.mesh = mesh
        self.shape = mesh_axes(mesh)
        self.table = dict(DEFAULT_RULES)
        if overrides:
            self.table.update(overrides)

    def _axes_size(self, axes: MeshAxes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        size = 1
        for a in axes:
            size *= self.shape.get(a, 1)
        return size

    def _present(self, axes: MeshAxes) -> MeshAxes:
        """Drop mesh axes that don't exist on this mesh (e.g. 'pod' on the
        single-pod mesh)."""
        if axes is None:
            return None
        if isinstance(axes, str):
            return axes if axes in self.shape else None
        kept = tuple(a for a in axes if a in self.shape)
        return kept or None

    # axes where uneven sharding (padding) beats replication: e.g. 24
    # attention heads on a 16-way model axis -> 2 (padded from 1.5) heads
    # per device instead of 24 replicated.
    UNEVEN_OK = frozenset({"heads", "group", "ssm_heads"})

    def resolve(self, logical: Optional[str], dim: int,
                allow_uneven: bool = True) -> MeshAxes:
        """Pick the first candidate whose size divides `dim` (or pads, for
        UNEVEN_OK axes: intermediates only; stored leaves must divide
        exactly, so param_shardings resolves with allow_uneven=False)."""
        if logical is None:
            return None
        uneven = allow_uneven and logical in self.UNEVEN_OK
        for cand in self.table.get(logical, (None,)):
            cand = self._present(cand)
            sz = self._axes_size(cand)
            if sz > 1 and (dim % sz == 0 or (uneven and dim > 1)):
                return cand
        return None

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int], allow_uneven: bool = True) -> Spec:
        used = set()
        parts = []
        for name, dim in zip(logical_axes, shape):
            axes = self.resolve(name, dim, allow_uneven)
            # a mesh axis may appear at most once in a spec
            if axes is not None:
                flat = (axes,) if isinstance(axes, str) else axes
                if any(a in used for a in flat):
                    axes = None
                else:
                    used.update(flat)
                    if len(flat) == 1:      # as PartitionSpec stores it
                        axes = flat[0]
            parts.append(axes)
        return tuple(parts)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int],
                 allow_uneven: bool = True) -> NamedSharding:
        spec = self.spec(logical_axes, shape, allow_uneven)
        return NamedSharding(self.mesh, spec, placements(self.mesh, spec))


def vocab_shard_sharding(mesh: Any, cold_pad: int) -> NamedSharding:
    """The sharding of a W2V cold-tail embedding table ``(cold_pad, d)``:
    rows over the ``data`` axis per the ``cold_vocab`` rule."""
    axes = Rules(mesh).resolve("cold_vocab", cold_pad, allow_uneven=False)
    return NamedSharding(mesh, (axes,), placements(mesh, (axes,)))


_ACTIVE: contextvars.ContextVar[Optional[Rules]] = contextvars.ContextVar(
    "sharding_rules", default=None)


@contextlib.contextmanager
def axis_rules(mesh: Any, overrides: Optional[Dict] = None):
    tok = _ACTIVE.set(Rules(mesh, overrides))
    try:
        yield _ACTIVE.get()
    finally:
        _ACTIVE.reset(tok)


@contextlib.contextmanager
def activate_rules(rules: Rules):
    """Activate a pre-built Rules instance (e.g. serve-mode overrides)."""
    tok = _ACTIVE.set(rules)
    try:
        yield rules
    finally:
        _ACTIVE.reset(tok)


def current_rules() -> Optional[Rules]:
    return _ACTIVE.get()


_LOCAL: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "local_shards", default=False)


@contextlib.contextmanager
def local_shards():
    """Inside: the caller passes every leaf that the active rules shard
    over ``model`` along one of :data:`TP_AXES` as this model rank's block
    (the steps do), and the models compute on those blocks."""
    tok = _LOCAL.set(True)
    try:
        yield
    finally:
        _LOCAL.reset(tok)


def on_local_shards() -> bool:
    """Whether a :func:`local_shards` context is active."""
    return _LOCAL.get()


# logical axes whose ``model`` placement a step keeps: the models compute
# on this rank's block of such a leaf (tensor and expert parallelism)
TP_AXES = frozenset({"heads", "kv_heads", "ff", "inner", "experts"})


def axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of a spec entry (``None``, a name or a tuple)."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place on the ``model`` axis of the active rules' mesh:
    its process ``group``, the axis ``size`` and this rank's index."""
    rules: Rules
    group: Any
    size: int
    rank: int

    def sharded(self, logical: str, n: int) -> bool:
        """Whether the rules shard a stored dimension of ``n`` along
        ``logical`` over ``model`` (as ``param_shardings`` resolves it)."""
        return "model" in axes_of(
            self.rules.resolve(logical, n, allow_uneven=False))

    def block(self, n: int) -> Tuple[int, int]:
        """This rank's ``[lo, hi)`` of a dimension of ``n`` split evenly."""
        if n % self.size:
            raise ValueError(f"a dimension of {n} does not split over "
                             f"{self.size} model ranks")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k

    def check(self, w, dim: int, n: int) -> None:
        """Raise unless the leaf ``w``, whose dimension ``dim`` is ``n`` in
        all, comes as this rank's block of it."""
        lo, hi = self.block(n)
        if w.shape[dim] != hi - lo:
            raise ValueError(f"a leaf of {w.shape[dim]} along dim {dim} "
                             f"where this model rank computes on its "
                             f"{hi - lo} of {n}")


def model_shard() -> Optional[ModelShard]:
    """The active rules' :class:`ModelShard` inside :func:`local_shards`;
    None outside it, where no rules are active, their mesh is a plain
    mapping (no process group) or its ``model`` axis has one rank."""
    rules = _ACTIVE.get()
    if (not _LOCAL.get() or rules is None
            or isinstance(rules.mesh, Mapping)):
        return None
    size = rules.shape.get("model", 1)
    if size <= 1:
        return None
    mesh = rules.mesh
    return ModelShard(rules, mesh.get_group("model"), size,
                      mesh.get_local_rank("model"))


def mesh_index(mesh: Any, axes: Sequence[str]) -> Tuple[int, int]:
    """(index, count) of this rank's block over the mesh axes ``axes``
    (mesh order, the first the major one), as DTensor splits a dimension
    over several mesh dims."""
    idx, n = 0, 1
    for a in axes:
        k = mesh.size(mesh.mesh_dim_names.index(a))
        idx, n = idx * k + mesh.get_local_rank(a), n * k
    return idx, n


def local_block(x, dim: int, axes: MeshAxes, mesh: Any):
    """This rank's block along ``dim`` of ``x`` (held whole on every rank
    of ``axes``) when the spec entry ``axes`` shards that dimension."""
    axes = axes_of(axes)
    if not axes:
        return x
    idx, n = mesh_index(mesh, axes)
    k = x.shape[dim] // n
    return x.narrow(dim, idx * k, k)


def constrain(x, *logical_axes: Optional[str]):
    """Place ``x`` by the active rules: the identity when none are active
    or ``x`` is a plain tensor; a ``DTensor`` is redistributed to the
    spec's placements on its own mesh."""
    rules = _ACTIVE.get()
    if rules is None:
        return x
    assert len(logical_axes) == x.ndim, (logical_axes, tuple(x.shape))
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    sh = rules.sharding(logical_axes, x.shape)
    if tuple(x.placements) == sh.placements:
        return x
    return x.redistribute(x.device_mesh, sh.placements)


# --------------------------------------------------------------------------
# parameter shardings (TP over 'model', FSDP over 'data')
# --------------------------------------------------------------------------
_PARAM_AXES: Tuple[Tuple[str, Optional[Tuple[Optional[str], ...]]], ...] = (
    # name regex -> logical axes of the *unstacked* parameter
    # input embed table: REPLICATED as a parameter (a local gather) but
    # ZeRO-sharded as optimizer state
    (r"embed$",            (None, None)),
    (r"unembed$",          (None, "vocab")),
    (r"wq$",               ("fsdp", "heads", "head_dim")),
    (r"w[kv]$",            ("fsdp", "kv_heads", None)),
    (r"wo$",               ("heads", "head_dim", "fsdp")),
    (r"[qk]_norm$",        (None,)),
    (r"w_router$",         (None, None)),
    (r"we_(gate|up)$",     ("experts", "fsdp", "ff")),      # MoE experts
    (r"we_down$",          ("experts", "ff", "fsdp")),
    (r"w_(gate|up)$",      ("fsdp", "ff")),                 # dense SwiGLU
    (r"w_down$",           ("ff", "fsdp")),
    (r"w_[zx]$",           ("fsdp", "inner")),              # mamba projections
    (r"w_(bc|dt)$",        ("fsdp", None)),
    (r"w_out$",            ("inner", "fsdp")),              # mamba out_proj
    (r"conv_",             None),                           # tiny -> replicate
    (r"(A_log|D|dt_bias)$", None),
    (r"norm$",             None),
)


def _leaf_logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    name = path.split("/")[-1]
    for pat, axes in _PARAM_AXES:
        if re.search(pat, name):
            if axes is None:
                return tuple([None] * ndim)
            if len(axes) == ndim:
                return axes
            if len(axes) == ndim - 1:       # layer-stacked leaf
                return ("stack",) + tuple(axes)
            return tuple([None] * ndim)
    return tuple([None] * ndim)


def param_shardings(params, rules: Rules, role: str = "param"):
    """Tree of :class:`NamedSharding` matching ``params`` (tensors or meta
    tensors). role="opt" applies the ZeRO override: the replicated embed
    table's m/v shard over the whole mesh."""

    def leaf_sharding(path: str, leaf):
        if role == "opt" and path.split("/")[-1] == "embed":
            logical = ("vocab_opt", "d_opt")
        else:
            logical = _leaf_logical_axes(path, leaf.ndim)
        # stored leaves must shard evenly (only intermediates may pad)
        return rules.sharding(logical, tuple(leaf.shape), allow_uneven=False)

    return tree_map_with_path(leaf_sharding, params)
