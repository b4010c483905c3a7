"""Engine API: backend registry, capability descriptors, ``StepInputs``.

The port's counterpart of ``repro.kernels.registry``. Every kernel variant
— the plain torch versions and the CUDA kernels — registers a
:class:`KernelBackend` descriptor declaring what it needs (a host tile
plan?) and what it supports; resolution ("auto", sequential->tiled
mapping, invalid-combination errors) happens once, here, with the
reference's rules and the GPU in place of the TPU:

=================  ==================  ================================
port backend       reference backend   runs
=================  ==================  ================================
``torch``          ``jnp``             ``kernels.ref.batch_sgns_ref``
``torch_tiled``    ``jnp_tiled``       ``kernels.ref.batch_sgns_tiled_ref``
``cuda``           ``pallas``          K1, the sequential kernel
``cuda_pipelined`` ``pallas_pipelined`` K2, K1 plus prefetch
``cuda_tiled``     ``pallas_tiled``    K3, the window-tiled kernel; on
                                       a vocab-sharded step its
                                       ``update_fused`` runs K4
=================  ==================  ================================

The descriptors declare the reference's capabilities (vocab sharding,
storage dtypes, frontends) so that resolution accepts and rejects the same
combinations. The plain versions take every storage dtype; the CUDA
kernels take ``float32`` and ``bfloat16``, as the reference's Pallas
kernels do, so an int8 cold tail on the GPU runs under the f32 master
copy (``master=1``). Only the plain versions declare the frontend
features (``static_ctx``, ``bags``), as only the reference's jnp versions
do: ``auto`` with frontend features resolves to them on the GPU too, and a
CUDA backend asked for by name raises.

The implementations register themselves from ``repro_torch.kernels.ops``
at import time; every registry query triggers that import lazily.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple, TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids import cycles
    from repro_torch.data.batching import Batch


# ---------------------------------------------------------------------------
# StepInputs — the one argument struct every backend update() consumes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepInputs:
    """Device inputs for one training step. ``plan_*`` carry the host tile
    schedule (``repro_torch.data.batching.plan_tiles``) and are
    all-or-none: present for the window-tiled backends, ``None`` for the
    sequential ones. ``cold_ids``/``bucket_*`` carry a vocab-sharding
    exchange plan (``repro_torch.distributed.vocab_placement
    .plan_exchange``); token, negative and plan ids are then working-table
    ids. ``lr`` is a 0-d float32 tensor on the CPU: kernels read it on the
    host at launch, so it never costs a device sync. ``round_key`` is the
    batch's stochastic-rounding key for sub-f32 storage
    (``kernels.quant.round_key``, a pure function of ``(seed, epoch,
    batch_index)``), a host ``uint32[2]`` array: keying a step costs no
    device sync either. ``static_ctx``/``bags`` carry the workload
    frontends' extensions (DESIGN.md §12): a per-sentence always-in-window
    context row (doc2vec) and per-position subword bag members, both in
    table-row space (working-table space on a vocab-sharded step)."""
    tokens: torch.Tensor                          # (S, L) int32
    negs: torch.Tensor                            # (S, L, N) int32
    lengths: torch.Tensor                         # (S,) int32
    lr: torch.Tensor                              # () float32, CPU
    plan_uniq: Optional[torch.Tensor] = None      # (S, nt, T*(N+1)) int32
    plan_scatter: Optional[torch.Tensor] = None   # (S, nt, T*(N+1)) int32
    plan_ucount: Optional[torch.Tensor] = None    # (S, nt) int32
    plan_strict: Optional[torch.Tensor] = None    # (S, nt) int32
    cold_ids: Optional[torch.Tensor] = None       # (n_shards, R) int32, -1 pad
    bucket_ids: Optional[torch.Tensor] = None     # (n, n, C) int32, -1 pad
    bucket_pos: Optional[torch.Tensor] = None     # (n, n, C) int32, R pad
    round_key: Optional[np.ndarray] = None        # (2,) uint32, host
    static_ctx: Optional[torch.Tensor] = None     # (S,) int32 doc rows, -1
    bags: Optional[torch.Tensor] = None           # (S, L, B) int32, -1 pad

    @property
    def has_plan(self) -> bool:
        """Whether this step carries a host tile schedule (tiled family)."""
        return self.plan_uniq is not None

    @property
    def has_vocab_shard(self) -> bool:
        """Whether this step carries a vocab-sharding exchange plan."""
        return self.cold_ids is not None

    @property
    def has_static_ctx(self) -> bool:
        """Whether this step carries per-sentence static context rows."""
        return self.static_ctx is not None

    @property
    def has_bags(self) -> bool:
        """Whether this step carries per-position subword bag members."""
        return self.bags is not None

    @property
    def frontends(self) -> Tuple[str, ...]:
        """The frontend features this step carries, as
        :func:`resolve` takes them."""
        return ((("static_ctx",) if self.has_static_ctx else ())
                + (("bags",) if self.has_bags else ()))

    @property
    def tile(self) -> int:
        """T — derived from the plan shape (M = T*(N+1))."""
        if not self.has_plan:
            return 1
        m = self.negs.shape[-1] + 1
        return self.plan_uniq.shape[-1] // m

    @classmethod
    def from_batch(cls, batch: "Batch", lr, device,
                   put: Optional[Callable] = None,
                   mesh=None) -> "StepInputs":
        """Lift a host :class:`~repro_torch.data.batching.Batch` (numpy)
        onto ``device``, carrying its tile plan along when one is
        attached, and its frontend rows (``docs``, ``bags``); under a
        ``mesh`` (``repro_torch.launch.mesh.DataMesh``) only this rank's
        block of sentences. ``put`` (numpy array -> device tensor) replaces
        the blocking copy, e.g. with the trainer's pinned, non_blocking
        one."""
        from repro_torch.data.batching import rank_rows
        rows = rank_rows(batch.tokens.shape[0], mesh)
        put = put or (lambda a: torch.from_numpy(
            np.ascontiguousarray(a)).to(device))
        kw = {}
        if batch.plan is not None:
            p = batch.plan
            kw = dict(plan_uniq=put(p.uniq[rows]),
                      plan_scatter=put(p.scatter[rows]),
                      plan_ucount=put(p.ucount[rows]),
                      plan_strict=put(p.strict[rows]))
        kw.update(frontend_inputs(batch, rows, put))
        return cls(tokens=put(batch.tokens[rows]), negs=put(batch.negs[rows]),
                   lengths=put(batch.lengths[rows]),
                   lr=torch.tensor(float(lr), dtype=torch.float32), **kw)


def frontend_inputs(batch, rows: slice, put: Callable) -> dict:
    """``static_ctx``/``bags`` for :class:`StepInputs` from a host batch or
    exchange plan's ``docs``/``bags`` (rows ``rows``), the ones it
    carries."""
    kw = {}
    if getattr(batch, "docs", None) is not None:
        kw["static_ctx"] = put(batch.docs[rows])
    if getattr(batch, "bags", None) is not None:
        kw["bags"] = put(batch.bags[rows])
    return kw


@dataclasses.dataclass(frozen=True)
class KernelStatic:
    """Static kernel parameters."""
    w_f: int                # fixed context width W_f = ceil(W/2)
    tile: int = 1           # T — windows fused per kernel step
    gemm_windows: int = 0   # G — windows per GEMM group (resolved, not 0)


# ---------------------------------------------------------------------------
# Backend descriptors + registry
# ---------------------------------------------------------------------------

# update(w_in, w_out, step, static) -> (w_in, w_out), in place
UpdateFn = Callable[[torch.Tensor, torch.Tensor, StepInputs, KernelStatic],
                    Tuple[torch.Tensor, torch.Tensor]]

# update_fused(hot_in, hot_out, got_in, got_out, step, static) -> 4-tuple,
# in place: the vocab-sharded working table handed to the kernel *split* —
# hot replica and gathered cold block stay separate buffers and the kernel
# reads each row from whichever side holds it (no concat materialization)
FusedUpdateFn = Callable[
    [torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, StepInputs,
     KernelStatic],
    Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """One registered kernel variant and its capability descriptor."""
    name: str
    update: UpdateFn
    description: str = ""
    needs_plan: bool = False          # consumes a host tile schedule
    supports_mesh: bool = True        # runs on a rank's block under a mesh
    supports_pipeline: bool = False   # §3.1 prefetch (window t+1 overlap)
    supports_tiling: bool = False     # has a window-tiled counterpart
    supports_vocab_shard: bool = False  # runs on a vocab-sharded working
                                        # table (§8)
    # storage dtypes the engine can feed this backend (TableSpec dtypes)
    supports_dtypes: Tuple[str, ...] = ("float32",)
    # frontend features the update consumes ("static_ctx", "bags")
    supports_frontends: Tuple[str, ...] = ()
    requires_cuda: bool = False       # a CUDA kernel: runs only on the GPU
    tiled_variant: Optional[str] = None      # name of the tiled counterpart
    update_fused: Optional[FusedUpdateFn] = None  # split-table entry point

    @property
    def supports_fused_gather(self) -> bool:
        """Whether the vocab-sharded step can hand this backend the hot
        replica and the gathered cold rows as separate buffers instead of
        paying a ``concat(hot, gathered)`` materialization per step."""
        return self.update_fused is not None


_REGISTRY: Dict[str, KernelBackend] = {}


def register(backend: KernelBackend) -> KernelBackend:
    """Register a kernel backend descriptor; names are unique, first
    registration wins and re-registration raises."""
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def _ensure_registered() -> None:
    # backends self-register on import of ops; lazy so the registry never
    # has a module-level dependency back onto the implementations
    if not _REGISTRY:
        import repro_torch.kernels.ops  # noqa: F401  (registers backends)


def get(name: str) -> KernelBackend:
    """Exact-name registry lookup (no "auto"/variant mapping — that is
    :func:`resolve`); unknown names raise with the registered set listed."""
    _ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{', '.join(sorted(_REGISTRY))} (or 'auto')") from None


def names() -> List[str]:
    """All registered backend names (stable registration order)."""
    _ensure_registered()
    return list(_REGISTRY)


def cli_choices() -> List[str]:
    """Backend choices for the CLI: 'auto' plus every registered backend."""
    return ["auto"] + names()


def default_platform() -> str:
    """``"cuda"`` when a GPU is visible, else ``"cpu"``."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def resolve(name: str, *, tiled: bool = False, vocab_shard: bool = False,
            dtypes: Tuple[str, ...] = (),
            frontends: Tuple[str, ...] = (),
            platform: Optional[str] = None) -> KernelBackend:
    """Resolve a backend name against the registry for this step shape.

    * ``"auto"`` picks the native backend for ``platform`` (``"cuda"`` or
      ``"cpu"``; default :func:`default_platform`): the CUDA kernels on the
      GPU (pipelined for the sequential path, plain ``cuda`` when
      ``vocab_shard``), the plain torch versions elsewhere.
    * A sequential name with ``tiled=True`` maps to its ``tiled_variant``.
      ``cuda_pipelined`` warns on this mapping: the tiled kernel does not
      prefetch, so the request is downgraded — loudly, not silently.
    * ``vocab_shard``, ``dtypes`` and ``frontends`` require the resolved
      backend to declare the capability.
    * Invalid combinations (a plan-consuming backend without a plan, a CUDA
      backend off the GPU, a missing capability, an unknown name) raise
      ``ValueError`` with the fix spelled out.
    """
    _ensure_registered()
    platform = platform or default_platform()
    if name == "auto":
        if platform == "cuda" and not frontends:
            name = ("cuda_tiled" if tiled else
                    "cuda" if vocab_shard else "cuda_pipelined")
        else:
            name = "torch_tiled" if tiled else "torch"
    be = get(name)
    if tiled and not be.needs_plan:
        if not be.supports_tiling or be.tiled_variant is None:
            raise ValueError(
                f"backend {be.name!r} has no window-tiled variant; "
                f"set cfg.tile_windows=1 or pick one of: "
                f"{', '.join(n for n in _REGISTRY if _REGISTRY[n].needs_plan)}")
        if be.supports_pipeline:
            warnings.warn(
                f"backend {be.name!r} requests §3.1 prefetch, which the "
                f"window-tiled kernel does not implement; falling back to "
                f"{be.tiled_variant!r} (tiling amortizes row latency over T "
                f"windows, subsuming most of the prefetch win)",
                UserWarning, stacklevel=2)
        be = _REGISTRY[be.tiled_variant]
    if not tiled and be.needs_plan:
        raise ValueError(
            f"backend {be.name!r} consumes a host tile schedule but none was "
            f"provided; set cfg.tile_windows > 1 so the batching pipeline "
            f"attaches a plan (repro_torch.data.batching.plan_tiles), or use "
            f"a sequential backend: "
            f"{', '.join(n for n in _REGISTRY if not _REGISTRY[n].needs_plan)}")
    if vocab_shard and not be.supports_vocab_shard:
        capable = ', '.join(n for n in _REGISTRY
                            if _REGISTRY[n].supports_vocab_shard)
        raise ValueError(
            f"backend {be.name!r} does not support vocab-sharded tables; set "
            f"cfg.vocab_shard=False or pick one of: {capable}")
    missing = [d for d in dtypes if d not in be.supports_dtypes]
    if missing:
        capable = ', '.join(
            n for n in _REGISTRY
            if all(d in _REGISTRY[n].supports_dtypes for d in dtypes)
            and _REGISTRY[n].needs_plan == be.needs_plan) or "<none>"
        raise ValueError(
            f"backend {be.name!r} stores tables only in "
            f"{', '.join(be.supports_dtypes)} but the TableSpec requests "
            f"{', '.join(dtypes)}; pick a capable backend ({capable}) or "
            f"set the f32 master-copy fallback (master=1)")
    missing_fe = [f for f in frontends if f not in be.supports_frontends]
    if missing_fe:
        capable = ', '.join(
            n for n in _REGISTRY
            if all(f in _REGISTRY[n].supports_frontends for f in frontends)
            and _REGISTRY[n].needs_plan == be.needs_plan) or "<none>"
        raise ValueError(
            f"backend {be.name!r} does not consume the frontend feature(s) "
            f"{', '.join(missing_fe)} this workload's steps carry; pick a "
            f"capable backend ({capable}) or run the plain w2v workload")
    if be.requires_cuda and platform != "cuda":
        raise ValueError(
            f"backend {be.name!r} is a CUDA kernel and runs only on the GPU, "
            f"but this session runs on {platform!r}; use "
            f"{'torch_tiled' if be.needs_plan else 'torch'!r} (the plain "
            f"version).")
    return be
