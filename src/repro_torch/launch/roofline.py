"""Roofline terms of a step, from what the step did on fake tensors.

The port's counterpart of ``repro.launch.roofline``. Three terms per
(arch × shape × mesh), all in seconds per step per GPU:

  compute    = FLOPs / PEAK_FLOPS          (counted while the step runs)
  memory     = bytes / HBM_BW              (the analytic ``costmodel``)
  collective = Σ wire bytes / NET_BW       (the step's recorded collectives)

Hardware model: one H100 SXM of a 256-GPU (or 512-GPU) cluster of
eight-GPU nodes. The production mesh's ``model`` axis of 16 spans two
nodes, so its collectives cross the network: one 400 Gb/s NDR InfiniBand
NIC per GPU, 50 GB/s a direction, plays the role of the reference's
one-ICI-link assumption. NVLink's 450 GB/s a direction per GPU (the
in-node rate) is not used: it would hold only for groups inside a node.

:func:`counting` counts a step: FLOPs from
``torch.utils.flop_counter.FlopCounterMode``, which counts matmul-class
ops (mm, bmm, addmm, einsum's contractions, convolutions, attention)
only, where XLA's ``cost_analysis`` (the reference's source) also counts
elementwise ops, so the two packages' FLOP counts are never compared;
collectives from a ``TorchDispatchMode`` that records every
``_c10d_functional.*`` and ``c10d.*`` collective with its result bytes
and group size (the port has no HLO to parse).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, NamedTuple, Optional

# H100 SXM, NVIDIA's data sheet: dense bf16 tensor-core peak, HBM3 rate
PEAK_FLOPS = 989e12        # FLOP/s a GPU
HBM_BW = 3.35e12           # bytes/s a GPU
NET_BW = 50e9              # bytes/s a direction: one 400 Gb/s NDR NIC a GPU

# recorded op -> the reference's collective kind (HLO op name)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "send": "collective-permute",
    "recv_": "collective-permute",
}


class Collective(NamedTuple):
    """One recorded collective: the reference's kind, the bytes of its
    result on this rank, and its group's size."""
    kind: str
    result_bytes: int
    group_size: int


def _wire_factor(op: str, n: int) -> float:
    """Per-device wire bytes as a multiple of the RESULT size (ring algos)."""
    n = max(n, 2)
    if op == "all-gather":
        return (n - 1) / n          # result = gathered (full) tensor
    if op == "all-reduce":
        return 2 * (n - 1) / n      # reduce-scatter + all-gather of result
    if op == "reduce-scatter":
        return float(n - 1)         # result = 1/n of the operand
    if op == "all-to-all":
        return (n - 1) / n
    return 1.0                      # collective-permute


def collective_bytes(events) -> Dict[str, float]:
    """Sum per-kind wire bytes of recorded collectives (:class:`Collective`
    or ``(kind, result_bytes, group_size)``), as the reference sums them
    from a partitioned HLO dump."""
    out: Dict[str, float] = {}
    for kind, nbytes, n in events:
        out[kind] = out.get(kind, 0.0) + nbytes * _wire_factor(kind, n)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # per-device FLOPs per step
    bytes_accessed: float      # per-device HBM bytes per step
    coll_bytes: float          # per-device collective wire bytes per step
    coll_breakdown: Dict[str, float]
    peak_memory_bytes: Optional[float] = None
    model_flops: Optional[float] = None     # 6·N·D (train) or 2·N·D (serve)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        """Lower-bound step time if the three units fully overlap."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_frac(self) -> Optional[float]:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_frac(self) -> float:
        """Fraction of the binding roof actually spent on model FLOPs
        (the score: model-useful compute / bound time)."""
        mf = self.model_flops if self.model_flops else self.flops
        t = self.t_bound
        return (mf / PEAK_FLOPS) / t if t else 0.0

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "peak_memory_bytes": self.peak_memory_bytes,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


# --------------------------------------------------------------------------
# counting a step
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StepCount:
    """What :func:`counting` saw: FLOPs (matmul-class ops) and every
    collective."""
    flops: float = 0.0
    collectives: List[Collective] = dataclasses.field(default_factory=list)


def _nbytes(x) -> int:
    import torch
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _group_size(args, kwargs) -> int:
    """The size of a recorded collective's process group: an argument
    that is the group (a ``ProcessGroup``, or the script object the
    dispatcher passes for one) or a registered group's name."""
    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    for a in list(args) + list(kwargs.values()):
        try:
            if isinstance(a, torch.ScriptObject):
                return int(dist.ProcessGroup.unbox(a).size())
            if isinstance(a, dist.ProcessGroup):
                return int(a.size())
            if isinstance(a, str):
                return int(c10d._resolve_process_group(a).size())
        except (KeyError, RuntimeError, ValueError):
            continue                     # another script object, or a name
    raise ValueError("a collective without a process group")


def _collective(func, args, kwargs) -> Optional[Collective]:
    """A :class:`Collective` for a collective op, else None."""
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d"):
        return None
    name = func._opname
    kind = _KINDS.get(name)
    if kind is None:
        return None
    if ns == "_c10d_functional":
        # (input, [reduce_op,] group_size?, group_name): the result is
        # returned; all_gather's and reduce_scatter's carry group_size
        if name.startswith(("all_gather", "reduce_scatter")):
            n = int(args[2] if name.startswith("reduce") else args[1])
        else:
            n = _group_size(args[1:], kwargs)
        return Collective(kind, -1, n)            # bytes: from the result
    # c10d ops take their outputs first (in place for all-reduce)
    return Collective(kind, _nbytes(args[0]), _group_size(args, kwargs))


class _CollectiveRecorder:
    """A ``TorchDispatchMode`` (made on entry: importing this module
    imports no torch) appending a :class:`Collective` per collective op to
    ``events``."""

    def __init__(self, events: List[Collective]):
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                rec = _collective(func, args, kwargs)
                out = func(*args, **kwargs)
                if rec is not None:
                    if rec.result_bytes < 0:
                        rec = rec._replace(result_bytes=_nbytes(out))
                    events.append(rec)
                return out

        self.mode = Mode()

    def __enter__(self):
        return self.mode.__enter__()

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


@contextlib.contextmanager
def counting():
    """Count the FLOPs and collectives of what runs inside (typically one
    step on fake tensors over a fake process group); yields a
    :class:`StepCount` whose ``flops`` is set on exit."""
    from torch.utils.flop_counter import FlopCounterMode

    count = StepCount()
    flops = FlopCounterMode(display=False)
    with flops, _CollectiveRecorder(count.collectives):
        yield count
    count.flops = float(flops.get_total_flops())


def analyze(count: StepCount, model_flops: Optional[float] = None,
            bytes_accessed: float = 0.0,
            peak_memory_bytes: Optional[float] = None) -> RooflineTerms:
    """:class:`RooflineTerms` of a counted step; ``bytes_accessed`` is the
    memory term's bytes (the dry-run's ``costmodel.memory_bytes``)."""
    coll = collective_bytes(count.collectives)
    return RooflineTerms(
        flops=count.flops,
        bytes_accessed=bytes_accessed,
        coll_bytes=coll.get("total", 0.0),
        coll_breakdown=coll,
        peak_memory_bytes=peak_memory_bytes,
        model_flops=model_flops,
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS per device per step: 6·N_active·tokens (train),
    2·N_active·tokens (forward/serve), over all devices -> divided later."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
