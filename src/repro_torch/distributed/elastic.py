"""Elastic scaling: rebuild the largest valid mesh from surviving devices.

The port's counterpart of ``repro.distributed.elastic``. After a node
failure the job restarts with fewer devices; checkpoints are mesh-agnostic
(host arrays, resharded on load), so the only decision is the new mesh
shape. Policy: keep the ``model`` axis as requested (TP degree is an
algorithmic choice), shrink ``data`` (and ``pod``) to the largest multiple
that fits the surviving device count. :func:`plan_mesh` and
:func:`degrade_sequence` are pure integer logic, copied from the reference;
:func:`build` makes the plan a ``torch.distributed`` device mesh.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_devices: int, model_parallel: int = 16,
              pods: Optional[int] = None) -> MeshPlan:
    """Largest (pod?, data, model) mesh with `model_parallel` TP that fits
    n_devices. Falls back to smaller TP if n_devices < model_parallel."""
    tp = model_parallel
    while tp > 1 and n_devices % tp != 0:
        tp //= 2
    rest = n_devices // tp
    if pods and pods > 1 and rest % pods == 0 and rest // pods >= 1:
        return MeshPlan((pods, rest // pods, tp), ("pod", "data", "model"))
    return MeshPlan((rest, tp), ("data", "model"))


def build(plan: MeshPlan, device_type: str = "cuda"):
    """A ``torch.distributed`` ``DeviceMesh`` of ``plan.shape`` with
    ``plan.axes`` as its dimension names, over the initialized default
    process group, whose size must be ``plan.size``. ``device_type`` is
    the GPU unless the caller asks for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("build(plan) needs an initialized default "
                           "process group (torch.distributed)")
    if dist.get_world_size() != plan.size:
        raise ValueError(
            f"the process group has {dist.get_world_size()} ranks; the plan "
            f"{plan.shape} over {plan.axes} needs {plan.size}")
    return init_device_mesh(device_type, plan.shape,
                            mesh_dim_names=plan.axes)


def degrade_sequence(start_devices: int, model_parallel: int,
                     failures: List[int]) -> List[MeshPlan]:
    """The sequence of meshes a job walks through as `failures[i]` devices
    die at event i — used by tests and capacity planning."""
    out = []
    n = start_devices
    for f in failures:
        n = max(n - f, 1)
        out.append(plan_mesh(n, model_parallel))
    return out
