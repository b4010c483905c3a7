"""Process-group meshes: the port's counterpart of ``repro.launch.mesh``.

The reference runs its data-parallel and vocab-sharded steps under
``shard_map`` over the ``data`` axis of a jax ``Mesh``; the port runs one
process per rank in a ``torch.distributed`` group, and a
:class:`DataMesh` is one rank's view of it. :func:`make_host_mesh` builds
it from the initialized default group (a process without a group is a
one-rank mesh), and :func:`start_ranks` starts N ranks and runs a function
on each. Besides the group its steps run on, a mesh of several ranks has
a control group of its own (:attr:`DataMesh.control`) for the decisions
its ranks take together (the supervisor's vote on every batch, the
checkpoint step to restore), so such a decision never pairs with a step's
collective.

The backend follows one rule (:func:`plan_ranks`): ``nccl`` when the
ranks run on CUDA and each can have a card of its own (N ≤
``torch.cuda.device_count()``, rank r on ``cuda:r``); otherwise ``gloo``,
on the CPU, or with every rank on the same card when ranks share one
(NCCL refuses two ranks on one device). The LM substrate's meshes are
``torch.distributed`` ``DeviceMesh``es with named dims instead:
:func:`make_production_mesh` gives the reference's 256- and 512-device
pod shapes over the default group.

Importing this module starts nothing; torch is imported by the functions
that need it, so a CLI that imports it keeps a light top level for the
processes it spawns.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Tuple

AXIS = "data"


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """One rank's view of a data-parallel process group.

    ``group`` is the ``torch.distributed`` process group the collectives
    run on (``None``: the default group, or no group at one rank);
    ``device`` is this rank's device; ``backend`` is ``"gloo"``,
    ``"nccl"`` or ``"none"`` (one rank, no group); ``control_group`` is
    the group of :attr:`control` (``None``: the default group)."""
    rank: int
    size: int
    device: Any                 # torch.device
    backend: str = "none"
    group: Any = None
    axis: str = AXIS
    control_group: Any = None

    def __post_init__(self):
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {self.rank} outside a mesh of "
                             f"{self.size}")

    def barrier(self) -> None:
        """Wait for every rank (no-op at one rank)."""
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    @property
    def control(self) -> "DataMesh":
        """The mesh on its control group, for the small decisions every
        rank takes together (``collectives`` on it like on the mesh). Its
        ``device`` is the one for those decisions' tensors: the rank's
        card under NCCL, which takes CUDA tensors only, else the CPU."""
        import torch
        return dataclasses.replace(
            self, group=self.control_group, control_group=None,
            device=(self.device if self.backend == "nccl"
                    else torch.device("cpu")))


def make_host_mesh(device=None, timeout_s: Optional[float] = None
                   ) -> DataMesh:
    """The mesh of the initialized default process group, or a one-rank
    mesh when no group is initialized. ``device`` resolves as a session's
    does (``repro_torch.core.trainer.resolve_device``: the GPU unless the
    caller asks for the CPU); under NCCL it defaults to ``cuda:<rank>``.

    With several ranks every rank must call it: it creates the control
    group (a collective), on the same backend, whose operations time out
    after half of ``timeout_s``, the default group's timeout (torch's
    default when ``None``). A rank that waits in a decision for a peer
    stuck in a step's collective thus gives up, and reports, before that
    collective's own timeout ends the peer."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.trainer import resolve_device
    if not (dist.is_available() and dist.is_initialized()):
        return DataMesh(rank=0, size=1, device=resolve_device(device))
    rank, size = dist.get_rank(), dist.get_world_size()
    backend = str(dist.get_backend())
    if device is None and backend == "nccl":
        device = torch.device("cuda", rank % torch.cuda.device_count())
    control = None
    if size > 1:
        timeout = (dist.default_pg_timeout if timeout_s is None
                   else datetime.timedelta(seconds=timeout_s))
        control = dist.new_group(backend=backend, timeout=timeout / 2)
    return DataMesh(rank=rank, size=size, device=resolve_device(device),
                    backend=backend, control_group=control)


PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """Single pod: (data=16, model=16) = 256 ranks. Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks. A ``DeviceMesh`` with those dim names
    over the initialized default process group, which must have that many
    ranks (``device_type`` is the GPU unless the caller asks for the
    CPU)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = PRODUCTION_SHAPES[bool(multi_pod)]
    need = 1
    for s in shape:
        need *= s
    if not dist.is_initialized():
        raise RuntimeError(f"make_production_mesh needs an initialized "
                           f"default process group of {need} ranks")
    if dist.get_world_size() != need:
        raise ValueError(
            f"the production mesh {dict(zip(axes, shape))} needs {need} "
            f"ranks; the default process group has "
            f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def plan_ranks(device, n: int) -> Tuple[str, List[Any]]:
    """The backend and each rank's device for ``n`` ranks on ``device``
    (resolved as a session's: the GPU unless the caller asks for the CPU,
    raising without one): ``nccl`` with rank r on ``cuda:r`` when every
    rank can have a card of its own, else ``gloo`` with every rank on
    ``device``."""
    import torch

    from repro_torch.core.trainer import resolve_device
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    device = resolve_device(device)
    if device.type == "cuda" and n <= torch.cuda.device_count():
        return "nccl", [torch.device("cuda", r) for r in range(n)]
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return "gloo", [device] * n


class RankFailed(RuntimeError):
    """A rank of :func:`start_ranks` raised, died or outlived the
    timeout."""


def _rank_main(fn, rank: int, n: int, backend: str, device: str,
               store: str, timeout_s: float, results, args, kwargs) -> None:
    """One rank: join the group, run ``fn(mesh, ...)``, report."""
    try:
        import torch
        import torch.distributed as dist
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(make_host_mesh(dev, timeout_s), *args, **kwargs)
        dist.destroy_process_group()
        results.put((rank, None, out if rank == 0 else None))
    except BaseException:   # reported to the launcher, then exit non-zero
        results.put((rank, traceback.format_exc(), None))
        raise SystemExit(1)


def start_ranks(fn: Callable, n: int, device=None, *args,
                timeout: float = 900.0, **kwargs) -> Any:
    """Run ``fn(mesh, *args, **kwargs)`` on ``n`` new processes, one per
    rank, and return rank 0's result (picklable).

    ``fn`` must be importable by the spawned processes: a module-level
    function (of a ``__main__`` whose entry point is guarded). Each rank
    joins one group through a file store in a temporary directory (no
    port to pick), on the backend and device :func:`plan_ranks` chooses,
    which is printed. ``device`` is resolved before anything is spawned:
    without a GPU and without ``device="cpu"`` this raises. If a rank
    raises or dies, or the ranks outlive ``timeout`` seconds, the others
    are stopped and :class:`RankFailed` names the rank and its traceback.
    """
    backend, devices = plan_ranks(device, n)
    print(f"start_ranks: ranks={n} backend={backend} "
          f"devices={','.join(str(d) for d in devices)}", flush=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(
            target=_rank_main, name=f"rank{r}",
            args=(fn, r, n, backend, str(devices[r]),
                  os.path.join(tmp, "store"), timeout, results, args,
                  kwargs)) for r in range(n)]
        try:
            for p in procs:
                p.start()
            return _collect(procs, results, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)


def _collect(procs, results, timeout: float) -> Any:
    """Read every rank's report; raise on the first failure, a rank that
    died without one, or the deadline."""
    deadline = time.monotonic() + timeout
    done, out = set(), None
    while len(done) < len(procs):
        try:
            rank, err, value = results.get(timeout=0.5)
        except queue.Empty:
            for r, p in enumerate(procs):
                if r not in done and p.exitcode not in (None, 0):
                    raise RankFailed(f"rank {r} died with exit code "
                                     f"{p.exitcode} and no report")
            if time.monotonic() > deadline:
                late = sorted(set(range(len(procs))) - done)
                raise RankFailed(f"ranks {late} still running after "
                                 f"{timeout:.0f} s")
            continue
        if err is not None:
            raise RankFailed(f"rank {rank} failed:\n{err}")
        done.add(rank)
        if rank == 0:
            out = value
    return out

