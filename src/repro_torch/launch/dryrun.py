"""Multi-pod dry-run: run one step of every (architecture × input shape)
cell on the production mesh, on fake tensors, and record its count and
memory.

The port's counterpart of ``repro.launch.dryrun``, with the same flags and
the same JSONL record keys (``repro_torch.launch.report`` reads records of
both packages). Nothing runs on a GPU and nothing is allocated:

* the process joins torch's fake process group (``fake_pg``, one process
  standing for rank 0 of 256 or 512, every collective returning at once)
  and builds ``make_production_mesh`` on it;
* ``build_cell`` gives the cell's step and its abstract arguments, which
  become fake tensors (``FakeTensorMode``) placed by the cell's
  ``in_shardings``;
* one step runs under ``roofline.counting`` (matmul-class FLOPs and every
  collective) and torch's ``MemTracker``.

Decode cells take ``cache_len`` as a 0-d tensor made by ``torch.tensor``
inside the fake mode, which keeps its value, so ``int(cache_len)`` works:
``seq_len − 1``, a full cache, as the cost model reads it.

Extrapolation (the reference's arithmetic): each cell runs at 2 and 3
blocks of its layer pattern and every count is ``base + nb · per_block``
(exact for homogeneous stacks), so full depth never runs unless
``--no-extrap`` asks for it. The port loops over blocks in Python, so a
full-depth run counts every layer (the reference's counted scan bodies
once); the extrapolation is kept for time.

The record's fields:

* ``roofline``: FLOPs and collective bytes extrapolated from the counts,
  the memory term from ``costmodel.memory_bytes`` (the reference's
  analytic model); ``model_flops`` per device;
* ``memory_model``: ``costmodel.memory_bytes``;
* ``memory_analysis``: ``argument_bytes`` the rank's local shard bytes of
  the full-depth arguments (exact from the shardings); ``output_bytes``
  and ``alias_bytes`` (outputs that are argument tensors updated in place)
  the outputs' local bytes; ``temp_bytes`` ``MemTracker``'s peak less the
  arguments, ``null`` where ``MemTracker`` fails; the last three
  extrapolated from 2 and 3 blocks like the counts; ``generated_code_bytes``
  ``null`` (nothing is compiled);
* ``compile_s``: the host seconds of the deepest step run (3 blocks, or
  full depth with ``--no-extrap``); ``extrap_compile_s`` those of the 2-
  and 3-block runs together;
* ``raw_hlo_costs``: the 3-block run's own counts (the port has no HLO, so
  its byte fields are ``null``).

MUST be run as its own process (``python -m repro_torch.launch.dryrun``):
it owns the default process group.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k \\
      --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

from repro_torch.configs.base import SHAPES, cells, get_arch, list_archs
from repro_torch.launch.costmodel import memory_bytes
from repro_torch.launch.roofline import analyze, counting, model_flops_for


def production_mesh(multi_pod: bool):
    """The production mesh on a fake process group of its size (the
    default group, made anew when its size differs)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    world = 512 if multi_pod else 256
    if dist.is_initialized() and dist.get_world_size() != world:
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def _local_bytes(tree, only=None) -> int:
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves
    total = 0
    for x in tree_leaves(tree):
        if only is not None and id(x) not in only:
            continue
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _placed_args(cell, args, shape):
    """The cell's abstract arguments as fake tensors placed by its
    argument shardings (call inside a ``FakeTensorMode``)."""
    import torch

    from repro_torch.tree import tree_map
    fake = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype), args)
    if shape.kind == "decode":
        fake[-1]["cache_len"] = torch.tensor(shape.seq_len - 1,
                                             dtype=torch.int32)
    return cell.place(*fake)


def _build(cfg, shape_name, mesh, param_dtype, microbatches, zero_stage,
           rule_overrides):
    import torch

    from repro_torch.launch.steps import build_cell
    cell, args, _ = build_cell(cfg, shape_name, mesh,
                               param_dtype=getattr(torch, param_dtype),
                               microbatches=microbatches,
                               zero_stage=zero_stage,
                               rule_overrides=rule_overrides)
    return cell, list(args)


def _argument_bytes(cfg, shape_name, mesh, param_dtype, microbatches,
                    zero_stage, rule_overrides) -> int:
    """This rank's local bytes of a cell's arguments (no step runs)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cell, args = _build(cfg, shape_name, mesh, param_dtype, microbatches,
                        zero_stage, rule_overrides)
    with FakeTensorMode():
        return _local_bytes(_placed_args(cell, args, SHAPES[shape_name]))


def _step(cfg, shape_name, mesh, param_dtype, microbatches, zero_stage,
          rule_overrides) -> dict:
    """One step of the cell on fake tensors: its count and bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.tree import tree_leaves
    cell, args = _build(cfg, shape_name, mesh, param_dtype, microbatches,
                        zero_stage, rule_overrides)
    with FakeTensorMode():
        placed = _placed_args(cell, args, SHAPES[shape_name])
        arg_bytes = _local_bytes(placed)
        tracker = None
        try:
            from torch.distributed._tools.mem_tracker import MemTracker
            tracker = MemTracker()
            tracker.track_external(*tree_leaves(placed))
        except Exception:  # noqa: BLE001 — temp_bytes is then null
            tracker = None
        t0 = time.perf_counter()
        with counting() as count:
            if tracker is not None:
                with tracker:
                    out = cell(*placed)
            else:
                out = cell(*placed)
        seconds = time.perf_counter() - t0
    temp = None
    if tracker is not None:
        try:
            peak = tracker.get_tracker_snapshot("peak")
            temp = max(0, max(v["Total"] for v in peak.values()) - arg_bytes)
        except Exception:  # noqa: BLE001 — temp_bytes is then null
            temp = None
    ids = {id(x) for x in tree_leaves(placed)}
    return {"count": count, "seconds": seconds, "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "alias_bytes": _local_bytes(out, only=ids), "temp_bytes": temp}


def _mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: int = 1, param_dtype: str = "bfloat16",
             verbose: bool = True, cfg=None, zero_stage: int = 3,
             rule_overrides=None, tag: str = "", extrap: bool = True,
             mesh=None) -> dict:
    """One cell's record (module docstring). ``mesh``: a ``DeviceMesh``
    to run on instead of the production mesh (on a fake group of its
    own, made by the caller)."""
    cfg = cfg or get_arch(arch)
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else production_mesh(multi_pod)
    n_dev = mesh.size()
    mesh_name = _mesh_name(mesh)
    knobs = (mesh, param_dtype, microbatches, zero_stage, rule_overrides)
    model_flops = model_flops_for(cfg, shape) / n_dev
    mem_model = memory_bytes(cfg, shape, multi_pod)

    if not extrap:
        full = _step(cfg, shape_name, *knobs)
        terms = analyze(full["count"], model_flops=model_flops,
                        bytes_accessed=mem_model["total"])
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "n_devices": n_dev, "status": "ok", "tag": tag or "baseline",
            "extrapolated": False,
            "compile_s": round(full["seconds"], 1),
            "memory_analysis": {
                k: full[k] for k in ("argument_bytes", "output_bytes",
                                     "temp_bytes", "alias_bytes")},
            "roofline": terms.as_dict(),
        }
        if verbose:
            print(f"[{arch} × {shape_name} × {mesh_name}] step "
                  f"{full['seconds']:.0f}s OK (no-extrap); memory:",
                  result["memory_analysis"])
        return result

    pat_len = len(cfg.hybrid_pattern) if cfg.hybrid_pattern else 1
    nb_full = cfg.n_layers // pat_len
    c2 = _step(dataclasses.replace(cfg, n_layers=2 * pat_len,
                                   scan_layers=False), shape_name, *knobs)
    c3 = _step(dataclasses.replace(cfg, n_layers=3 * pat_len,
                                   scan_layers=False), shape_name, *knobs)

    def extrap_(f2, f3):
        if f2 is None or f3 is None:
            return None
        per_block = f3 - f2
        base = f2 - 2 * per_block
        return max(base + nb_full * per_block, 0.0)

    t2 = analyze(c2["count"])
    t3 = analyze(c3["count"])
    terms = analyze(c3["count"], model_flops=model_flops,
                    bytes_accessed=mem_model["total"])
    terms.flops = extrap_(t2.flops, t3.flops)
    terms.coll_bytes = extrap_(t2.coll_bytes, t3.coll_bytes)
    terms.coll_breakdown = {
        k: extrap_(t2.coll_breakdown.get(k, 0.0),
                   t3.coll_breakdown.get(k, 0.0))
        for k in set(t2.coll_breakdown) | set(t3.coll_breakdown)}
    mem = {"argument_bytes": _argument_bytes(cfg, shape_name, *knobs)}
    for k in ("output_bytes", "temp_bytes", "alias_bytes"):
        mem[k] = extrap_(c2[k], c3[k])
    mem["generated_code_bytes"] = None
    if mem["temp_bytes"] is not None:
        terms.peak_memory_bytes = (mem["argument_bytes"]
                                   + mem["output_bytes"] + mem["temp_bytes"]
                                   - mem["alias_bytes"])
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_devices": n_dev,
        "status": "ok",
        "tag": tag or "baseline",
        "variant": {"zero_stage": zero_stage, "microbatches": microbatches,
                    "remat_policy": cfg.remat_policy,
                    "rule_overrides": repr(rule_overrides)},
        "compile_s": round(c3["seconds"], 1),
        "extrap_compile_s": round(c2["seconds"] + c3["seconds"], 1),
        "raw_hlo_costs": {"flops": t3.flops, "bytes_accessed": None,
                          "coll_bytes": t3.coll_bytes,
                          "hlo_bytes_extrapolated": None},
        "memory_model": mem_model,
        "memory_analysis": {k: mem[k] for k in (
            "argument_bytes", "output_bytes", "temp_bytes",
            "generated_code_bytes", "alias_bytes")},
        "roofline": terms.as_dict(),
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] "
              f"steps {c2['seconds'] + c3['seconds']:.0f}s | "
              f"t_comp {terms.t_compute*1e3:.2f}ms "
              f"t_mem {terms.t_memory*1e3:.2f}ms "
              f"t_coll {terms.t_collective*1e3:.2f}ms "
              f"-> {terms.bottleneck}-bound, "
              f"roofline_frac {terms.roofline_frac:.3f}", flush=True)
        print("  memory_analysis:", result["memory_analysis"], flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--param-dtype", default="bfloat16")
    ap.add_argument("--no-extrap", action="store_true",
                    help="one full-depth step instead of the 2- and "
                         "3-block runs")
    ap.add_argument("--zero-stage", type=int, default=3)
    ap.add_argument("--remat-policy", default=None,
                    choices=[None, "nothing", "dots"])
    ap.add_argument("--repl-qo", action="store_true",
                    help="replicate q/o projections over model")
    ap.add_argument("--bf16-reduce", action="store_true",
                    help="bf16 partial sums on row-parallel projections")
    ap.add_argument("--pure-dp", action="store_true",
                    help="map the whole mesh to ZeRO data parallelism "
                         "(no TP)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None, help="append JSONL results here")
    args = ap.parse_args(argv)

    todo = []
    if args.all:
        for arch, shape in cells():
            todo.append((arch, shape, False))
            if args.both_meshes:
                todo.append((arch, shape, True))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        todo = [(args.arch, args.shape, mp) for mp in meshes]

    failures = 0
    overrides = {}
    if args.repl_qo:
        overrides["head_dim"] = (None,)
    if args.pure_dp:
        from repro_torch.distributed.sharding import PURE_DP_OVERRIDES
        overrides.update(PURE_DP_OVERRIDES)
    overrides = overrides or None
    for arch, shape, mp in todo:
        try:
            cfg = get_arch(arch)
            if args.remat_policy:
                cfg = dataclasses.replace(cfg, remat_policy=args.remat_policy)
            if args.bf16_reduce:
                cfg = dataclasses.replace(cfg, bf16_reduce=True)
            res = run_cell(arch, shape, mp, args.microbatches,
                           args.param_dtype, cfg=cfg,
                           zero_stage=args.zero_stage,
                           rule_overrides=overrides, tag=args.tag,
                           extrap=not args.no_extrap)
        except Exception as e:  # noqa: BLE001 — record and continue
            traceback.print_exc()
            res = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "status": "error", "error": repr(e)}
            failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(res) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
