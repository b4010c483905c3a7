#!/usr/bin/env python3
"""Probe which collectives torch's gloo backend runs directly on CUDA
tensors: the source of the staging table in
``repro_torch/distributed/collectives.py``.

    python3 tools/torch_gloo_probe.py [--ranks 2] [--rows 65532]

Starts ``--ranks`` processes on ``cuda:0`` in one gloo group (a file
store in a temporary directory) and calls ``all_gather_into_tensor``,
``all_to_all_single``, ``reduce_scatter_tensor`` (and
``reduce_scatter_single`` where the installed torch has it) and
``all_reduce`` on CUDA tensors of float32, bfloat16 and int8, each against
its definition computed on the host. Prints one JSON line per rank-0
result: ``ok``, ``wrong`` or the error the call raised. Then, for the ops
that ran, the host time of one call on a ``(rows, 128)`` float32 tensor,
direct and staged through pinned host buffers (mean of 5 after one
warm-up). Plain torch only; needs a CUDA device and exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def _expected(op, n, rank, make):
    import torch
    xs = [make(r) for r in range(n)]
    if op == "all_gather_into_tensor":
        return torch.cat(xs)
    if op == "all_to_all_single":
        return torch.stack([xs[s][rank] for s in range(n)])
    if op in ("reduce_scatter_tensor", "reduce_scatter_single"):
        return sum(x[rank:rank + 1].to(torch.float64) for x in xs)
    if op == "all_reduce":
        return sum(x.to(torch.float64) for x in xs)
    raise ValueError(op)


def _call(op, x, n, stage: bool):
    import torch
    import torch.distributed as dist
    dev = x.device
    if stage:
        x = x.to("cpu").pin_memory()
    if op == "all_gather_into_tensor":
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        dist.all_gather_into_tensor(out, x)
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
    elif op in ("reduce_scatter_tensor", "reduce_scatter_single"):
        out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
        getattr(dist, op)(out, x)
    else:
        out = x.clone()
        dist.all_reduce(out)
    return out.to(dev)


def _rank(rank, n, store, rows, queue):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    dev = torch.device("cuda:0")
    ops = ["all_gather_into_tensor", "all_to_all_single",
           "reduce_scatter_tensor", "all_reduce"]
    if hasattr(dist, "reduce_scatter_single"):
        ops.insert(3, "reduce_scatter_single")
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}
    out = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "ranks": n, "direct": {}}
    for op in ops:
        for name, dt in dtypes.items():
            def make(r, dt=dt):
                g = torch.Generator().manual_seed(r)
                v = torch.randint(-20, 20, (n, 3, 4), generator=g)
                return v.to(dt)
            try:
                got = _call(op, make(rank).to(dev), n, stage=False)
                torch.cuda.synchronize()
                want = _expected(op, n, rank, make)
                ok = torch.equal(got.cpu().to(torch.float64),
                                 want.to(torch.float64))
                res = "ok" if ok else "wrong"
            except Exception as e:  # the probe reports what the call raised
                res = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
            dist.barrier()
            out["direct"][f"{op}/{name}"] = res
    out["ms"] = {}
    x = torch.randn((n, rows // n, 128), device=dev)
    for op in ops:
        if out["direct"][f"{op}/float32"] != "ok":
            continue
        for stage in (False, True):
            _call(op, x, n, stage)
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(5):
                _call(op, x, n, stage)
            torch.cuda.synchronize()
            out["ms"][f"{op}/{'staged' if stage else 'direct'}"] = round(
                (time.perf_counter() - t0) / 5 * 1e3, 3)
            dist.barrier()
    if rank == 0:
        queue.put(out)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--rows", type=int, default=65532)
    args = ap.parse_args()
    import multiprocessing as mp

    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gloo_probe_") as tmp:
        store = os.path.join(tmp, "store")
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank,
                             args=(r, args.ranks, store, args.rows, q))
                 for r in range(args.ranks)]
        for p in procs:
            p.start()
        res = q.get(timeout=240)
        for p in procs:
            p.join(timeout=60)
    print(json.dumps(res), flush=True)
    return 0 if all(p.exitcode == 0 for p in procs) else 1


if __name__ == "__main__":
    sys.exit(main())
