#!/usr/bin/env python3
"""Run phase 14 of ``chip_smoke.py`` alone (the LM substrate on the first
card, with the same gates and timings), then trace one forward of each
arch with ``torch.profiler``; optionally phase 15 (LM training) and the
LM mesh path.

    python3 tools/torch_lm_phase.py [--seed 0] [--train] [--no-trace]
                                    [--no-lm] [--ep] [--tp] [--mesh 4]

Prints the card's name and power limit, phase 14's lines, then one
``[lm-trace]`` line an arch: the forward's host wall (host clock around
the call and a device sync), the device time of its kernels (summed from
the trace), their ratio (the device's busy share), the number of kernels
launched, and the four ops with the most device time. ``--train`` runs
phase 15 after them (``[lm-train]`` lines), ``--no-lm`` and
``--no-trace`` leave out phase 14 and the traces. ``--mesh 4`` runs the
LM mesh path (``chip_smoke.lm_mesh_rank``: ``Trainer(mesh=...)`` and a
decode cell on a ``(data=2, model=2)`` DeviceMesh against one process,
both computing on local shards, ``[lm-mesh]`` lines a rank; the mesh
``Trainer`` of smoke moonshot-v1-16b-a3b too, which takes expert
parallelism), then phase 16's expert-parallel block at published width
at model=4 (``chip_smoke.ep_rank``, ``[lm-ep]`` lines a rank), then
phase 17's tensor-parallel cell for starcoder2-3b's 2-layer cut at
``(data=1, model=4)`` (its 2 KV heads take the decode path whose
positions are split over ``model``; ``chip_smoke.tp_rank``, ``[lm-tp]``
lines a rank), on 4 ranks, NCCL with a card each: it needs a four-card
machine. ``--ep`` runs phase 16 after phase 15 when ``--train`` is given
(``[lm-ep]`` lines), else its expert-parallel block alone at model=2.
``--tp`` runs phase 17 (qwen3-8b's and mamba2-1.3b's cuts on 2 gloo
ranks sharing the card, ``[lm-tp]`` lines).
Needs a CUDA device; exits non-zero without one, or if a gate fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def trace_forward(torch, np, name: str, seed: int) -> None:
    """One traced forward of ``name``'s 2-layer cut at phase 14's shape."""
    import chip_smoke
    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from torch.profiler import ProfilerActivity, profile

    full = get_arch(name)
    cfg = dataclasses.replace(
        full, n_layers=chip_smoke.LM_LAYERS * len(lm.block_pattern(full)))
    params = lm.init_params(cfg, seed=seed, device="cuda")
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, cfg.vocab,
                                      (1, chip_smoke.LM_S))).cuda()
    with torch.no_grad():
        lm.forward(cfg, params, x)                      # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lm.forward(cfg, params, x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:4]
    top = ",".join(f"{e.key}:{e.self_device_time_total / 1e3:.2f}ms"
                   f"x{e.count}" for e in ops)
    print(f"[lm-trace] arch={name} layers={cfg.n_layers} S={chip_smoke.LM_S}"
          f" forward_wall_ms={wall_ms:.3f} device_ms={device_ms:.3f}"
          f" device_busy={device_ms / wall_ms:.3f} kernels={len(kernels)}"
          f" top={top}", flush=True)
    del params
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="run phase 15 (LM training) too")
    ap.add_argument("--no-lm", action="store_true",
                    help="leave out phase 14")
    ap.add_argument("--no-trace", action="store_true",
                    help="leave out the traced forwards")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run the LM mesh path on N (= 4) ranks")
    ap.add_argument("--ep", action="store_true",
                    help="run phase 16's expert-parallel block (2 ranks)")
    ap.add_argument("--tp", action="store_true",
                    help="run phase 17's tensor-parallel cells (2 ranks)")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    if not args.no_lm:
        chip_smoke.phase_lm(torch, np, args)
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    for f in flags:
        f.allow_tf32 = False            # as phases 14 and 15
    if not args.no_trace:
        for name in chip_smoke.LM_ARCHS:
            trace_forward(torch, np, name, args.seed)
    lm_train = chip_smoke.phase_lm_train(torch) if args.train else None
    if args.ep and lm_train is not None:
        chip_smoke.phase_lm_ep(torch, args, lm_train)
    elif args.ep:
        from repro_torch.launch.mesh import start_ranks
        chip_smoke.ep_check(start_ranks(chip_smoke.ep_rank,
                                        chip_smoke.EP_RANKS, "cuda",
                                        args.seed, timeout=600),
                            chip_smoke.EP_RANKS)
    if args.tp:
        chip_smoke.phase_lm_tp(args)
    if args.mesh:
        if args.mesh != 4:
            ap.error("the LM mesh path is a (data=2, model=2) mesh: --mesh 4")
        if torch.cuda.device_count() < 4:
            print("error: the LM mesh path needs four cards (NCCL, a card "
                  "a rank)", file=sys.stderr)
            return 1
        from repro_torch.launch.mesh import start_ranks
        t0 = time.perf_counter()
        chip_smoke.lm_mesh_check(start_ranks(chip_smoke.lm_mesh_rank, 4,
                                             "cuda", timeout=600))
        print(f"[lm-mesh] seconds={time.perf_counter() - t0:.1f}",
              flush=True)
        t0 = time.perf_counter()
        chip_smoke.ep_check(start_ranks(chip_smoke.ep_rank, 4, "cuda",
                                        args.seed, timeout=600), 4)
        print(f"[lm-ep] model_ranks=4 seconds="
              f"{time.perf_counter() - t0:.1f}", flush=True)
        t0 = time.perf_counter()
        archs, shape = chip_smoke.TP_FOUR
        chip_smoke.tp_check(start_ranks(chip_smoke.tp_rank, 4, "cuda",
                                        args.seed, shape, archs,
                                        timeout=600))
        print(f"[lm-tp] model_ranks=4 seconds="
              f"{time.perf_counter() - t0:.1f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
