#!/usr/bin/env python3
"""Run phase 12 of ``chip_smoke.py`` alone: the serving stack on the first
card, with the same gates and timings.

    python3 tools/torch_serve_phase.py [--seed 0] [--sentences-per-batch 10000]

Builds the kernels, prints the card's name and power limit, trains the
sessions phase 12 serves (phase 4's T=1 auto and one-shard T=8 sessions,
phase 9's ``hot=bf16,cold=int8,shards=1,master=1`` session, 3 batches
each, without phase 9's codec checks), then prints phase 12's lines.
Needs a CUDA device; exits non-zero without one, or if a gate fails.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sentences-per-batch", dest="S", type=int,
                    default=10_000)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build built={lib.built} seconds={time.perf_counter() - t0:.1f}",
          flush=True)
    train = chip_smoke.phase_trainer
    sess1 = train(torch, np, args, 1, "auto", "cuda_pipelined")[0]
    frac = chip_smoke.sharded_hot_frac(
        np, chip_smoke.make_pipeline(args, 8)[0])
    sess_vs = train(torch, np, args, 8, "auto", "cuda_tiled",
                    vocab_shard=True, hot_vocab_frac=frac)[0]
    sess_mx = train(torch, np, args, 8, "auto", "cuda_tiled",
                    tables=chip_smoke.MIXED_RUNS[-1][0],
                    hot_vocab_frac=frac)[0]
    chip_smoke.phase_serve(torch, np, args, [
        ("replicated T=1 auto (K2)", sess1),
        ("split T=8 one shard (K4)", sess_vs),
        (f"int8 {chip_smoke.MIXED_RUNS[-1][0]} T=8 (K4)", sess_mx)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
