#!/usr/bin/env python3
"""Run phase 11 of ``chip_smoke.py`` alone: the workload frontends
(node2vec on the kernels K1-K4, doc2vec and subword on the plain versions,
a 2-rank sharded node2vec run) and the pWord2Vec-like baseline, with the
same gates and timings, on the first card.

    python3 tools/torch_frontends_phase.py [--seed 0] [--sentences-per-batch 10000]

Builds the kernels first, prints the card's name and power limit, then
phase 11's lines (about 3 min on an H100 with the build). Phase 9's f32
separation, which the baseline line prints beside its own, is not run
here and prints as nan. Needs a CUDA device; exits non-zero without one,
or if a gate fails.
"""
from __future__ import annotations

import argparse
import json
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
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0], flush=True)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build built={lib.built} seconds={time.perf_counter() - t0:.1f}",
          flush=True)
    out = chip_smoke.phase_frontends(torch, np, args, float("nan"))
    print(json.dumps({"launches": out["launches"], "plain": {
        f"{k[0]} T={k[1]}": v for k, v in out["plain"].items()},
        "baselines": out["baselines"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
