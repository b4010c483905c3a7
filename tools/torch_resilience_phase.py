#!/usr/bin/env python3
"""Run phase 13 of ``chip_smoke.py`` alone: supervised recovery under a
mesh (the ``ci`` chaos schedule on 2 ranks, data-parallel T=1 and
vocab-sharded exact T=8, then the train CLI's resilience flags on 2
ranks), with the same gates and timings.

    python3 tools/torch_resilience_phase.py [--seed 0]

With one card the ranks share it over gloo, as in ``chip_smoke.py``; on a
machine with two or more cards ``repro_torch.launch.mesh.plan_ranks``
gives each rank a card of its own and NCCL. Builds the kernels first (once,
in this process), prints every card's name and power limit, then phase
13's lines. Needs a CUDA device; exits non-zero without one, or if a gate
fails.
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
                    default=10_000,
                    help="phase 4's S, from which the sharded run's hot "
                         "fraction is chosen (phase 13 itself runs at "
                         "S=2,000)")
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

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    lib = _build.load()
    print(f"build built={lib.built} seconds={time.perf_counter() - t0:.1f}",
          flush=True)
    pipe, _, _ = chip_smoke.make_pipeline(args, 8)
    frac = chip_smoke.sharded_hot_frac(np, pipe)
    del pipe
    print(chip_smoke.phase_mesh_chaos(args, frac), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
