#!/usr/bin/env python3
"""Run phase 18 of ``chip_smoke.py`` alone: the five port examples
(``examples/torch_*.py``) as a user runs them on the card, each in its own
process, with their closing lines and kernel launches checked.

    python3 tools/torch_examples_phase.py

Builds the kernels first (once, in this process; the examples then load
the library built), prints the card's name and power limit, then phase
18's lines and each kernel's launches by example. Needs a CUDA device;
exits non-zero without one, or if an example fails.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
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
    print(json.dumps(chip_smoke.phase_examples(torch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
