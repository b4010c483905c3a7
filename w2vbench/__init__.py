"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of FULL-W2V.

One run: ``python3 -m w2vbench.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>`` from the root of a checkout. ``BENCHMARK.json`` at the
root names the cells; each cell's configuration, traffic mix, per-layer
metric readers and correctness limits are files of their own under this
folder, found by name (``manifest.py``). Nothing here imports JAX or the
JAX package ``repro``.
"""
