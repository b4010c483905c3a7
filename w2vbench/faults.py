"""Variants of a run that the benchmark's own runs never use: the control
and the planted faults that set the upper readings of the limits in
``limits/`` and that the tests drive to see ``correct`` come out false.

Each is a patch of the program's module attributes in this process only
(nothing under ``src/`` changes):

* ``bf16``: training with the program's own bfloat16 table storage
  (``tables="hot=bf16"``), the precision below the configuration's f32;
* ``frozen``: every training step returns the tables unchanged;
* ``half``: every training step leaves out the second half of its
  sentences;
* ``token``: the host batching alters one token of every batch where it
  produces it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib


def config_overrides(variant: str) -> dict:
    """Keyword overrides of the program's training configuration."""
    return {"tables": "hot=bf16"} if variant == "bf16" else {}


@contextlib.contextmanager
def applied(variant: str):
    """Patch the program for ``variant`` (``""``: nothing) while entered,
    and put every patched attribute back on leaving."""
    saved = []

    def patch(module: str, name: str, value) -> None:
        mod = importlib.import_module(module)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    try:
        _patch(variant, patch)
        yield
    finally:
        for mod, name, value in reversed(saved):
            setattr(mod, name, value)


def _patch(variant: str, patch) -> None:
    if not variant or variant == "bf16":
        return
    if variant == "frozen":
        patch("repro_torch.kernels.ops", "step",
              lambda tables, step, cfg, backend="auto", mesh=None: tables)
    elif variant == "half":
        from repro_torch.kernels import ops

        real = ops.step

        def half(tables, step, cfg, backend="auto", mesh=None):
            lengths = step.lengths.clone()
            lengths[lengths.shape[0] // 2:] = 0
            return real(tables, dataclasses.replace(step, lengths=lengths),
                        cfg, backend=backend, mesh=mesh)
        patch("repro_torch.kernels.ops", "step", half)
    elif variant == "token":
        from repro_torch.data import batching

        real = batching.finalize_packed

        def altered(*a, **kw):
            batch = real(*a, **kw)
            vocab = (a[2] if len(a) > 2 else kw["sampler"]).vocab
            batch.tokens[0, 1] = (batch.tokens[0, 1] + 1) % vocab
            return batch
        patch("repro_torch.data.batching", "finalize_packed", altered)
        patch("repro_torch.data.prefetch", "finalize_packed", altered)
    else:
        raise ValueError(f"unknown variant {variant!r}")
