"""A run with its timed path broken underneath comes out not correct, at
tiny sizes on the CPU, against the cells' own limits: a step that leaves
the tables as they were, half of every batch left out, a token altered
where the host batching produces it, and the control (the program's
bfloat16 tables). The sound run comes out correct."""
from __future__ import annotations

import pytest


def test_sound_training_run_is_correct(run_tiny):
    out = run_tiny()
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["metrics"]["words_per_s"]["value"] > 0


@pytest.mark.parametrize("variant, caught_by", [
    ("frozen", "grad1_gap"), ("half", "grad1_gap"),
    ("token", "batch_mismatch"), ("bf16", "diff_rel")])
def test_broken_training_run_is_not_correct(run_tiny, variant, caught_by):
    out = run_tiny(variant)
    assert not out["result"]["correct"]
    failed = {n for n, v, lim in out["checks"] if not v <= lim}
    assert caught_by in failed, out["checks"]


def test_a_variant_is_undone_on_leaving():
    from repro_torch.data import batching
    from repro_torch.kernels import ops

    from w2vbench import faults

    step, finalize = ops.step, batching.finalize_packed
    with faults.applied("frozen"):
        assert ops.step is not step
    with faults.applied("token"):
        assert batching.finalize_packed is not finalize
    assert ops.step is step and batching.finalize_packed is finalize
