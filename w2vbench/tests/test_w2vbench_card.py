"""On the card (``requires_cuda``; they skip without one): the controls
at a size a test run holds, against the cell's limits: the program's own
bfloat16 table storage must fail the training check that its f32
storage passes."""
from __future__ import annotations

import time

import pytest

from w2vbench import check, run as harness

from .conftest import TRAFFIC, tiny_config


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels)")


def _bench(cell: str) -> dict:
    cfg = tiny_config(vocab=71_290, rows=64)
    cfg["dim"] = 128
    cfg["max_sentence_len"] = 1000
    cfg["corpus"] = {"kind": "stream", "words": 400_000,
                     "sentence_len": 1000}
    cfg["published_words"] = 17_005_207
    return {"configs": [{"name": "tiny", "file": "-", "reduced": []}],
            "workloads": [{"name": "c", "config": "tiny", "traffic": "t",
                           "chips": 1}],
            "end_to_end": [], "per_layer": [],
            "_configs": {"tiny": cfg}, "_traffic": {"t": TRAFFIC},
            "_limits": {"c": check.load_limits(cell)}}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bf16_tables_fail_the_training_check(seed):
    _card()
    bench = _bench("text8.train")
    sound = harness.execute("c", seed, 1.0, False, bench=bench,
                            t_start=time.time())
    assert sound["result"]["correct"], sound["checks"]
    control = harness.execute("c", seed, 1.0, False, variant="bf16",
                              bench=bench, t_start=time.time())
    assert not control["result"]["correct"], control["checks"]
