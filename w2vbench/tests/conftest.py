"""Tiny cells for the benchmark's CPU tests: the same drivers, readers
and checks as the chip runs, on configurations a test run can hold.
``tiny_bench()`` is a ``BENCHMARK.json``-shaped dict whose
configuration, traffic mix and limits ride along (``_configs``,
``_traffic``, ``_limits``); the limits are the cells' own files."""
from __future__ import annotations

import pathlib
import sys
import time

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from w2vbench import check  # noqa: E402

def tiny_config(vocab: int = 400, rows: int = 8) -> dict:
    return {"name": "tiny", "dim": 16, "window": 5, "negatives": 5,
            "lr": 0.025, "min_lr_frac": 1e-4, "subsample_t": 1e-3,
            "min_count": 1, "max_sentence_len": 40,
            "sentences_per_batch": rows, "tile_windows": 1, "epochs": 20,
            "vocab_size": vocab, "published_words": 200_000,
            "corpus": {"kind": "sentences", "sentences": 400,
                       "mean_len": 20.0, "len_sigma": 0.75, "max_len": 40,
                       "min_len": 1, "lengths_seed": 7},
            "assumed": {"zipf_exponent": 1.0}}


TRAFFIC = {"kind": "train", "prefetch_workers": 2, "prefetch_depth": 2,
           "prefetch_mode": "thread", "check_steps": 2}


def tiny_bench(limits: dict = None) -> dict:
    """A one-cell training bench (cell ``c``) under the 1bw cell's limits
    unless ``limits`` is given."""
    limits = limits if limits is not None else check.load_limits(
        "1bw.train")
    return {"configs": [{"name": "tiny", "file": "-", "reduced": []}],
            "workloads": [{"name": "c", "config": "tiny", "traffic": "t",
                           "chips": 1}],
            "end_to_end": [{"name": "setup_s", "unit": "s"},
                           {"name": "words_per_s", "unit": "x"}],
            "per_layer": [],
            "_configs": {"tiny": tiny_config()},
            "_traffic": {"t": TRAFFIC}, "_limits": {"c": limits}}


@pytest.fixture
def run_tiny():
    """``run_tiny(variant="", seconds=1.0)`` -> ``execute``'s dict, on
    the CPU."""
    from w2vbench import run as harness

    def go(variant: str = "", seconds: float = 1.0, limits: dict = None):
        return harness.execute("c", 2**31 + 77, seconds, False,
                               device="cpu", variant=variant,
                               bench=tiny_bench(limits),
                               t_start=time.time())
    return go
