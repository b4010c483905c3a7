"""The arithmetic of the metrics: rates and shares over the whole window,
and the operation and byte counts by hand."""
from __future__ import annotations

import types

import numpy as np
import pytest

from w2vbench import counts, manifest, trace


def read(name, rec):
    return manifest.reader(name)(rec)


def test_rates_over_the_whole_window():
    rec = {"corpus_words": 3_000_000, "window_s": 2.5}
    assert read("words_per_s", rec) == 1_200_000


def test_host_wait_counts_the_windows_waits():
    rec = {"fetch_s": 1.5, "steps": 4}
    assert read("host_wait_ms_per_step.train", rec) == pytest.approx(500.0)
    assert read("host_wait_ms_per_step.train", {"steps": 1,
                                                "fetch_s": 0}) is None


def test_shares():
    tr = {"busy_s": 3.0, "window_s": 4.0,
          "kernel_s": {"void fullw2v::seq_kernel<3, 5, true, true>(x)": 2.0,
                       "Memcpy HtoD": 1.0}}
    rec = {"trace": tr, "least_s": 0.5, "flops": 67e12, "window_s": 4.0,
           "steps": 3}
    assert read("device_idle_frac.train", rec) == pytest.approx(25.0)
    assert read("seq_kernel_roofline.train", rec) == pytest.approx(25.0)
    assert read("mfu.train", rec) == pytest.approx(25.0)


def test_shares_read_nothing_without_their_source():
    assert read("seq_kernel_roofline.train", {"trace": {
        "kernel_s": {"other": 1.0}, "busy_s": 1, "window_s": 1},
        "least_s": 1.0}) is None
    assert read("mfu.train", {"window_s": 1.0}) is None
    assert read("device_idle_frac.train", {"window_s": 1.0}) is None


@pytest.mark.parametrize("n, want", [(0, 0), (1, 0), (2, 2), (3, 6),
                                     (4, 12), (7, 2 * (6 + 5 + 4))])
def test_context_pairs_by_hand(n, want):
    # each window sees the positions within W_f = 3 on both sides
    brute = sum(1 for t in range(n) for o in (-3, -2, -1, 1, 2, 3)
                if 0 <= t + o < n)
    assert counts.context_pairs(np.array([n]), 3) == want == brute


def test_sgns_counts_by_hand():
    tokens = np.array([[1, 2, 0], [3, 3, 3]], np.int32)
    negs = np.array([[[4, 5], [6, 1], [0, 0]],
                     [[1, 2], [4, 5], [7, 0]]], np.int32)
    lengths = np.array([2, 3], np.int32)
    pairs = 2 + 6                                    # W_f = 3
    assert counts.sgns_flops(lengths, 3, 2, 4) == 6 * 4 * 3 * pairs
    # w_in rows {1, 2, 3}; w_out rows: the targets and every negative
    rows_in, rows_out = 3, len({0, 1, 2, 3, 4, 5, 6, 7})
    ids = 4 * (5 + 5 * 2 + 2)
    assert counts.sgns_bytes(tokens, negs, lengths, 8, 4) == \
        2 * (rows_in + rows_out) * 4 * 4 + ids


def test_least_seconds_takes_the_larger_bound():
    assert counts.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert counts.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name, of", [
    ("words_per_s.1bw", "words_per_s"),
    ("host_wait_ms_per_step.1bw", "host_wait_ms_per_step.train"),
    ("seq_kernel_roofline.1bw", "seq_kernel_roofline.train"),
    ("mfu.1bw", "mfu.train"),
    ("device_idle_frac.1bw", "device_idle_frac.train")])
def test_1bw_metrics_read_as_their_text8_twins(name, of):
    tr = {"busy_s": 1.0, "window_s": 4.0,
          "kernel_s": {"seq_kernel<3, 5, true, true>": 0.5}}
    rec = {"trace": tr, "least_s": 0.01, "flops": 67e10, "window_s": 4.0,
           "steps": 5, "fetch_s": 2.0, "corpus_words": 10**6}
    assert read(name, rec) == read(of, rec) is not None
    assert read(name, {"window_s": 1.0, "corpus_words": 0,
                       "steps": 0}) == read(of, {"window_s": 1.0,
                                                 "corpus_words": 0,
                                                 "steps": 0})


def test_window_counts_sum_every_batch():
    from w2vbench.drivers.train import window_counts

    tokens = np.array([[1, 2, 0], [3, 3, 3]], np.int32)
    negs = np.zeros((2, 3, 2), np.int32)
    lengths = np.array([2, 3], np.int32)
    dims = {"w_f": 3, "n_neg": 2, "dim": 4, "vocab": 8}
    one = (tokens, negs, lengths)
    f1 = counts.sgns_flops(lengths, 3, 2, 4)
    least1 = counts.least_seconds(f1, counts.sgns_bytes(tokens, negs,
                                                        lengths, 8, 4))
    assert window_counts([one, one, one], dims) == pytest.approx(
        (3 * f1, 3 * least1))
    assert window_counts([], dims) == (0.0, 0.0)


class _Event:
    def __init__(self, name, a, b, cuda):
        self.name = name
        self.time_range = types.SimpleNamespace(start=a, end=b)
        import torch
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


def test_trace_busy_union_and_idle_gaps():
    events = [_Event(trace.WINDOW, 0, 100, False),
              _Event(trace.WINDOW, 0, 100, True),     # its mark on the card
              _Event("k1", 10, 30, True), _Event("k2", 20, 40, True),
              _Event("k1", 60, 70, True), _Event("copy", 95, 120, True),
              _Event("cudaStreamSynchronize", 40, 60, False),
              _Event("outer", 0, 100, False)]
    tr = trace.Trace(False)
    tr.prof = types.SimpleNamespace(events=lambda: events)
    s = trace.summarize(tr)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx((30 + 10 + 5) * 1e-6)
    assert s["kernel_s"]["k1"] == pytest.approx(30e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert gaps["outer"] == pytest.approx((10 + 25) * 1e-6)
