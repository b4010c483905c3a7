"""The readers of the program's spans and counters: the step loop's wait
split into the pipeline's and the card's, a batch's produce and finalize,
the negative draws' yield and rounds, the padding, on hand-built
records; their totals taken from
the program once, ``None`` from a program without them or a run that
recorded nothing; and a traced CPU run that reports them all."""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from w2vbench import manifest, spans

ROOT = pathlib.Path(__file__).resolve().parents[2]
NAMES = ("pipeline_wait_ms_per_step", "slot_wait_ms_per_step",
         "produce_ms_per_batch", "finalize_ms_per_batch", "neg_draw_yield",
         "padding_frac", "neg_draw_rounds")


def _rec():
    return {"spans": {
        "spans": {"w2v.fetch": {"count": 4, "seconds": 2.0},
                  "w2v.pipeline.wait": {"count": 5, "seconds": 0.4},
                  "w2v.lift.slot_wait": {"count": 4, "seconds": 1.2},
                  "w2v.produce": {"count": 5, "seconds": 0.25},
                  "w2v.finalize": {"count": 5, "seconds": 7.5}},
        "counters": {"w2v.draw.slots": 5000, "w2v.draw.real_slots": 40,
                     "w2v.draw.rounds": 20, "w2v.positions.real": 300,
                     "w2v.positions.padded": 1000}}}


@pytest.mark.parametrize("cell", ["train", "1bw"])
def test_readers_on_a_hand_built_record(cell):
    read = {n: manifest.reader(f"{n}.{cell}") for n in NAMES}
    rec = _rec()
    assert read["pipeline_wait_ms_per_step"](rec) == pytest.approx(100.0)
    assert read["slot_wait_ms_per_step"](rec) == pytest.approx(300.0)
    assert read["produce_ms_per_batch"](rec) == pytest.approx(50.0)
    assert read["finalize_ms_per_batch"](rec) == pytest.approx(1500.0)
    assert read["neg_draw_yield"](rec) == pytest.approx(0.8)
    assert read["padding_frac"](rec) == pytest.approx(70.0)
    assert read["neg_draw_rounds"](rec) == pytest.approx(4.0)
    # no slot wait (the CPU) reads 0; no fetch, no draws read nothing
    del rec["spans"]["spans"]["w2v.lift.slot_wait"]
    assert read["slot_wait_ms_per_step"](rec) == 0.0
    empty = {"spans": {"spans": {"w2v.produce": {"count": 1, "seconds": 1}},
                       "counters": {}}}
    for n in ("pipeline_wait_ms_per_step", "slot_wait_ms_per_step",
              "finalize_ms_per_batch", "neg_draw_yield", "padding_frac",
              "neg_draw_rounds"):
        assert read[n](empty) is None, n


def test_totals_come_from_the_program_once(monkeypatch):
    class Program:
        calls = 0

        @classmethod
        def process_totals(cls):
            cls.calls += 1
            return _rec()["spans"]

    monkeypatch.setitem(sys.modules, "repro_torch.spans", Program)
    rec = {}
    assert spans.totals(rec) == _rec()["spans"]
    assert manifest.reader("finalize_ms_per_batch.train")(rec) == \
        pytest.approx(1500.0)
    assert Program.calls == 1


def test_nothing_without_the_programs_spans(monkeypatch):
    """An untraced run records nothing, and a program without the recorder
    has no totals to give: every reader reads ``None``."""
    class Untraced:
        @staticmethod
        def process_totals():
            return {"spans": {}, "counters": {}}

    monkeypatch.setitem(sys.modules, "repro_torch.spans", Untraced)
    for n in NAMES:
        assert manifest.reader(f"{n}.train")({}) is None, n
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    for n in NAMES:
        assert manifest.reader(f"{n}.1bw")({}) is None, n


def test_a_traced_run_reports_them(tmp_path):
    code = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(ROOT)!r}]
        from w2vbench.tests.conftest import tiny_bench
        from w2vbench import run
        bench = tiny_bench()
        bench["per_layer"] = [
            {{"name": n + ".train", "unit": "x", "workloads": ["c"]}}
            for n in {list(NAMES)!r}]
        out = run.execute("c", 2**31 + 5, 0.5, True, device="cpu",
                          bench=bench, t_start=time.time())
        print("METRICS", json.dumps(out["result"]["metrics"]))
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert "METRICS" in proc.stdout, proc.stderr[-3000:]
    got = json.loads(proc.stdout.split("METRICS", 1)[1])
    assert set(got) == {n + ".train" for n in NAMES}
    assert 0 < got["neg_draw_yield.train"]["value"] <= 100
    assert got["pipeline_wait_ms_per_step.train"]["value"] > 0
    assert got["finalize_ms_per_batch.train"]["value"] > 0
    assert 0 <= got["padding_frac.train"]["value"] < 100
    assert 1 <= got["neg_draw_rounds.train"]["value"] <= 17
