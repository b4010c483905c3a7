"""BENCHMARK.json against the benchmark's contract, and every cell's
configuration, traffic mix, metric readers and limits found by name."""
from __future__ import annotations

import copy
import json

import pytest

from w2vbench import check, manifest

BENCH = manifest.load()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
NUMBERS = {"train": {"batch_mismatch", "grad1_gap", "change_gap",
                     "diff_rel"}}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "-m", "w2vbench.run"]
    assert BENCH["paths"] == ["w2vbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entry_keys(section):
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]


def test_names_units_and_files_found():
    assert manifest.problems(BENCH) == []


def test_bad_names_and_units_are_found():
    bad = copy.deepcopy(BENCH)
    bad["workloads"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "words per second"
    bad["per_layer"][0]["name"] = "µs_metric"
    found = manifest.problems(bad)
    assert any("has space" in p for p in found)
    assert any("words per second" in p for p in found)
    assert any("µs_metric" in p for p in found)


def test_bounds_and_setup():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_what_its_metrics_move():
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in cells:
        e2e = {m["name"] for m in manifest.metrics_of(BENCH, w,
                                                      "end_to_end")}
        layer = manifest.metrics_of(BENCH, w, "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w, m["name"])
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_has_limits_for_its_numbers(cell):
    w = manifest.cell(BENCH, cell)
    kind = manifest.traffic(w["traffic"])["kind"]
    limits = check.load_limits(cell)
    assert set(limits) == NUMBERS[kind]
    for name, entry in limits.items():
        assert entry["limit"] >= 0
        upper = [x for vals in entry["upper"].values() for x in vals]
        if entry["limit"] > 0:   # set between the readings it came from
            assert max(entry["lower"]) < entry["limit"] < min(upper)
        else:                    # exact: some fault reads above it
            assert max(entry["lower"]) == 0


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_config_and_traffic_found_by_name(cell):
    w = manifest.cell(BENCH, cell)
    cfg = manifest.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    entry = [c for c in BENCH["configs"] if c["name"] == w["config"]][0]
    assert set(entry["reduced"]) <= set(cfg["published"])
    traffic = manifest.traffic(w["traffic"])
    assert manifest.driver(traffic["kind"]).run


def test_metric_readers_load():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_a_cell_is_added_by_data_alone():
    more = copy.deepcopy(BENCH)
    more["workloads"].append({"name": "text8.train.b", "config": "w2v-text8",
                              "traffic": "train", "chips": 1, "why": "x"})
    assert manifest.problems(more) == []
    assert manifest.cell(more, "text8.train.b")["traffic"] == "train"
    assert manifest.config(more, "w2v-text8")["vocab_size"] == 71290
    more["workloads"][-1]["traffic"] = "not_there"
    assert any("not_there" in p for p in manifest.problems(more))
