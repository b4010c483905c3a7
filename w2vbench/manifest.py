"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, read from
``configs/<config>.json``, and a traffic mix, read from
``traffic/<traffic>.json``; the mix's ``kind`` selects the driver
(``drivers/<kind>.py``). Every metric, end-to-end or per-layer, is read
from a run's record by ``metrics/<name>.py``. A metric with a
``workloads`` key is reported in those cells only.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import re
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DRIVERS = {"train": "train"}


def load(path: pathlib.Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(pathlib.Path(path).read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                   f"{', '.join(w['name'] for w in bench['workloads'])}")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def driver(kind: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"w2vbench.drivers.{DRIVERS[kind]}")


def metrics_of(bench: dict, workload: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) this
    cell reports."""
    return [m for m in bench[section]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str):
    """``read(record) -> float | None`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "w2vbench.metrics._" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def problems(bench: dict) -> List[str]:
    """What in ``bench`` breaks the naming rules or names a file that is
    not there."""
    out = []
    names: Dict[str, str] = {}
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[section]:
            n = e["name"]
            if not NAME.match(n):
                out.append(f"{section}: bad name {n!r}")
            if n in names and section in ("end_to_end", "per_layer") and \
                    names[n] in ("end_to_end", "per_layer"):
                out.append(f"metric {n!r} twice")
            names.setdefault(n, section)
    for c in bench["configs"]:
        if not (ROOT / c["file"]).exists():
            out.append(f"config {c['name']}: no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"config {c['name']}: bad reduced key {key!r}")
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                out.append(f"workload {w['name']}: bad {key} {w[key]!r}")
        if not (HERE / "traffic" / f"{w['traffic']}.json").exists():
            out.append(f"workload {w['name']}: no traffic {w['traffic']}")
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if not UNIT.match(m["unit"]):
                out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if not (HERE / "metrics" / f"{m['name']}.py").exists():
                out.append(f"metric {m['name']}: no reader")
    return out
