"""The port's roofline pieces (``repro_torch.launch.{costmodel,roofline,
report}``) held to what ``tests/test_roofline.py`` intends.

* ``costmodel.memory_bytes`` equals the reference's float for float for
  every ``cells(include_skips=True)`` cell on both production meshes, and
  ``model_flops_for`` the reference's on every cell.
* ``RooflineTerms`` arithmetic under the H100 constants (989 TFLOP/s
  bf16, 3.35 TB/s, 50 GB/s a GPU on the network).
* Recorded collectives give the reference's ``collective_bytes`` of
  ``tests/test_roofline.py``'s HLO fixture when its ops and group sizes
  are recorded as events; ``counting`` records a fake process group's
  collectives (functional and ``c10d``) with their result bytes and group
  sizes, and ``FlopCounterMode``'s matmul FLOPs (a subprocess: it owns
  the default group).
* the report CLI prints the reference's report CLI's strings from the
  same records (the reference's report is a CLI wrapper and runs as one),
  and ``report.render``/``summarize`` give them.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import cells as ref_cells
from repro.configs.base import get_arch as ref_get_arch
from repro.launch import costmodel as ref_costmodel
from repro.launch import roofline as ref_roofline
from repro_torch.configs.base import SHAPES, cells, get_arch
from repro_torch.launch import costmodel, report, roofline
from repro_torch.launch.roofline import (
    HBM_BW,
    NET_BW,
    PEAK_FLOPS,
    Collective,
    RooflineTerms,
    collective_bytes,
)
from tests.conftest import REPO, SRC, run_subprocess

CELLS = [(a, s, mp) for a, s in cells(include_skips=True)
         for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS,
                         ids=[f"{a}-{s}-{'2x16x16' if mp else '16x16'}"
                              for a, s, mp in CELLS])
def test_memory_model_equals_reference(arch, shape, multi_pod):
    ours = costmodel.memory_bytes(get_arch(arch), SHAPES[shape], multi_pod)
    theirs = ref_costmodel.memory_bytes(ref_get_arch(arch),
                                        REF_SHAPES[shape], multi_pod)
    assert ours == theirs                     # float for float, every key
    assert list(ours) == list(theirs)


def test_cells_and_model_flops_equal_reference():
    assert cells(include_skips=True) == ref_cells(include_skips=True)
    assert cells() == ref_cells()
    for arch, shape in cells(include_skips=True):
        assert roofline.model_flops_for(get_arch(arch), SHAPES[shape]) == \
            ref_roofline.model_flops_for(ref_get_arch(arch),
                                         REF_SHAPES[shape])


def test_shards_equal_reference():
    for mp in (False, True):
        assert (costmodel.Shards.for_mesh(mp).__dict__
                == ref_costmodel.Shards.for_mesh(mp).__dict__)


def test_h100_constants():
    assert PEAK_FLOPS == 989e12 and HBM_BW == 3.35e12 and NET_BW == 50e9


def test_terms_and_bottleneck():
    t = RooflineTerms(flops=PEAK_FLOPS, bytes_accessed=HBM_BW / 2,
                      coll_bytes=NET_BW / 4, coll_breakdown={},
                      model_flops=PEAK_FLOPS / 2)
    assert abs(t.t_compute - 1.0) < 1e-9
    assert abs(t.t_memory - 0.5) < 1e-9
    assert abs(t.t_collective - 0.25) < 1e-9
    assert t.bottleneck == "compute"
    assert abs(t.t_bound - 1.0) < 1e-9
    assert abs(t.roofline_frac - 0.5) < 1e-9
    assert abs(t.useful_flops_frac - 0.5) < 1e-9


def test_terms_collective_bound_and_dict_keys():
    t = RooflineTerms(flops=PEAK_FLOPS / 100, bytes_accessed=HBM_BW / 10,
                      coll_bytes=NET_BW, coll_breakdown={"total": NET_BW})
    assert t.bottleneck == "collective"
    assert abs(t.t_bound - 1.0) < 1e-9
    assert t.useful_flops_frac is None
    # no model FLOPs: the counted FLOPs over the bound
    assert abs(t.roofline_frac - 0.01) < 1e-12
    ref = ref_roofline.RooflineTerms(1.0, 1.0, 1.0, {})
    assert list(t.as_dict()) == list(ref.as_dict())


# the reference's HLO fixture and the same collectives as recorded events
HLO_EVENTS = [
    Collective("all-gather", 16 * 1024 * 2, 4),
    Collective("all-reduce", 256 * 4, 8),
    Collective("reduce-scatter", 64 * 4, 2),
    Collective("collective-permute", 32 * 32 * 2, 2),
]


def test_recorded_collectives_equal_reference_parser():
    from tests.test_roofline import HLO
    theirs = ref_roofline.collective_bytes(HLO)
    ours = collective_bytes(HLO_EVENTS)
    assert ours == theirs
    assert collective_bytes([tuple(e) for e in HLO_EVENTS]) == theirs


@pytest.mark.parametrize("kind", ["all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"])
@pytest.mark.parametrize("n", [1, 2, 16, 256])
def test_wire_factor_equals_reference(kind, n):
    assert roofline._wire_factor(kind, n) == ref_roofline._wire_factor(kind,
                                                                        n)


def test_counting_records_collectives_and_flops():
    """On a fake group of 8: a DTensor gather (functional all_gather over
    a mesh dim of 4), ``dist.all_reduce`` and ``dist.all_gather`` on a
    group of 2 (``c10d`` ops), and a matmul (2·m·n·k FLOPs)."""
    code = """
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Shard
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.roofline import analyze, counting
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=8)
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("a", "b"))
        x = DTensor.from_local(torch.ones(3, 5), mesh, [Shard(1), Shard(0)],
                               run_check=False)
        pair = dist.new_group([0, 1])
        with counting() as c:
            full = x.redistribute(mesh, [Shard(1), torch.distributed.tensor
                                         .Replicate()])
            t = torch.ones(6, dtype=torch.float32)
            dist.all_reduce(t, group=pair)
            outs = [torch.empty(6, dtype=torch.bfloat16) for _ in range(2)]
            dist.all_gather(outs, t.bfloat16(), group=pair)
            torch.ones(4, 7) @ torch.ones(7, 9)
        for e in c.collectives:
            print("EV", e.kind, e.result_bytes, e.group_size)
        print("FLOPS", int(c.flops))
        print("TOTAL", analyze(c).coll_bytes)
    """
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    ev = [ln.split()[1:] for ln in out.stdout.splitlines()
          if ln.startswith("EV")]
    assert ev == [["all-gather", str(12 * 5 * 4), "4"],
                  ["all-reduce", str(6 * 4), "2"],
                  ["all-gather", str(2 * 6 * 2), "2"]], out.stdout
    assert f"FLOPS {2 * 4 * 7 * 9}" in out.stdout, out.stdout
    want = 12 * 5 * 4 * 3 / 4 + 6 * 4 * 1 + 2 * 6 * 2 / 2
    total = float(out.stdout.split("TOTAL")[1].split()[0])
    assert abs(total - want) < 1e-9, (total, want)


def test_memory_model_orderings():
    """Decode is cache-dominated; train params cost more than serve."""
    cfg = get_arch("qwen3-8b")
    train = costmodel.memory_bytes(cfg, SHAPES["train_4k"])
    dec = costmodel.memory_bytes(cfg, SHAPES["decode_32k"])
    assert train["total"] > 0 and dec["total"] > 0
    assert dec["cache"] > 0 and train["cache"] == 0
    assert dec["cache"] > dec["layers"]
    assert train["layers"] > 100 * dec["layers"]
    t = costmodel.memory_bytes(get_arch("arctic-480b"), SHAPES["train_4k"])
    assert t["params_opt"] > 1e9 and np.isfinite(t["total"])


# ------------------------------------------------------------------ report
def _record(arch, shape, mesh, i, **kw):
    """A dry-run record with deterministic, distinct numbers."""
    t = RooflineTerms(flops=1e12 * (i + 1), bytes_accessed=3e9 * (i % 5 + 1),
                      coll_bytes=1e8 * (i % 7 + 1), coll_breakdown={},
                      model_flops=(None if i % 11 == 3 else 5e11 * (i + 1)))
    r = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
         "tag": "baseline", "roofline": t.as_dict(),
         "memory_analysis": {"argument_bytes": 1e9 * (i + 1),
                             "temp_bytes": (None if i % 4 == 1
                                            else 2e9 * i)}}
    r.update(kw)
    return r


def _records():
    recs = []
    for i, (arch, shape) in enumerate(cells()):
        for mesh in ("16x16", "2x16x16"):
            if i % 9 == 4:
                recs.append({"arch": arch, "shape": shape, "mesh": mesh,
                             "status": "error",
                             "error": "RuntimeError('x" + "y" * 80 + "')"})
            elif i % 13 == 6:
                continue                                   # missing
            elif i % 6 == 5:
                recs.append(_record(arch, shape, mesh, i,
                                    extrapolated=False))
            else:
                recs.append(_record(arch, shape, mesh, i))
    recs.append(_record("qwen3-8b", "train_4k", "16x16", 99, tag="other"))
    return recs


def _report_cli(module, path, mesh):
    """``python -m <module> <path> [mesh]``'s standard output."""
    r = subprocess.run([sys.executable, "-m", module, str(path)]
                       + ([mesh] if mesh else []), cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=SRC),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


@pytest.mark.parametrize("mesh", [None, "2x16x16"])
@pytest.mark.parametrize("records", ["mixed", "empty"])
def test_report_prints_the_reference_strings(tmp_path, mesh, records):
    """The port's report CLI prints the reference's CLI's table and
    summary, character for character, from the same JSONL records (ok,
    error, missing and compile-proof-only cells, another tag's record;
    or none), and its ``render``/``summarize`` are those strings."""
    path = tmp_path / "dryrun.jsonl"
    with open(path, "w") as f:
        for r in (_records() if records == "mixed" else []):
            f.write(json.dumps(r) + "\n")
    ours = _report_cli("repro_torch.launch.report", path, mesh)
    assert ours == _report_cli("repro.launch.report", path, mesh)
    res = report.load(str(path))
    assert ours == (report.render(res, mesh or "16x16") + "\n\n"
                    + report.summarize(res) + "\n")
    if records == "mixed":
        assert "ERR" in ours and "\\*" in ours
        assert len(report.load(str(path), tag="other")) == 1
