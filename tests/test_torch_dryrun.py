"""The port's dry-run (``repro_torch.launch.dryrun``) held to what the
dry-run half of ``tests/test_multidevice.py`` intends.

On a fake process group of 8 ranks as a ``(pod=2, data=2, model=2)``
``DeviceMesh`` (a subprocess: it owns the default group), for the
reference's reduced qwen3 smoke (``n_heads=4, n_kv_heads=2``) at its
``tiny_train`` and ``tiny_decode`` shapes (64 tokens, batch 8):

* ``run_cell`` gives ``status: "ok"`` and FLOPs > 0;
* the 2/3-block extrapolation of a 4-layer config equals a direct
  4-layer count (FLOPs exactly, collective bytes to 1e-12);
* ``argument_bytes`` equals the local shard bytes the cell's argument
  specs imply;
* ``memory_model`` equals the reference's ``costmodel.memory_bytes``;
* ``model_flops`` equals the reference's own dry-run of the cell (its
  ``build_cell`` lowered and compiled on 8 host devices as an Auto-axis
  mesh, ``analyze(..., model_flops=...)``, in a subprocess).

The CLI writes records with the reference's keys (``decode_32k`` of
qwen3-8b on the 256-rank single pod) and records a failing cell as
``status: "error"`` with exit code 1.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs import get_smoke as ref_get_smoke
from repro.configs.base import InputShape as RefInputShape
from repro.launch import costmodel as ref_costmodel
from tests.conftest import REPO, SRC, run_subprocess

TINY = {"tiny_train": (64, 8, "train"), "tiny_decode": (64, 8, "decode")}

PORT = """
    import dataclasses
    import json

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import SHAPES, InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import build_cell
    from repro_torch.tree import tree_leaves

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), n_heads=4, n_kv_heads=2)
    cfg4 = dataclasses.replace(cfg, n_layers=4)
    out = {}
    for name, (s, b, kind) in TINY.items():
        SHAPES[name] = InputShape(name, s, b, kind)
        kw = dict(cfg=cfg, mesh=mesh, param_dtype="float32", verbose=False)
        out[name] = dryrun.run_cell("qwen3-8b", name, True, **kw)
        kw["cfg"] = cfg4
        out[name + "/extrap4"] = dryrun.run_cell("qwen3-8b", name, True, **kw)
        out[name + "/direct4"] = dryrun.run_cell("qwen3-8b", name, True,
                                                 extrap=False, **kw)
        cell, args, _ = build_cell(cfg, name, mesh, param_dtype=torch.float32)
        total = 0
        for x, sh in zip(tree_leaves(args), tree_leaves(cell.in_shardings)):
            n = x.element_size()
            for dim, axes in zip(x.shape, sh.spec):
                k = 1
                for a in (() if axes is None else
                          (axes,) if isinstance(axes, str) else axes):
                    k *= sizes[a]
                n *= dim // k
            total += n
        out[name + "/spec_bytes"] = total
    print("JSON" + json.dumps(out))
""".replace("TINY", repr(TINY))

REFERENCE = """
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import SHAPES, get_smoke
    from repro.configs.base import InputShape
    from repro.launch.roofline import analyze, model_flops_for
    from repro.launch.steps import build_cell

    assert jax.device_count() == 8
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), n_heads=4, n_kv_heads=2)
    for name, (s, b, kind) in TINY.items():
        SHAPES[name] = InputShape(name, s, b, kind)
        jit, args, rules = build_cell(cfg, name, mesh,
                                      param_dtype=jnp.float32)
        t = analyze(jit.lower(*args).compile(),
                    model_flops=model_flops_for(cfg, SHAPES[name]) / 8)
        print("MODEL_FLOPS", name, repr(t.model_flops), t.flops > 0)
""".replace("TINY", repr(TINY))

REF_KEYS = {"arch", "shape", "mesh", "n_devices", "status", "tag",
            "variant", "compile_s", "extrap_compile_s", "raw_hlo_costs",
            "memory_model", "memory_analysis", "roofline"}
REF_MEMORY_KEYS = ["argument_bytes", "output_bytes", "temp_bytes",
                   "generated_code_bytes", "alias_bytes"]
REF_RAW_KEYS = ["flops", "bytes_accessed", "coll_bytes",
                "hlo_bytes_extrapolated"]


@pytest.fixture(scope="module")
def port():
    r = run_subprocess(PORT, timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JSON")][0]
    return json.loads(line[4:])


@pytest.mark.parametrize("shape", list(TINY))
def test_run_cell_on_a_small_pod_mesh(port, shape):
    r = port[shape]
    assert r["status"] == "ok" and r["mesh"] == "2x2x2"
    assert r["n_devices"] == 8
    assert r["roofline"]["flops"] > 0
    assert r["memory_analysis"]["argument_bytes"] > 0
    assert r["memory_analysis"]["temp_bytes"] is not None
    assert set(r) == REF_KEYS
    if TINY[shape][2] == "train":
        # data-parallel gradients: an all-reduce a leaf over the data axes
        assert r["roofline"]["coll_breakdown"]["all-reduce"] > 0


@pytest.mark.parametrize("shape", list(TINY))
def test_extrapolation_equals_a_direct_count(port, shape):
    ext = port[shape + "/extrap4"]["roofline"]
    direct = port[shape + "/direct4"]["roofline"]
    assert port[shape + "/direct4"]["extrapolated"] is False
    assert ext["flops"] == direct["flops"] > 0
    assert abs(ext["coll_bytes"] - direct["coll_bytes"]) <= \
        1e-12 * direct["coll_bytes"]
    for k, v in direct["coll_breakdown"].items():
        assert abs(ext["coll_breakdown"][k] - v) <= 1e-12 * max(v, 1.0)
    mem_e = port[shape + "/extrap4"]["memory_analysis"]
    mem_d = port[shape + "/direct4"]["memory_analysis"]
    assert mem_e["argument_bytes"] == mem_d["argument_bytes"]
    assert mem_e["output_bytes"] == mem_d["output_bytes"]
    assert mem_e["alias_bytes"] == mem_d["alias_bytes"]


@pytest.mark.parametrize("shape", list(TINY))
def test_argument_bytes_are_the_specs_shard_bytes(port, shape):
    assert port[shape]["memory_analysis"]["argument_bytes"] == \
        port[shape + "/spec_bytes"]


@pytest.mark.parametrize("shape", list(TINY))
def test_memory_model_equals_reference(port, shape):
    cfg = dataclasses.replace(ref_get_smoke("qwen3-8b"), n_heads=4,
                              n_kv_heads=2)
    s, b, kind = TINY[shape]
    want = ref_costmodel.memory_bytes(cfg, RefInputShape(shape, s, b, kind),
                                      True)
    assert port[shape]["memory_model"] == want


def test_model_flops_equal_the_reference_dry_run(port):
    r = run_subprocess(REFERENCE, n_devices=8, timeout=400)
    assert r.returncode == 0, r.stderr[-3000:]
    seen = 0
    for ln in r.stdout.splitlines():
        if ln.startswith("MODEL_FLOPS"):
            _, name, value, positive = ln.split()
            assert positive == "True"
            assert port[name]["roofline"]["model_flops"] == float(value)
            seen += 1
    assert seen == len(TINY), r.stdout


def _cli(tmp_path, *args):
    out = tmp_path / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        *args, "--out", str(out)], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=400)
    return r, [json.loads(ln) for ln in out.read_text().splitlines()]


def test_cli_writes_records_with_the_reference_keys(tmp_path):
    r, recs = _cli(tmp_path, "--arch", "qwen3-8b", "--shape", "decode_32k")
    assert r.returncode == 0, r.stderr[-3000:]
    assert len(recs) == 1
    rec = recs[0]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_devices"] == 256
    assert set(rec) == REF_KEYS
    assert list(rec["memory_analysis"]) == REF_MEMORY_KEYS
    assert list(rec["raw_hlo_costs"]) == REF_RAW_KEYS
    t = rec["roofline"]
    for k in ("t_compute", "t_memory", "t_collective", "roofline_frac"):
        assert t[k] >= 0 and t[k] == t[k] and t[k] != float("inf")
    # the token reads this rank's block of the cache and gathers no leaf
    assert t["bottleneck"] == "memory"


def test_cli_records_a_failing_cell_and_exits_1(tmp_path):
    r, recs = _cli(tmp_path, "--arch", "qwen3-8b", "--shape", "decode_32k",
                   "--param-dtype", "no_such_dtype")
    assert r.returncode == 1
    assert len(recs) == 1 and recs[0]["status"] == "error"
    assert set(recs[0]) == {"arch", "shape", "mesh", "status", "error"}
