"""Nothing the benchmark runs loads JAX or the JAX package ``repro``:
module names are compared by their whole top-level name, so
``repro_torch`` passes and ``repro`` fails."""
from __future__ import annotations

import ast
import json
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest

from w2vbench import run as harness

from .conftest import ROOT

PKG = ROOT / "w2vbench"


@pytest.mark.parametrize("loaded, found", [
    (["repro_torch", "repro_torch.kernels.ops"], []),
    (["repro"], ["repro"]),
    (["repro.kernels.fullw2v"], ["repro"]),
    (["jax.numpy"], ["jax"]),
    (["jaxlib", "flax.linen"], ["flax", "jaxlib"]),
    (["reprox", "jax_like", "benchmarks_torch"], []),
    (["benchmarks.bench_serve"], ["benchmarks"]),
])
def test_forbidden_names_compare_whole(monkeypatch, loaded, found):
    mods = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in harness.FORBIDDEN}
    for name in loaded:
        mods[name] = object()
    monkeypatch.setattr(sys, "modules", mods)
    assert harness.loaded_forbidden() == found


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_of_the_benchmark_imports_jax_or_repro():
    for path in PKG.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in harness.FORBIDDEN, (path, mod)


def test_a_run_loads_neither_jax_nor_repro(tmp_path):
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{str(ROOT)!r}]
        from w2vbench.tests.conftest import tiny_bench
        from w2vbench import run
        out = run.execute("c", 3, 0.5, True, device="cpu",
                          bench=tiny_bench(), t_start=time.time())
        print("FOUND", run.loaded_forbidden())
    """)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert "FOUND []" in proc.stdout, proc.stderr[-3000:]


def test_without_a_card_no_result(tmp_path):
    """On a machine without CUDA the run exits non-zero and prints no
    result line; so it does from a directory holding only BENCHMARK.json
    and the benchmark's folder."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(PKG, tmp_path / "w2vbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run(
            [sys.executable, "-m", "w2vbench.run", "--workload",
             "text8.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        for line in proc.stdout.splitlines():
            with pytest.raises(ValueError):
                json.loads(line)
