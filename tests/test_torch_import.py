"""The torch port stands alone: importing ``repro_torch`` (every module,
``repro_torch.distributed`` included) and ``chip_smoke`` leaves ``jax`` and
the reference package ``repro`` unloaded, and no source of the port names
them in an import."""
import ast
import os
import pathlib

import pytest

from tests.conftest import REPO, run_subprocess

PORT = pathlib.Path(REPO) / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [pathlib.Path(REPO) / "chip_smoke.py"]


def test_import_leaves_jax_and_reference_unloaded():
    code = """
        import importlib, pkgutil, sys
        sys.path.insert(0, {repo!r})
        import repro_torch
        mods = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for name in mods:
            importlib.import_module(name)
        import chip_smoke
        bad = sorted(n for n in sys.modules
                     if n == "jax" or n.startswith("jax.")
                     or n == "repro" or n.startswith("repro."))
        print("MODULES", len(mods))
        print("DISTRIBUTED", "repro_torch.distributed.vocab_placement" in mods)
        print("BAD", bad)
    """.format(repo=REPO)
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("MODULES")[1].split()[0])
    assert n >= 19, out.stdout       # every module of the package imported
    assert "DISTRIBUTED True" in out.stdout, out.stdout


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_reference(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)
