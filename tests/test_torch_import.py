"""The torch port stands alone: importing ``repro_torch`` (every module,
``repro_torch.distributed``, ``repro_torch.train`` and
``repro_torch.kernels.quant`` included), ``chip_smoke`` and
``tools/torch_chaos.py`` (its entry point's imports too) leaves ``jax``,
``ml_dtypes`` and the reference package ``repro`` unloaded, and no source of the port names them in an import. A process
prefetch worker's import path (and the CLI module, which such a worker
imports as its main module, and the mesh launcher it imports for more
than one rank) leaves ``torch`` unloaded too, and so does the serving CLI
module, which its ranks import as their main module, and the chaos
tool's top level, which its workers import as theirs. The LM substrate
(configs, models, elastic, compression, the sharding rules, AdamW, the
steps and the training loop) loads neither jax nor the reference, also
when a ``Trainer`` takes a step, and its configs load no torch; nor do the
dry-run and roofline modules (costmodel, roofline, dryrun, report), also
when a cell runs on a fake process group and its table is rendered."""
import ast
import os
import pathlib

import pytest

from tests.conftest import REPO, run_subprocess

PORT = pathlib.Path(REPO) / "src" / "repro_torch"
TOOL = pathlib.Path(REPO) / "tools" / "torch_chaos.py"
SOURCES = sorted(PORT.rglob("*.py")) + [pathlib.Path(REPO) / "chip_smoke.py",
                                        TOOL]
# tools/torch_chaos.py as a module, without running its entry point
LOAD_TOOL = """
        import importlib.util
        spec = importlib.util.spec_from_file_location("torch_chaos", {tool!r})
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
"""


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
        {load_tool}
        try:
            tool.main(["--help"])       # imports what its runs import
        except SystemExit:
            pass
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "repro", "ml_dtypes"))
        print("MODULES", len(mods))
        print("DISTRIBUTED", "repro_torch.distributed.vocab_placement" in mods)
        print("MESH", sorted(m for m in mods if m in (
            "repro_torch.launch.mesh", "repro_torch.distributed.collectives")))
        print("TRAIN", sorted(m for m in mods if m.startswith(
            "repro_torch.train.")))
        print("KERNELS", sorted(m for m in mods if m.startswith(
            "repro_torch.kernels.")))
        print("SLICE", sorted(m for m in mods if m.startswith(
            ("repro_torch.frontends", "repro_torch.core."))))
        print("SERVE", sorted(m for m in mods if m.startswith(
            ("repro_torch.serve", "repro_torch.launch.serve"))))
        print("LM", sorted(m for m in mods if m.startswith(
            ("repro_torch.models", "repro_torch.configs.",
             "repro_torch.distributed.elastic",
             "repro_torch.distributed.compression",
             "repro_torch.distributed.sharding", "repro_torch.launch.steps",
             "repro_torch.train.optim", "repro_torch.train.loop",
             "repro_torch.tree", "repro_torch.launch.costmodel",
             "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
             "repro_torch.launch.report"))))
        print("BAD", bad)
    """.format(repo=REPO, load_tool=LOAD_TOOL.format(tool=str(TOOL)).strip())
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("MODULES")[1].split()[0])
    assert n >= 25, out.stdout       # every module of the package imported
    assert "DISTRIBUTED True" in out.stdout, out.stdout
    assert ("MESH ['repro_torch.distributed.collectives', "
            "'repro_torch.launch.mesh']") in out.stdout, out.stdout
    for mod in ("chaos", "checkpoint", "resilience", "supervisor"):
        assert f"'repro_torch.train.{mod}'" in out.stdout, out.stdout
    for mod in ("quant", "tables", "ops", "registry"):
        assert f"'repro_torch.kernels.{mod}'" in out.stdout, out.stdout
    assert "'repro_torch.data.prefetch'" not in out.stdout  # not train.*
    for mod in ("frontends", "frontends.registry", "frontends.node2vec",
                "frontends.doc2vec", "frontends.subword", "core.window",
                "core.baselines"):
        assert f"'repro_torch.{mod}'" in out.stdout, out.stdout
    assert ("SERVE ['repro_torch.launch.serve', 'repro_torch.serve', "
            "'repro_torch.serve.chaos', 'repro_torch.serve.index', "
            "'repro_torch.serve.query', 'repro_torch.serve.server', "
            "'repro_torch.serve.snapshot']") in out.stdout, out.stdout
    lm = out.stdout.split("LM ")[1].splitlines()[0]
    for mod in LM_MODULES:
        assert f"'repro_torch.{mod}'" in lm, out.stdout


LM_PRESETS = ("mamba2_1p3b", "moonshot_v1_16b_a3b", "arctic_480b",
              "starcoder2_3b", "deepseek_67b", "phi3_medium_14b", "qwen3_8b",
              "musicgen_large", "jamba_1p5_large_398b", "internvl2_76b")
LM_MODULES = (("models", "models.layers", "models.lm", "models.moe",
               "models.ssm", "configs.base", "distributed.elastic",
               "distributed.compression", "distributed.sharding",
               "launch.steps", "train.optim", "train.loop", "tree",
               "launch.costmodel", "launch.roofline", "launch.dryrun",
               "launch.report")
              + tuple(f"configs.{p}" for p in LM_PRESETS))


def test_lm_substrate_leaves_jax_and_reference_unloaded():
    """The LM substrate alone (configs and every preset, the models, the
    elastic and compression helpers, ``convert``), used on the CPU, loads
    neither jax nor the reference; the configs alone load no torch
    either."""
    code = """
        import sys
        import repro_torch.configs as configs
        configs.list_archs()
        print("CONFIGS", sorted(n for n in sys.modules
                                if n.split(".")[0] in ("torch", "jax",
                                                       "repro")))
        import importlib
        for mod in {mods!r}:
            importlib.import_module("repro_torch." + mod)
        from repro_torch.convert import lm_params_from_reference
        from repro_torch.models import lm
        from repro_torch.distributed import compression, elastic
        cfg = configs.get_smoke("jamba-1.5-large-398b")
        p = lm.init_params(cfg, device="cpu")
        import torch
        lm.forward(cfg, p, torch.zeros((1, 4), dtype=torch.long))
        compression.compress_tree(p["embed"], compression.ef_init(p["embed"]))
        elastic.plan_mesh(64, 8)
        from repro_torch.convert import adamw_state_from_reference
        from repro_torch.distributed.sharding import Rules, param_shardings
        from repro_torch.launch.steps import build_cell
        from repro_torch.train.loop import LoopConfig, Trainer
        from repro_torch.train.optim import AdamWConfig
        Trainer(cfg, AdamWConfig(total_steps=1), LoopConfig(steps=1),
                batch=2, seq=4, device="cpu").train()
        param_shardings(lm.abstract_params(cfg),
                        Rules({{"data": 16, "model": 16}}))
        print("BAD", sorted(n for n in sys.modules
                            if n.split(".")[0] in ("jax", "repro",
                                                   "ml_dtypes")))
    """.format(mods=LM_MODULES)
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "CONFIGS []" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_dryrun_leaves_jax_and_reference_unloaded():
    """A dry-run cell (the expert-parallel MoE of smoke moonshot on a fake
    ``(data=2, model=2)`` group) and its report load neither jax nor the
    reference."""
    code = """
        import dataclasses, sys
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import SHAPES, InputShape
        from repro_torch.launch import dryrun, report
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        SHAPES["tiny_train"] = InputShape("tiny_train", 32, 4, "train")
        rec = dryrun.run_cell("moonshot-v1-16b-a3b", "tiny_train", False,
                              cfg=get_smoke("moonshot-v1-16b-a3b"),
                              mesh=mesh, verbose=False)
        report.summarize({("a", "b", "c"): rec})
        print("STATUS", rec["status"], rec["roofline"]["flops"] > 0)
        print("BAD", sorted(n for n in sys.modules
                            if n.split(".")[0] in ("jax", "repro",
                                                   "ml_dtypes")))
    """
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "STATUS ok True" in out.stdout, out.stdout
    assert "BAD []" in out.stdout, out.stdout


def test_worker_import_path_is_torch_free():
    """What a process prefetch worker imports — the finalize path with a
    vocab-sharding placement — and the CLI modules (a worker's or a
    rank's ``__mp_main__`` under ``python -m``) load neither torch nor jax
    nor the reference."""
    code = """
        import sys
        from repro_torch.configs.w2v import smoke
        from repro_torch.data.corpus import synthetic_zipf_corpus
        from repro_torch.data import prefetch
        from repro_torch.distributed.vocab_placement import VocabPlacement
        import repro_torch.launch.mesh
        import repro_torch.launch.serve
        import repro_torch.launch.train
        {load_tool}
        cfg = smoke(sentences_per_batch=16, max_sentence_len=16,
                    tile_windows=4, vocab_shard=True)
        pipe = prefetch.AsyncBatchingPipeline(
            synthetic_zipf_corpus(vocab_size=100, n_sentences=40,
                                  mean_len=8, seed=0), cfg, workers=1)
        pipe.placement = VocabPlacement.plan(pipe.vocab.counts, 2)
        packed = next(pipe._packed(16, 0))
        prefetch._proc_init(cfg, pipe.sampler, pipe.placement, None)
        batch = prefetch._proc_finalize(packed, 0)
        assert batch.plan is not None and batch.exchange is not None
        print("BAD", sorted(n for n in sys.modules
                            if n.split(".")[0] in ("torch", "jax", "repro")))
    """.format(load_tool=LOAD_TOOL.format(tool=str(TOOL)).strip())
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


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
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, sorted(roots)


def test_slice_modules_leave_jax_and_reference_unloaded():
    """The frontends, the ring-lifetime state machine and the baselines
    import neither jax nor the reference (the baselines import torch)."""
    code = """
        import sys
        import repro_torch.frontends, repro_torch.core.window
        import repro_torch.core.baselines
        from repro_torch.frontends import doc2vec, node2vec, subword
        from repro_torch import frontends
        print("NAMES", ",".join(frontends.names()))
        print("BAD", sorted(n for n in sys.modules
                            if n.split(".")[0] in ("jax", "repro",
                                                   "ml_dtypes")))
    """
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    assert "NAMES w2v,doc2vec,node2vec,subword" in out.stdout, out.stdout


def test_frontend_worker_import_path_is_torch_free():
    """A process prefetch worker of a frontend workload — the walks, the
    documents and the bag table built by ``repro_torch.frontends``, the
    finalize path with a bag table — loads neither torch nor jax nor the
    reference."""
    code = """
        import sys
        from repro_torch import frontends
        from repro_torch.configs.w2v import smoke
        from repro_torch.data import prefetch
        for name in ("node2vec", "doc2vec", "subword"):
            w = frontends.get(name).build(
                smoke(sentences_per_batch=16, tile_windows=4),
                communities=4, nodes_per=6, walks_per_node=1, docs=4,
                vocab=64, clusters=4, sentences=40, buckets=32)
            pipe = prefetch.AsyncBatchingPipeline(w.corpus, w.cfg, workers=1)
            w.attach(pipe)
            packed = next(pipe._packed(16, 0))
            prefetch._proc_init(w.cfg, pipe.sampler, None, pipe.bag_table)
            batch = prefetch._proc_finalize(packed, 0)
            assert (batch.docs is not None) == (name == "doc2vec")
            assert (batch.bags is not None) == (name == "subword")
        print("BAD", sorted(n for n in sys.modules
                            if n.split(".")[0] in ("torch", "jax", "repro")))
    """
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
