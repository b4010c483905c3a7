"""The rest of the reference's public API in the port, held against the
reference on the CPU: ``plan_costs`` (the tiled kernel's replayed row
traffic and GEMM count, equal to the reference's dict value for value),
``load_text``, ``window_context_positions``, the deprecated ``ops`` entry
points (``sgns_update``, ``vocab_sharded_update``) and
``traceable_update``, ``W2VTrainer``, and the package exports of
``repro_torch.core``, ``.data`` and ``.train``. Last, a coverage test:
every public top-level name of every module of ``src/repro`` has a
counterpart of the same name in the same module of the port, or an entry
in :data:`NOT_BY_NAME` (read with ``ast``: neither tree is imported)."""
import ast
import pathlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro.data as ref_data
import repro.data.batching as ref_batching
import repro.train as ref_train
from repro.configs.w2v import W2VConfig as RefConfig
from repro.core import sgns as ref_sgns
from repro.data import corpus as ref_corpus
from repro.kernels import ops as ref_ops
from repro.kernels.registry import StepInputs as RefStep
from repro_torch import core, data, train
from repro_torch.configs.w2v import W2VConfig, smoke
from repro_torch.core import sgns
from repro_torch.core.trainer import TrainSession, W2VTrainer
from repro_torch.data import batching, corpus
from repro_torch.data.batching import BatchingPipeline
from repro_torch.data.corpus import synthetic_cluster_corpus
from repro_torch.distributed import vocab_placement as vp
from repro_torch.kernels import ops
from repro_torch.kernels.registry import StepInputs
from repro_torch.kernels.tables import Tables, TableSpec
from tests.conftest import REPO, make_distinct_negs, run_subprocess

TOL = dict(atol=2e-5, rtol=1e-4)      # the port's kernel tolerance
REF_SRC = pathlib.Path(REPO) / "src" / "repro"
PORT_SRC = pathlib.Path(REPO) / "src" / "repro_torch"


# ---------------------------------------------------------------------------
# plan_costs
# ---------------------------------------------------------------------------

def _costs_batch(seed: int, full: bool, S=12, L=40, N=5):
    """Half the sentences over 12 words (repeats: strict tiles), half over
    5,000 (fused tiles); lengths random in [0, L] or all L."""
    rng = np.random.default_rng(seed)
    tokens = np.concatenate([rng.integers(0, 12, size=(S // 2, L)),
                             rng.integers(0, 5000, size=(S - S // 2, L))])
    tokens = tokens.astype(np.int32)
    negs = make_distinct_negs(rng, tokens, 5000, N)
    lengths = (np.full(S, L) if full
               else rng.integers(0, L + 1, size=S)).astype(np.int32)
    return tokens, negs, lengths, N


@pytest.mark.parametrize("planner", ["port", "reference"])
@pytest.mark.parametrize("full", [False, True], ids=["random", "full"])
@pytest.mark.parametrize("G", [0, 2, 4])
@pytest.mark.parametrize("T", [1, 2, 4, 8, 16])
def test_plan_costs_equals_reference(T, G, full, planner):
    tokens, negs, lengths, N = _costs_batch(T * 10 + G, full)
    plan_tiles = (batching if planner == "port" else ref_batching).plan_tiles
    plan = plan_tiles(tokens, negs, lengths, T)
    got = batching.plan_costs(plan, lengths, N, gemm_windows=G)
    want = ref_batching.plan_costs(plan, lengths, N, gemm_windows=G)
    assert got == want
    assert {k: type(v) for k, v in got.items()} == \
        {k: type(v) for k, v in want.items()}
    # the other package's plan of the same batch gives the same counts
    other = (ref_batching if planner == "port" else batching).plan_tiles(
        tokens, negs, lengths, T)
    assert batching.plan_costs(other, lengths, N, gemm_windows=G) == want
    if T > 1:           # both branches of the replay ran
        live = np.arange(plan.n_tiles)[None, :] * T < lengths[:, None]
        assert plan.strict[live].any() and not plan.strict[live].all()


def _random_batch(rng, S, L, V, N):
    tokens = rng.integers(0, V, size=(S, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    lengths = rng.integers(0, L + 1, size=(S,)).astype(np.int32)
    return tokens, negs, lengths


@pytest.mark.parametrize("mod", [batching, ref_batching],
                         ids=["port", "reference"])
def test_plan_costs_t1_equals_sequential(mod):
    """The replay at T=1 gives the sequential kernel's counts: 2 ring +
    2(N+1) rows and 3 GEMMs a window (the reference's test, both
    packages)."""
    rng = np.random.default_rng(0)
    V, L, N = 50, 16, 5
    tokens, negs, lengths = _random_batch(rng, 4, L, V, N)
    costs = mod.plan_costs(mod.plan_tiles(tokens, negs, lengths, 1),
                           lengths, N)
    assert costs["windows"] == int(lengths.sum())
    assert costs["dma_per_window"] == 2 + 2 * (N + 1)
    assert costs["gemms_per_window"] == 3.0


@pytest.mark.parametrize("mod", [batching, ref_batching],
                         ids=["port", "reference"])
def test_plan_costs_tiling_reduces_gemms(mod):
    rng = np.random.default_rng(1)
    V, L, N, tile = 500, 32, 5, 8
    tokens, negs, lengths = _random_batch(rng, 4, L, V, N)
    lengths[:] = L                    # full sentences
    p1 = mod.plan_costs(mod.plan_tiles(tokens, negs, lengths, 1), lengths, N)
    p8 = mod.plan_costs(mod.plan_tiles(tokens, negs, lengths, tile),
                        lengths, N)
    # collision-free tiles collapse 3 GEMMs/window to 3 GEMMs/tile
    assert p8["gemms_per_window"] < p1["gemms_per_window"]
    assert p8["dma_per_window"] <= p1["dma_per_window"]


# ---------------------------------------------------------------------------
# load_text, window_context_positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [3, 1000])
def test_load_text_equals_reference(tmp_path, max_len):
    long_line = " ".join(f"w{i}" for i in range(2 * max_len + 1))
    raw = (b"the quick  brown fox\n\n   \n"
           + long_line.encode() + b"\n"
           + b"bad \xff\xfe bytes caf\xc3\xa9\n"
           + b"\tlast line without newline")
    path = tmp_path / "corpus.txt"
    path.write_bytes(raw)
    got = list(corpus.load_text(str(path), max_sentence_len=max_len))
    want = list(ref_corpus.load_text(str(path), max_sentence_len=max_len))
    assert got == want
    assert all(0 < len(s) <= max_len for s in got)
    assert any("�" in w for s in got for w in s)    # bytes replaced
    assert [w for c in got for w in c if w[0] == "w" and w[1:].isdigit()] \
        == long_line.split()                        # split, nothing lost


def test_window_context_positions_equals_reference():
    for length in range(0, 10):
        for w_f in range(0, 5):
            for t in range(-1, length + 2):
                assert sgns.window_context_positions(t, w_f, length) == \
                    ref_sgns.window_context_positions(t, w_f, length)


# ---------------------------------------------------------------------------
# the deprecated ops entry points and traceable_update
# ---------------------------------------------------------------------------

def _toy(seed: int, tile: int, V=30, d=128, L=10, N=3):
    rng = np.random.default_rng(seed)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, V, size=(2, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    lengths = np.array([L, L - 3], np.int32)
    plan = (batching.plan_tiles(tokens, negs, lengths, tile) if tile > 1
            else None)
    return w_in, w_out, tokens, negs, lengths, plan


def _port_step(tokens, negs, lengths, plan, lr=0.05):
    kw = {}
    if plan is not None:
        kw = dict(zip(("plan_uniq", "plan_scatter", "plan_ucount",
                       "plan_strict"),
                      (torch.from_numpy(a) for a in (
                          plan.uniq, plan.scatter, plan.ucount,
                          plan.strict))))
    return StepInputs(torch.from_numpy(tokens), torch.from_numpy(negs),
                      torch.from_numpy(lengths),
                      torch.tensor(lr, dtype=torch.float32), **kw)


def _ref_step(tokens, negs, lengths, plan, lr=0.05):
    kw = {}
    if plan is not None:
        kw = dict(zip(("plan_uniq", "plan_scatter", "plan_ucount",
                       "plan_strict"),
                      (jnp.asarray(a) for a in (
                          plan.uniq, plan.scatter, plan.ucount,
                          plan.strict))))
    return RefStep(jnp.asarray(tokens), jnp.asarray(negs),
                   jnp.asarray(lengths), jnp.float32(lr), **kw)


@pytest.mark.parametrize("tile", [1, 4])
def test_sgns_update_warns_and_equals_step(tile):
    """The shim warns, updates in place, equals ``ops.step`` on copies bit
    for bit, and the reference's ``sgns_update`` (``jnp``) within the
    kernel tolerance."""
    w_in, w_out, tokens, negs, lengths, plan = _toy(tile, tile)
    cfg = W2VConfig(dim=128, window=3)            # w_f = 2
    step = _port_step(tokens, negs, lengths, plan)
    a_in, a_out = torch.from_numpy(w_in.copy()), torch.from_numpy(
        w_out.copy())
    with pytest.warns(DeprecationWarning, match="sgns_update"):
        got = ops.sgns_update(a_in, a_out, step, cfg)
    assert got[0] is a_in and got[1] is a_out
    want = ops.step(Tables(w_in=torch.from_numpy(w_in.copy()),
                           w_out=torch.from_numpy(w_out.copy())), step, cfg)
    assert torch.equal(got[0], want.w_in) and torch.equal(got[1], want.w_out)
    assert not np.array_equal(got[0].numpy(), w_in)           # it trained
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        r_in, r_out = ref_ops.sgns_update(
            jnp.asarray(w_in), jnp.asarray(w_out),
            _ref_step(tokens, negs, lengths, plan), RefConfig(dim=128,
                                                              window=3),
            backend="jnp")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(r_in), **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(r_out), **TOL)


def test_sgns_update_rejects_sharded_steps_and_cuda_off_the_gpu():
    w_in, w_out, tokens, negs, lengths, _ = _toy(0, 1)
    cfg = W2VConfig(dim=128, window=3)
    step = _port_step(tokens, negs, lengths, None)
    sharded = _port_step(tokens, negs, lengths, None)
    sharded.cold_ids = torch.zeros((1, 8), dtype=torch.int32)
    tabs = (torch.from_numpy(w_in), torch.from_numpy(w_out))
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError, match="single-replica"):
            ops.sgns_update(*tabs, sharded, cfg)
    for name in ("cuda", "cuda_pipelined"):
        with pytest.warns(DeprecationWarning):
            with pytest.raises(ValueError, match="runs only on the GPU"):
                ops.sgns_update(*tabs, step, cfg, backend=name)


@pytest.mark.parametrize("tile", [1, 4])
def test_traceable_update_is_the_step_update(tile):
    w_in, w_out, tokens, negs, lengths, plan = _toy(10 + tile, tile)
    cfg = W2VConfig(dim=128, window=3)
    step = _port_step(tokens, negs, lengths, plan)
    name = "torch_tiled" if tile > 1 else "torch"
    run = ops.traceable_update(name, ops.static_for(cfg, tile))
    a = (torch.from_numpy(w_in.copy()), torch.from_numpy(w_out.copy()))
    got = run(*a, step)
    assert got[0] is a[0] and got[1] is a[1]                  # in place
    want = ops.step(Tables(w_in=torch.from_numpy(w_in.copy()),
                           w_out=torch.from_numpy(w_out.copy())), step, cfg,
                    backend=name)
    assert torch.equal(got[0], want.w_in) and torch.equal(got[1], want.w_out)
    # no fallback: a CUDA kernel given CPU tensors raises
    cuda = "cuda_tiled" if tile > 1 else "cuda"
    with pytest.raises(ValueError, match="one CUDA device"):
        ops.traceable_update(cuda, ops.static_for(cfg, tile))(*a, step)


def _sharded_case(tile: int, seed: int):
    cfg = smoke(dim=16, sentences_per_batch=64, tile_windows=tile,
                vocab_shard=True, hot_vocab_frac=0.3)
    pipe = BatchingPipeline(synthetic_cluster_corpus(
        n_clusters=6, words_per_cluster=12, n_sentences=200, mean_len=12,
        seed=seed), cfg)
    batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    pl = vp.VocabPlacement.plan(pipe.vocab.counts, 1, hot_frac=0.3)
    rng = np.random.default_rng(seed)
    tabs = [(rng.normal(size=(n, 16)) * 0.1).astype(np.float32)
            for n in (pl.hot, pl.hot, pl.cold_per_shard, pl.cold_per_shard)]
    return cfg, pl, tabs, vp.plan_exchange(batch, pl).step_inputs(cfg.lr,
                                                                  "cpu")


@pytest.mark.parametrize("exchange", ["exact", "dense"])
@pytest.mark.parametrize("tile", [1, 4])
def test_vocab_sharded_update_runner_equals_step(tile, exchange):
    """The shim's 4-tuple runner at one shard equals ``ops.step`` on the
    same vocab-sharded tables bit for bit, in place."""
    cfg, pl, tabs, step = _sharded_case(tile, seed=tile)
    name = "torch_tiled" if tile > 1 else "torch"
    with pytest.warns(DeprecationWarning, match="vocab_sharded_update"):
        run4 = ops.vocab_sharded_update(name, ops.static_for(cfg, tile), pl,
                                        exchange=exchange)
    mine = [torch.from_numpy(t.copy()) for t in tabs]
    got = run4(*mine, step)
    assert len(got) == 4 and all(g is m for g, m in zip(got, mine))
    t = [torch.from_numpy(a.copy()) for a in tabs]
    want = ops.step(Tables(w_in=t[0], w_out=t[1], cold_in=t[2], cold_out=t[3],
                           spec=TableSpec(vocab_shard=True,
                                          exchange=exchange),
                           placement=pl), step, cfg, backend=name)
    for g, w in zip(got, (want.w_in, want.w_out, want.cold_in,
                          want.cold_out)):
        assert torch.equal(g, w)
    assert not np.array_equal(got[2].numpy(), tabs[2])         # cold moved
    # no fallback: a CUDA kernel given CPU tensors raises
    with pytest.warns(DeprecationWarning):
        run_cuda = ops.vocab_sharded_update("cuda_tiled" if tile > 1
                                            else "cuda",
                                            ops.static_for(cfg, tile), pl)
    with pytest.raises(ValueError, match="one CUDA device"):
        run_cuda(*[torch.from_numpy(a.copy()) for a in tabs], step)


def test_w2v_trainer_is_the_session():
    assert W2VTrainer is TrainSession


# ---------------------------------------------------------------------------
# package exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("port,ref", [(core, ref_core), (data, ref_data),
                                      (train, ref_train)],
                         ids=["core", "data", "train"])
def test_exports_equal_the_references(port, ref):
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        obj = getattr(port, name)
        assert obj.__module__.startswith(port.__name__ + "."), name
        assert obj.__name__ == getattr(ref, name).__name__, name
    with pytest.raises(AttributeError):
        getattr(port, "not_an_export")


@pytest.mark.parametrize("pkg,torch_free", [
    ("repro_torch", False), ("repro_torch.core", False),
    ("repro_torch.data", True), ("repro_torch.train", True)])
def test_package_import_leaves_jax_and_reference_unloaded(pkg, torch_free):
    """Importing the package loads neither jax nor the reference (nor
    torch, for ``data`` and ``train``); resolving every export then loads
    neither jax nor the reference."""
    code = f"""
        import importlib, sys
        mod = importlib.import_module({pkg!r})
        def loaded(*roots):
            return sorted(n for n in sys.modules if n.split(".")[0] in roots)
        print("TORCH", loaded("torch")[:1])
        print("BAD", loaded("jax", "repro", "ml_dtypes"))
        for name in getattr(mod, "__all__", ()):
            getattr(mod, name)
        print("AFTER", loaded("jax", "repro", "ml_dtypes"))
    """
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout and "AFTER []" in out.stdout, out.stdout
    if torch_free:
        assert "TORCH []" in out.stdout, out.stdout


# ---------------------------------------------------------------------------
# coverage: every public name of the reference has its counterpart
# ---------------------------------------------------------------------------

_TPU_LAYOUT = ("a TPU tiling rule (vreg lanes and sublanes): the port's "
               "kernels take any d")

# (module path under src/repro, name) -> the port's counterpart in the same
# module, or why it has none
NOT_BY_NAME = {
    ("kernels/fullw2v.py", "tiled_scratch_rows"): "tiled_smem_bytes",
    ("kernels/fullw2v.py", "LANE"): _TPU_LAYOUT,
    ("kernels/fullw2v.py", "SUBLANE"): _TPU_LAYOUT,
    ("kernels/fullw2v.py", "fullw2v_pallas"): "fullw2v_cuda",
    ("kernels/fullw2v.py", "fullw2v_pallas_tiled"): "fullw2v_cuda_tiled",
    ("kernels/fullw2v.py", "fullw2v_pallas_tiled_fused"):
        "fullw2v_cuda_tiled_fused",
    ("launch/roofline.py", "ICI_BW"): "NET_BW",
    ("models/layers.py", "ATTN_Q_CHUNK"):
        "a constant the reference defines and never uses",
    ("serve/index.py", "log"):
        "the reference module's logger; the port's index logs nothing",
}


def _public_names(path: pathlib.Path) -> set:
    """Names a module's top level defines (functions, classes, assigned
    names), without leading underscores; imports are not definitions."""
    names = set()

    def targets(t):
        if isinstance(t, ast.Name):
            names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                targets(e)

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                targets(t)
        elif isinstance(node, ast.AnnAssign):
            targets(node.target)
    return {n for n in names if not n.startswith("_")}


def test_every_public_reference_name_has_a_counterpart():
    missing, used = [], set()
    for ref_path in sorted(REF_SRC.rglob("*.py")):
        rel = ref_path.relative_to(REF_SRC).as_posix()
        port_path = PORT_SRC / rel
        assert port_path.exists(), f"no port module for src/repro/{rel}"
        port = _public_names(port_path)
        for name in sorted(_public_names(ref_path) - port):
            entry = NOT_BY_NAME.get((rel, name))
            if entry is None:
                missing.append(f"{rel}:{name}")
                continue
            used.add((rel, name))
            if entry.isidentifier():       # a counterpart, not a reason
                assert entry in port, f"{rel}: no {entry} for {name}"
    assert not missing, f"reference names without a counterpart: {missing}"
    assert used == set(NOT_BY_NAME), f"stale entries: {set(NOT_BY_NAME) - used}"
