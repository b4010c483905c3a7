"""The port's mixed-precision tables (bf16 and int8 storage with keyed
stochastic rounding) against the reference's, on the CPU at smoke size.

Every case hands the reference and the port the same storage bits
(``convert.params_from_reference``). One ``ops.step`` on the plain
versions against the reference's ``jnp`` backends: the f32 stage within
the kernel tolerance (atol 2e-5 / rtol 1e-4), the stored tables within one
quantum on every element (one bf16 ulp, one int8 step; scales within rtol
1e-6). Three batches of a ``TrainSession``: within two quanta. Within the
port: reruns, thread and process workers, and a mid-epoch resume give the
same bits. Checkpoints: the reference's manifest and leaves, and restores
across storage dtypes and table layouts in both directions."""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import repro.data.batching as ref_batching
import repro.distributed.vocab_placement as ref_vp
import repro.kernels.ops as ref_ops
import repro.kernels.quant as ref_quant
import repro.kernels.registry as ref_registry
import repro.kernels.tables as ref_tables
from repro.configs.w2v import smoke as ref_smoke
from repro.core.trainer import TrainSession as RefSession
from repro_torch.configs.w2v import smoke
from repro_torch.convert import params_from_reference
from repro_torch.core.trainer import TrainSession
from repro_torch.data import batching
from repro_torch.data.corpus import synthetic_cluster_corpus
from repro_torch.data.prefetch import make_pipeline
from repro_torch.distributed import vocab_placement as vp
from repro_torch.kernels import ops, quant, registry
from repro_torch.kernels import tables as tables_mod
from repro_torch.kernels.tables import Tables
from tests.conftest import REPO, SRC

TOL = dict(atol=2e-5, rtol=1e-4)
NO_INT8 = ("float32", "bfloat16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus():
    return synthetic_cluster_corpus(n_clusters=6, words_per_cluster=12,
                                    n_sentences=200, mean_len=12, seed=0)


def _cfg_kw(tile, tables, **kw):
    return {**dict(dim=16, sentences_per_batch=64, tile_windows=tile,
                   hot_vocab_frac=0.3, tables=tables), **kw}


def _np(t) -> np.ndarray:
    """A storage leaf as numpy: bf16 as its uint16 pattern."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    a = np.asarray(t)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _ordered_bf16(bits: np.ndarray) -> np.ndarray:
    """bf16 patterns as integers ordered like their values (adjacent
    values differ by 1; +0 and -0 are both 0)."""
    b = bits.astype(np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _within_quanta(name: str, got, want, quanta: int, old=None) -> None:
    """``got`` (port) and ``want`` (reference) storage within ``quanta``
    steps of their dtype on every element; f32 leaves within the kernel
    tolerance, int8 scales within rtol 1e-6. With ``old`` (the storage
    before one step) also at least 99% bit-equal among the elements the
    step moved: the f32 stages agree far inside a quantum, so a storage
    difference is a rounding key or a transport that differs."""
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and g.dtype == w.dtype, name
    if g.dtype == np.float32:
        rtol = dict(rtol=1e-6) if name.startswith("scale") else TOL
        np.testing.assert_allclose(g, w, **rtol, err_msg=name)
        return
    if g.dtype == np.uint16:
        diff = np.abs(_ordered_bf16(g) - _ordered_bf16(w))
    else:
        diff = np.abs(g.astype(np.int64) - w.astype(np.int64))
    same = float((diff == 0).mean())
    moved = w != _np(old) if old is not None else np.zeros(w.shape, bool)
    moved_same = float((diff[moved] == 0).mean()) if moved.any() else 1.0
    msg = (f"{name}: {same:.4%} bit-equal, {moved_same:.4%} of the "
           f"{int(moved.sum())} moved elements")
    assert diff.max() <= quanta, (
        f"{int((diff > quanta).sum())} elements beyond {quanta} quanta "
        f"(max {int(diff.max())}); {msg}")
    assert moved_same >= 0.99, msg


@pytest.fixture
def no_int8(monkeypatch):
    """Backends that take f32 and bf16 only, as the CUDA kernels (and the
    reference's Pallas kernels) do: an int8 tail then runs under the f32
    master copy on the CPU too. Registered for the test alone."""
    names = {}
    for reg, base in ((ref_registry, "jnp"), (ref_registry, "jnp_tiled"),
                      (registry, "torch"), (registry, "torch_tiled")):
        reg._ensure_registered()
        be = reg._REGISTRY[base]
        kw = dict(name=f"{base}_no_int8", supports_dtypes=NO_INT8)
        if getattr(be, "tiled_variant", None):
            kw["tiled_variant"] = f"{be.tiled_variant}_no_int8"
        monkeypatch.setitem(reg._REGISTRY, kw["name"],
                            dataclasses.replace(be, **kw))
        names[base] = kw["name"]
    return names


# ---------------------------------------------------------------------------
# One step: the port against the reference
# ---------------------------------------------------------------------------

STEP_CASES = [
    ("hot=bf16", 1), ("hot=bf16", 4),
    ("hot=bf16,cold=bf16,shards=1", 4),
    ("hot=bf16,cold=bf16,shards=1,exchange=dense", 1),
    ("hot=bf16,cold=int8,shards=1", 1),
    ("hot=bf16,cold=int8,shards=1,exchange=dense", 4),
    ("cold=int8,shards=1", 4),
    ("hot=bf16,cold=int8,shards=1,master=1", 4),
    ("cold=bf16,shards=1,exchange=dense,master=1", 1),
]


def _one_step(tables, tile, backends, **cfg_kw):
    """The same first batch, tables and key on both sides; returns the
    reference's and the port's Tables after the mixed step, the f32 stage
    of each (the decoded tables after one f32 step) and the storage
    leaves before the step (numpy)."""
    corpus = _corpus()
    rcfg = ref_smoke(**_cfg_kw(tile, tables, **cfg_kw))
    cfg = smoke(**_cfg_kw(tile, tables, **cfg_kw))
    rpipe = ref_batching.BatchingPipeline(corpus, rcfg)
    pipe = batching.BatchingPipeline(corpus, cfg)
    rspec, spec = ref_tables.from_config(rcfg), tables_mod.from_config(cfg)
    assert rspec.to_extra() == spec.to_extra()
    rng = np.random.default_rng(tile)
    shape = (pipe.table_rows, cfg.dim)
    full = [(rng.normal(size=shape) * 0.05).astype(np.float32)
            for _ in range(2)]
    pad = cfg.resolved_pad_len
    rbatch = next(rpipe.batches(pad_len=pad, epoch=0))
    batch = next(pipe.batches(pad_len=pad, epoch=0))
    key = quant.round_key(cfg.seed, batch.epoch, batch.index)
    lr = 0.05
    mesh = rpl = pl = None
    if spec.vocab_shard:
        rpl = ref_vp.VocabPlacement.plan(rpipe.vocab.counts, 1,
                                         hot_frac=spec.hot_frac)
        pl = vp.VocabPlacement.plan(pipe.vocab.counts, 1,
                                    hot_frac=spec.hot_frac)
        assert rpl.to_extra() == pl.to_extra() and 0 < pl.hot < pl.vocab_size
        mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
        (hi, ci), (ho, co) = (rpl.split(t) for t in full)
        leaves = {}
        for name, arr, dt in (("hot_in", hi, spec.hot_dtype),
                              ("hot_out", ho, spec.hot_dtype),
                              ("cold_in", ci, spec.cold_dtype),
                              ("cold_out", co, spec.cold_dtype)):
            p, s = ref_quant.encode_nearest(jnp.asarray(arr), dt)
            leaves[name] = p
            if s is not None:
                leaves["scale" + name[4:]] = s
        rstep = ref_vp.plan_exchange(rbatch, rpl).step_inputs(lr)
        step = vp.plan_exchange(batch, pl).step_inputs(lr, "cpu")
    else:
        leaves = {n: ref_quant.encode_nearest(jnp.asarray(t),
                                              spec.hot_dtype)[0]
                  for n, t in zip(("w_in", "w_out"), full)}
        rstep = rbatch.step_inputs(lr)
        step = batch.step_inputs(lr, "cpu")

    # numpy copies: the reference's jit donates (deletes) its inputs
    leaves = {k: np.asarray(v) for k, v in leaves.items()}

    def ref_tabs(spec_, lv):
        def get(*names):
            for n in names:
                if n in lv:
                    return jnp.asarray(lv[n])
            return None
        return ref_tables.Tables(
            w_in=get("w_in", "hot_in"), w_out=get("w_out", "hot_out"),
            cold_in=get("cold_in"), cold_out=get("cold_out"),
            scale_in=get("scale_in"), scale_out=get("scale_out"),
            spec=spec_, placement=rpl)

    def port_tabs(spec_, lv):
        st = params_from_reference({k: np.asarray(v) for k, v in lv.items()},
                                   "cpu")
        return Tables(w_in=st.w_in, w_out=st.w_out, cold_in=st.cold_in,
                      cold_out=st.cold_out, scale_in=st.scale_in,
                      scale_out=st.scale_out, spec=spec_, placement=pl)

    # the f32 stage: the decoded tables through one f32 step on both sides
    f32 = dict(hot_dtype="float32", cold_dtype="float32", master_copy=False)
    dec = {}
    for n, v in leaves.items():
        if n.startswith("scale"):
            continue
        sc = leaves.get("scale" + n[4:]) if n.startswith("cold") else None
        dt = spec.cold_dtype if n.startswith("cold") else spec.hot_dtype
        dec[n] = np.asarray(ref_quant.decode(
            jnp.asarray(v), None if sc is None else jnp.asarray(sc), dt
        ).astype(jnp.float32))
    r32 = ref_ops.step(ref_tabs(dataclasses.replace(rspec, **f32), dec),
                       rstep, rcfg, backend=backends[0], mesh=mesh)
    p32 = ops.step(port_tabs(dataclasses.replace(spec, **f32), dec), step,
                   cfg, backend=backends[1])
    rstep = dataclasses.replace(rstep, round_key=jnp.asarray(key))
    step.round_key = key
    r = ref_ops.step(ref_tabs(rspec, leaves), rstep, rcfg,
                     backend=backends[0], mesh=mesh)
    p = ops.step(port_tabs(spec, leaves), step, cfg, backend=backends[1])
    return r, p, r32, p32, leaves


_LEAVES = ("w_in", "w_out", "cold_in", "cold_out", "scale_in", "scale_out")


@pytest.mark.parametrize("tables,tile", STEP_CASES)
def test_one_mixed_step_matches_reference(tables, tile, no_int8):
    spec = tables_mod.parse(tables, hot_frac=0.3)
    seq, til = ("jnp", "torch") if tile == 1 else ("jnp_tiled",
                                                   "torch_tiled")
    backends = ((no_int8[seq], no_int8[til]) if spec.master_copy
                else (seq, til))
    r, p, r32, p32, before = _one_step(tables, tile, backends)
    for name in ("w_in", "w_out", "cold_in", "cold_out"):
        if getattr(r32, name) is not None:
            np.testing.assert_allclose(getattr(p32, name).numpy(),
                                       np.asarray(getattr(r32, name)), **TOL,
                                       err_msg=f"f32 stage {name}")
    moved = 0
    for name in _LEAVES:
        want = getattr(r, name)
        assert (want is None) == (getattr(p, name) is None), name
        if want is not None:
            old = before.get(name, before.get("hot" + name[1:]))
            _within_quanta(name, getattr(p, name), want, 1, old)
            moved += int((_np(getattr(p, name)) != _np(old)).sum())
    assert moved > 0                                      # it trained
    assert p.w_in.dtype == quant.TORCH_DTYPES[spec.hot_dtype]


def test_master_copy_reencodes_every_row_native_keeps_untouched_bytes(
        no_int8):
    """The native int8 path keeps an untouched cold row's exact bytes
    (scale too); the master copy re-encodes every row, as the reference's
    ``run_master`` does (both within one quantum of the reference above)."""
    spec = "hot=bf16,cold=int8,shards=1"
    few = dict(sentences_per_batch=2)        # leaves cold rows untouched
    rn, native, _, _, before = _one_step(spec, 4, ("jnp_tiled",
                                                   "torch_tiled"), **few)
    rm, master, _, _, _ = _one_step(spec + ",master=1", 4,
                                    (no_int8["jnp_tiled"],
                                     no_int8["torch_tiled"]), **few)
    old_q = torch.from_numpy(before["cold_in"].copy())
    old_s = torch.from_numpy(before["scale_in"].copy())
    untouched = (native.cold_in == old_q).all(1)
    assert untouched.any() and not untouched.all()
    assert torch.equal(native.scale_in[untouched], old_s[untouched])
    np.testing.assert_array_equal(np.asarray(rn.cold_in),
                                  native.cold_in.numpy())
    # the master copy re-encodes those rows too: scales stay, payloads
    # within one step (decode → stochastic re-encode is near-fixed)
    assert torch.equal(master.scale_in[untouched], old_s[untouched])
    assert (master.cold_in[untouched].int() - old_q[untouched].int()
            ).abs().max() <= 1
    np.testing.assert_array_equal(np.asarray(rm.cold_in),
                                  master.cold_in.numpy())


def test_mixed_step_without_round_key_raises():
    cfg = smoke(**_cfg_kw(1, "hot=bf16"))
    pipe = batching.BatchingPipeline(_corpus(), cfg)
    batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    v = pipe.table_rows
    tabs = Tables(w_in=torch.zeros(v, 16, dtype=torch.bfloat16),
                  w_out=torch.zeros(v, 16, dtype=torch.bfloat16),
                  spec=tables_mod.from_config(cfg))
    with pytest.raises(ValueError, match="round_key"):
        ops.step(tabs, batch.step_inputs(0.025, "cpu"), cfg)


def test_cuda_backends_take_no_int8_and_name_master():
    with pytest.raises(ValueError, match="master"):
        registry.resolve("cuda_tiled", tiled=True, vocab_shard=True,
                         dtypes=("bfloat16", "int8"), platform="cuda")
    for name in ("cuda", "cuda_pipelined", "cuda_tiled"):
        assert registry.get(name).supports_dtypes == NO_INT8
        assert registry.get(name).supports_dtypes == ref_registry.get(
            name.replace("cuda", "pallas")).supports_dtypes
    for name in ("torch", "torch_tiled"):
        assert registry.get(name).supports_dtypes == quant.STORAGE_DTYPES
    # the master copy asks for no dtype, so the CUDA kernel resolves
    assert registry.resolve("auto", tiled=True, vocab_shard=True,
                            platform="cuda").name == "cuda_tiled"


def test_tables_check_storage_dtypes_and_scales():
    spec = tables_mod.parse("hot=bf16,cold=int8,shards=1")
    pl = vp.VocabPlacement(vocab_size=20, hot=8, n_shards=1)
    kw = dict(w_in=torch.zeros(8, 4, dtype=torch.bfloat16),
              w_out=torch.zeros(8, 4, dtype=torch.bfloat16),
              cold_in=torch.zeros(12, 4, dtype=torch.int8),
              cold_out=torch.zeros(12, 4, dtype=torch.int8),
              scale_in=torch.ones(12), scale_out=torch.ones(12),
              spec=spec, placement=pl)
    Tables(**kw).check_runnable()
    with pytest.raises(ValueError, match="scales"):
        Tables(**{**kw, "scale_in": None, "scale_out": None}
               ).check_runnable()
    with pytest.raises(ValueError, match="w_in is stored as"):
        Tables(**{**kw, "w_in": torch.zeros(8, 4)}).check_runnable()
    # a shard of a 2-shard placement holds its stripe of the tail (and
    # of the scales): cold_per_shard rows, not the whole cold_pad
    two = vp.VocabPlacement(20, 8, 2)
    with pytest.raises(ValueError, match="cold_per_shard=6"):
        Tables(**{**kw, "placement": two}).check_runnable()
    Tables(**{**kw, "placement": two,
              **{k: kw[k][:6] for k in ("cold_in", "cold_out", "scale_in",
                                        "scale_out")}}).check_runnable()


# ---------------------------------------------------------------------------
# Sessions
# ---------------------------------------------------------------------------

SESSION_CASES = [("hot=bf16", 1),
                 ("hot=bf16,cold=int8,shards=1", 4),
                 ("hot=bf16,cold=bf16,shards=1,exchange=dense", 1)]


@pytest.mark.parametrize("tables,tile", SESSION_CASES)
def test_three_batch_mixed_session_matches_reference(tables, tile):
    corpus = _corpus()
    rcfg = ref_smoke(**_cfg_kw(tile, tables))
    ref = RefSession(ref_batching.BatchingPipeline(corpus, rcfg), rcfg,
                     backend="jnp" if tile == 1 else "jnp_tiled")
    cfg = smoke(**_cfg_kw(tile, tables))
    port = TrainSession(batching.BatchingPipeline(corpus, cfg), cfg,
                        device="cpu")
    params = {k: np.asarray(v) for k, v in ref.state.params().items()}
    port.state = params_from_reference(params, "cpu")
    list(ref.stream(max_batches=3))
    list(port.stream(max_batches=3))
    want = ref.state.params()
    got = port.state.params()
    assert got.keys() == want.keys()
    for name in want:
        _within_quanta(name, got[name], want[name], 2)
    assert (_np(got[next(iter(got))]) != params[next(iter(got))].view(
        _np(got[next(iter(got))]).dtype)).any()          # it trained
    np.testing.assert_allclose(port.embeddings(), np.asarray(
        ref.embeddings()), atol=2 * 2.0 ** -8 * 0.05, rtol=2 * 2.0 ** -7)


def _port(tables, tile=4, ckpt_dir=None, workers=0, **kw):
    cfg = smoke(**_cfg_kw(tile, tables, prefetch_workers=workers))
    return TrainSession(make_pipeline(_corpus(), cfg), cfg, device="cpu",
                        ckpt_dir=ckpt_dir, **kw)


def _bits(sess):
    return {k: _np(v).copy() for k, v in sess.state.params().items()}


def _same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("tables", ["hot=bf16",
                                    "hot=bf16,cold=int8,shards=1"])
def test_reruns_and_thread_workers_give_the_same_bits(tables):
    base = _port(tables)
    base.train(max_batches=3)
    for workers in (0, 2):
        again = _port(tables, workers=workers)
        again.train(max_batches=3)
        _same_bits(_bits(again), _bits(base))


def test_mid_epoch_resume_is_bit_exact(tmp_path):
    tables = "hot=bf16,cold=int8,shards=1"
    full = _port(tables)
    full.train(max_batches=3)
    d = str(tmp_path / "ck")
    _port(tables, ckpt_dir=d, ckpt_every=1).train(max_batches=2)
    resumed = _port(tables, ckpt_dir=d)
    assert resumed.resumed_step == 2
    resumed.train(max_batches=1)
    _same_bits(_bits(resumed), _bits(full))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "w2v",
         "--device", "cpu", "--vocab", "128", "--clusters", "8",
         "--sentences", "80", "--sentences-per-batch", "16", "--epochs",
         "1", *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)


def test_cli_mixed_tables_run_on_cpu_and_process_workers_keep_bits():
    """``--tables hot=bf16`` runs from the CLI; two process workers print
    the synchronous run's digest."""
    digests = []
    for extra in ((), ("--prefetch-workers", "2", "--prefetch-mode",
                       "process")):
        out = _cli("--tables", "hot=bf16", "--max-batches", "3", *extra)
        assert out.returncode == 0, out.stderr
        assert "backend=torch " in out.stdout
        digests.append(re.search(r"final_digest=(\w+)", out.stdout)[1])
    assert digests[0] == digests[1]
    out = _cli("--tables", "hot=bf16,cold=int8,shards=1,master=1",
               "--tile-windows", "4", "--max-batches", "2")
    assert out.returncode == 0, out.stderr
    assert "vocab_shard: hot=" in out.stdout and "quality:" in out.stdout


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _manifest(d, step):
    import json
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("tables", ["hot=bf16",
                                    "hot=bf16,cold=int8,shards=1"])
def test_checkpoint_of_converted_state_matches_reference(tmp_path, tables):
    """The reference's state, converted, saved by the port: the same
    manifest (leaves field for field, the tables spec, the placement) and
    the same arrays as the reference's own checkpoint of it."""
    corpus = _corpus()
    rcfg = ref_smoke(**_cfg_kw(4, tables))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = RefSession(ref_batching.BatchingPipeline(corpus, rcfg), rcfg,
                     backend="jnp_tiled", ckpt_dir=ref_dir)
    list(ref.stream(max_batches=1))
    ref.save_checkpoint()
    port = _port(tables, ckpt_dir=port_dir)
    st = params_from_reference({k: np.asarray(v) for k, v in
                                ref.state.params().items()}, "cpu")
    st.words_seen, st.batches_seen = ref.state.words_seen, 1
    st.epoch, st.epoch_batch = ref.state.epoch, ref.state.epoch_batch
    port.state = st
    port.save_checkpoint()
    a, b = _manifest(ref_dir, 1), _manifest(port_dir, 1)
    assert a["leaves"] == b["leaves"]
    assert {**a["extra"], "backend": None} == {**b["extra"], "backend": None}
    with np.load(os.path.join(ref_dir, "step_00000001", "arrays.npz")) as x, \
            np.load(os.path.join(port_dir, "step_00000001",
                                 "arrays.npz")) as y:
        assert x.files == y.files
        for k in x.files:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])


CROSS = [("hot=bf16,cold=int8,shards=1", ""),
         ("", "hot=bf16,cold=int8,shards=1"),
         ("hot=bf16", "hot=bf16,cold=bf16,shards=1"),
         ("hot=bf16,cold=bf16,shards=1", "hot=bf16"),
         ("cold=int8,shards=1", "hot=bf16")]


def _decoded_full(tables, params):
    """The full f32 ``(w_in, w_out)`` a port state of ``tables`` stands
    for (its storage decoded, its split merged)."""
    spec = tables_mod.parse(tables, hot_frac=0.3)
    if "w_in" in params:
        return [quant.decode(params[k], None, spec.hot_dtype).numpy()
                for k in ("w_in", "w_out")]
    cfg = smoke(**_cfg_kw(4, tables))
    pl = vp.VocabPlacement.plan(batching.BatchingPipeline(
        _corpus(), cfg).vocab.counts, 1, hot_frac=spec.hot_frac)
    return [pl.merge(quant.decode(params[f"hot_{s}"], None,
                                  spec.hot_dtype).numpy(),
                     quant.decode(params[f"cold_{s}"],
                                  params.get(f"scale_{s}"),
                                  spec.cold_dtype).numpy())
            for s in ("in", "out")]


@pytest.mark.parametrize("src,dst", CROSS)
def test_restore_across_storage_and_layouts(tmp_path, src, dst):
    """A checkpoint restores into a session of another storage spec or
    table layout: decoded to the full f32 tables through the writer's
    spec and placement, encoded round-to-nearest through the reader's —
    the reference's rule, held bit for bit against the reference's own
    restore of the same checkpoint. The restored session then trains."""
    d = str(tmp_path / "ck")
    writer = _port(src, ckpt_dir=d, ckpt_every=1)
    writer.train(max_batches=2)
    reader = _port(dst, ckpt_dir=d)
    assert reader.resumed_step == 2
    rcfg = ref_smoke(**_cfg_kw(4, dst))
    ref = RefSession(ref_batching.BatchingPipeline(_corpus(), rcfg), rcfg,
                     backend="jnp_tiled", ckpt_dir=d)
    assert ref.resumed_step == 2
    _same_bits(_bits(reader), {k: _np(v) for k, v in
                               ref.state.params().items()})
    # within half a storage quantum of what the writer stored
    want = _decoded_full(src, writer.state.params())
    got = _decoded_full(dst, reader.state.params())
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=np.abs(w).max() / 254 + 1e-9,
                                   rtol=2.0 ** -8)
    reader.train(max_batches=1)
    assert reader.state.batches_seen == 3


def test_reference_mixed_checkpoint_restores_into_the_port(tmp_path):
    """A checkpoint the reference wrote of a mixed split state restores
    into the port's sessions as the reference restores it: same-format
    with its exact bytes, and into a replicated bf16 session through the
    cross-format rule."""
    tables = "hot=bf16,cold=int8,shards=1"
    d = str(tmp_path / "ref")
    rcfg = ref_smoke(**_cfg_kw(4, tables))
    ref = RefSession(ref_batching.BatchingPipeline(_corpus(), rcfg), rcfg,
                     backend="jnp_tiled", ckpt_dir=d, ckpt_every=1)
    list(ref.stream(max_batches=2))
    same = _port(tables, ckpt_dir=d)
    assert same.resumed_step == 2
    _same_bits(_bits(same), {k: _np(v) for k, v in
                             ref.state.params().items()})
    other = _port("hot=bf16", ckpt_dir=d)
    rcfg2 = ref_smoke(**_cfg_kw(4, "hot=bf16"))
    ref2 = RefSession(ref_batching.BatchingPipeline(_corpus(), rcfg2), rcfg2,
                      backend="jnp_tiled", ckpt_dir=d)
    _same_bits(_bits(other), {k: _np(v) for k, v in
                              ref2.state.params().items()})
