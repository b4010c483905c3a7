"""The port's checkpoints (``repro_torch.train.checkpoint``) against the
reference's: the directory states a reader sees (mirrors of
``tests/test_checkpoint_states.py``, the concurrent cases as deterministic
walks through every rename of a publish), crash recovery (the checkpoint
cases of ``tests/test_resilience_recovery.py``), the one on-disk format
(a checkpoint written by either package restores in the other, arrays bit
for bit, manifests equal but for ``extra.backend``), and exact resume: a
port session resumed mid-epoch equals the uninterrupted run bit for bit on
the CPU, and one resumed from a reference checkpoint continues within the
kernel tolerance of the reference's own continuation."""
import json
import os
import shutil
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.w2v import smoke as ref_smoke
from repro.core.trainer import TrainSession as RefSession
from repro.data.batching import BatchingPipeline as RefPipeline
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs.w2v import smoke
from repro_torch.core.trainer import TrainSession
from repro_torch.data.corpus import synthetic_cluster_corpus
from repro_torch.data.prefetch import make_pipeline
from repro_torch.distributed.vocab_placement import VocabPlacement
from repro_torch.train import checkpoint as ckpt

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _save(d, step, mark=None):
    ckpt.save(d, step, {"w": np.full(8, step, dtype=np.float32)},
              extra={"mark": mark if mark is not None else step})


def _backdate(path, by_s=2 * ckpt.STALE_GRACE_S):
    t = time.time() - by_s
    os.utime(path, (t, t))


def _save_two(d, step_a=2, step_b=4):
    tree = {"w": np.arange(8, dtype=np.float32)}
    ckpt.save(d, step_a, tree, extra={"mark": step_a})
    tree2 = {"w": np.arange(8, dtype=np.float32) * 2}
    ckpt.save(d, step_b, tree2, extra={"mark": step_b})
    return tree, tree2


LIKE = {"w": np.zeros(8, dtype=np.float32)}


# -- what maintenance-state dirs look like to the read API --------------------
def test_list_steps_ignores_maintenance_dirs(tmp_path):
    d = str(tmp_path)
    _save(d, 2)
    _save(d, 4)
    os.makedirs(os.path.join(d, "step_00000006.tmp.abc"))      # in flight
    os.makedirs(os.path.join(d, "step_00000008.corrupt"))      # quarantined
    os.rename(os.path.join(d, "step_00000002"),
              os.path.join(d, "step_00000002.old.xyz"))        # displaced
    os.makedirs(os.path.join(d, "step_00000010"))              # no manifest
    assert ckpt.list_steps(d) == [4]


def test_latest_step_on_missing_and_empty_dir(tmp_path):
    assert ckpt.latest_step(str(tmp_path / "nope")) is None
    assert ckpt.latest_step(str(tmp_path)) is None


def test_latest_step_with_only_inflight_tmp(tmp_path):
    d = str(tmp_path)
    inflight = os.path.join(d, "step_00000002.tmp.abc")
    os.makedirs(inflight)
    assert ckpt.latest_step(d) is None
    assert os.path.isdir(inflight)


def test_peek_skips_newer_inflight_publish(tmp_path):
    d = str(tmp_path)
    _save(d, 2)
    os.makedirs(os.path.join(d, "step_00000004.tmp.abc"))
    leaves, extra = ckpt.peek(d)
    assert extra["mark"] == 2
    assert leaves["w"]["shape"] == (8,)


def test_latest_step_quarantines_partial_missing_arrays(tmp_path):
    d = str(tmp_path)
    _save(d, 2)
    _save(d, 4)
    os.remove(os.path.join(d, "step_00000004", "arrays.npz"))
    assert ckpt.latest_step(d) == 2
    assert any(n.startswith("step_00000004.corrupt") for n in os.listdir(d))
    assert ckpt.list_steps(d) == [2]
    assert ckpt.latest_step(d) == 2


def test_latest_step_quarantines_unparseable_manifest(tmp_path):
    d = str(tmp_path)
    _save(d, 2)
    _save(d, 4)
    with open(os.path.join(d, "step_00000004", "manifest.json"), "w") as f:
        f.write("{truncated")
    assert ckpt.latest_step(d) == 2
    assert any(".corrupt" in n for n in os.listdir(d))


def test_latest_step_all_steps_partial_returns_none(tmp_path):
    d = str(tmp_path)
    _save(d, 2)
    os.remove(os.path.join(d, "step_00000002", "arrays.npz"))
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.peek(d)


def test_peek_reports_split_table_layout(tmp_path):
    d = str(tmp_path)
    pl = VocabPlacement(vocab_size=32, hot=8, n_shards=2)
    hot = torch.zeros((8, 4))
    cold = torch.zeros((pl.cold_pad, 4))
    ckpt.save(d, 6, {"hot_in": hot, "cold_in": cold,
                     "hot_out": hot, "cold_out": cold},
              extra={"vocab_shard": pl.to_extra()})
    os.remove(os.path.join(d, "step_00000006", "arrays.npz"))
    leaves, extra = ckpt.peek(d, step=6)
    assert set(leaves) == {"hot_in", "cold_in", "hot_out", "cold_out"}
    assert leaves["cold_in"]["shape"] == (pl.cold_pad, 4)
    assert VocabPlacement.from_extra(extra["vocab_shard"]) == pl


def test_stale_maintenance_dirs_cleaned_after_grace(tmp_path):
    d = str(tmp_path)
    _save(d, 2)
    old_tmp = os.path.join(d, "step_00000004.tmp.dead")
    fresh_tmp = os.path.join(d, "step_00000006.tmp.live")
    os.makedirs(old_tmp)
    os.makedirs(fresh_tmp)
    _backdate(old_tmp)
    assert ckpt.latest_step(d) == 2
    assert not os.path.exists(old_tmp)
    assert os.path.isdir(fresh_tmp)


# -- a reader at every rename of a publish (deterministic) --------------------
def _walk_publish(monkeypatch, d, publish, probe):
    """Run ``publish()`` with ``probe()`` called before and after every
    ``os.rename`` it makes: the reader observes each intermediate
    directory state of the publish, in order, with no thread timing."""
    real = os.rename
    inside = []

    def rename(src, dst):
        if inside:                      # the probe's own renames
            return real(src, dst)
        inside.append(1)
        try:
            probe()
            real(src, dst)
            probe()
        finally:
            inside.pop()

    monkeypatch.setattr(ckpt.os, "rename", rename)
    publish()
    monkeypatch.setattr(ckpt.os, "rename", real)


def test_reader_at_every_rename_of_new_step_publishes(tmp_path, monkeypatch):
    """Publishing steps 1..6 (keep=3) while a reader calls latest_step,
    peek and restore between every two renames: the newest step never
    goes back, every step it names is readable, nothing is quarantined."""
    d = str(tmp_path)
    seen = []

    def probe():
        step = ckpt.latest_step(d)
        if step is None:
            return
        assert not seen or step >= seen[-1]
        seen.append(step)
        _, extra = ckpt.peek(d, step=step)
        assert extra["mark"] == step
        got, _ = ckpt.restore(d, LIKE, step=step)
        assert (got["w"] == step).all()

    for s in range(1, 7):
        _walk_publish(monkeypatch, d, lambda: _save(d, s), probe)
    assert seen[-1] == 6 and ckpt.list_steps(d) == [4, 5, 6]
    assert not [n for n in os.listdir(d) if ".corrupt" in n
                or ".old." in n or ".tmp" in n]


def test_reader_at_every_rename_of_same_step_resaves(tmp_path, monkeypatch):
    """Same-step re-saves (the supervisor's rollback-then-recheckpoint
    path) displace the old directory by rename: between the two renames
    the step is briefly gone (latest_step None, peek corrupt), the
    displaced directory is young and left alone, and every visible
    version is whole; the last save wins."""
    d = str(tmp_path)
    _save(d, 4, mark=0)
    states = []

    def probe():
        step = ckpt.latest_step(d)
        assert step in (None, 4)
        if step is None:
            with pytest.raises(ckpt.CorruptCheckpoint):
                ckpt.peek(d, step=4)
            assert [n for n in os.listdir(d) if ".old." in n]
            states.append("gone")
            return
        _, extra = ckpt.peek(d, step=4)
        got, _ = ckpt.restore(d, LIKE, step=4)
        assert (got["w"] == 4).all() and 0 <= extra["mark"] <= 5
        states.append(extra["mark"])

    for i in range(1, 6):
        _walk_publish(monkeypatch, d, lambda: _save(d, 4, mark=i), probe)
    assert "gone" in states
    _, extra = ckpt.peek(d, step=4)
    assert extra["mark"] == 5
    assert not [n for n in os.listdir(d) if ".corrupt" in n or ".old." in n]


def test_republish_between_check_and_quarantine_survives(tmp_path,
                                                         monkeypatch):
    """A same-step re-save's two renames (displace the old directory,
    rename the new one into place) landed at every pair of points inside
    one ``latest_step``: before it lists the steps, before its first and
    second reads of the directory, before a quarantine, after it returns.
    No republished directory is ever quarantined, what ``latest_step``
    names is the old or the new checkpoint, whole, and where the republish
    lands between the first read and the quarantine the reader returns the
    new one."""
    points = ("list", "read", "reread", "quarantine", "end")
    real_state, real_quarantine = ckpt._dir_state, ckpt.quarantine
    for i in range(len(points)):
        for j in range(i, len(points)):
            d = str(tmp_path / f"walk_{i}_{j}")
            _save(d, 4, mark=0)
            final = os.path.join(d, "step_00000004")
            _save(d + ".new", 4, mark=1)
            tmp = final + ".tmp.walk"
            shutil.copytree(os.path.join(d + ".new", "step_00000004"), tmp)
            # the writer's renames, each with the point it lands at; one
            # whose point the reader never reaches lands at the next one
            pending = [(i, final, final + ".old.walk"), (j, tmp, final)]
            reached = []

            def hook(point, pending=pending, reached=reached):
                reached.append(point)
                while pending and pending[0][0] <= points.index(point):
                    os.rename(*pending.pop(0)[1:])

            def state(path, hook=hook):
                hook("read" if "read" not in reached else "reread")
                return real_state(path)

            def quarantine(ckpt_dir, step, hook=hook):
                hook("quarantine")
                return real_quarantine(ckpt_dir, step)

            monkeypatch.setattr(ckpt, "_dir_state", state)
            monkeypatch.setattr(ckpt, "quarantine", quarantine)
            hook("list")
            got = ckpt.latest_step(d)
            monkeypatch.setattr(ckpt, "_dir_state", real_state)
            monkeypatch.setattr(ckpt, "quarantine", real_quarantine)
            hook("end")
            case = (points[i], points[j])
            assert not [n for n in os.listdir(d) if ".corrupt" in n], case
            assert got in (None, 4), case
            if case in (("read", "reread"), ("read", "quarantine")):
                # the name was gone at the first read: a republish that
                # lands before the second read is returned, a later one
                # is left alone
                assert got == (4 if points[j] == "reread" else None), case
            _, extra = ckpt.peek(d, step=4)
            assert extra["mark"] == 1, case
            assert ckpt.latest_step(d) == 4, case


# -- crash recovery ----------------------------------------------------------
def test_truncated_arrays_falls_back_and_quarantines(tmp_path):
    d = str(tmp_path / "ck")
    tree, _ = _save_two(d)
    path = os.path.join(d, "step_00000004", "arrays.npz")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    got, extra = ckpt.restore(d, LIKE, step=None)
    assert extra["mark"] == 2
    np.testing.assert_array_equal(got["w"], tree["w"])
    assert any(".corrupt" in n for n in os.listdir(d))
    assert ckpt.latest_step(d) == 2


def test_explicit_step_restore_of_corrupt_raises_after_quarantine(tmp_path):
    d = str(tmp_path / "ck")
    _save_two(d)
    path = os.path.join(d, "step_00000004", "arrays.npz")
    with open(path, "r+b") as f:
        f.truncate(10)
    with pytest.raises(ckpt.CorruptCheckpoint):
        ckpt.restore(d, LIKE, step=4)
    assert any(n.startswith("step_00000004.corrupt") for n in os.listdir(d))


def test_partial_dir_latest_step_quarantines(tmp_path):
    d = str(tmp_path / "ck")
    _save_two(d)
    os.remove(os.path.join(d, "step_00000004", "arrays.npz"))
    assert ckpt.latest_step(d) == 2
    assert any(".corrupt" in n for n in os.listdir(d))


def test_clean_stale_recovers_displaced_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    _save_two(d)
    final = os.path.join(d, "step_00000004")
    os.rename(final, final + ".old.deadbeef")
    _backdate(final + ".old.deadbeef")
    assert ckpt.latest_step(d) == 4
    _, extra = ckpt.restore(d, LIKE, step=4)
    assert extra["mark"] == 4


def test_fresh_displaced_dir_left_for_live_publisher(tmp_path):
    d = str(tmp_path / "ck")
    _save_two(d)
    final = os.path.join(d, "step_00000004")
    os.rename(final, final + ".old.deadbeef")
    assert ckpt.latest_step(d) == 2
    assert os.path.isdir(final + ".old.deadbeef")


def test_stale_tmp_dirs_cleaned_on_save(tmp_path):
    d = str(tmp_path / "ck")
    _save_two(d)
    stale = os.path.join(d, "step_00000006.tmp.abc123")
    os.makedirs(stale)
    _backdate(stale)
    ckpt.save(d, 8, {"w": np.zeros(3, dtype=np.float32)})
    assert not os.path.exists(stale)
    assert not [n for n in os.listdir(d) if ".tmp" in n]


def test_fresh_tmp_dir_survives_concurrent_reader(tmp_path):
    d = str(tmp_path / "ck")
    _save_two(d)
    inflight = os.path.join(d, "step_00000006.tmp.abc123")
    os.makedirs(inflight)
    assert ckpt.latest_step(d) == 4
    assert os.path.isdir(inflight)


def test_checksum_corruption_detected(tmp_path):
    d = str(tmp_path / "ck")
    _save_two(d)
    man_path = os.path.join(d, "step_00000004", "manifest.json")
    with open(man_path) as f:
        man = json.load(f)
    man["leaves"][0]["sha1"] = "0" * 40
    with open(man_path, "w") as f:
        json.dump(man, f)
    _, extra = ckpt.restore(d, LIKE, step=None)
    assert extra["mark"] == 2


def test_restore_onto_device_gives_new_tensors(tmp_path):
    d = str(tmp_path)
    tree, _ = _save_two(d)
    got, _ = ckpt.restore(d, {"w": torch.zeros(8)}, step=2, device="cpu")
    assert isinstance(got["w"], torch.Tensor)
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, {"w": torch.zeros(9)}, step=2)
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore(d, {"v": torch.zeros(8)}, step=2)


def test_pipeline_cursor_roundtrip():
    c = ckpt.PipelineCursor(epoch=2, epoch_batch=7, prefetch_workers=4)
    back = ckpt.PipelineCursor.from_extra({"words_seen": 1, **c.to_extra()})
    assert back == c
    assert ckpt.PipelineCursor.from_extra({}) == ckpt.PipelineCursor()
    assert c.to_extra() == ref_ckpt.PipelineCursor(2, 7, 4).to_extra()


# -- one format, two packages -------------------------------------------------
def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _arrays(d, step):
    with np.load(os.path.join(d, f"step_{step:08d}", "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("layout", ["replicated", "split"])
def test_format_is_shared_both_ways(tmp_path, layout):
    """The same tables and extra saved by both packages: manifests equal
    field for field (paths, keys a0.., shapes, dtypes, sha1s), arrays bit
    for bit, and each package restores the other's checkpoint."""
    rng = np.random.default_rng(0)
    names = (["w_in", "w_out"] if layout == "replicated"
             else ["hot_out", "cold_in", "hot_in", "cold_out"])
    tables = {k: rng.normal(size=(5 + i, 4)).astype(np.float32)
              for i, k in enumerate(names)}
    extra = {"words_seen": 7, "batches_seen": 3, "epoch": 0,
             "epoch_batch": 3}
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 3, {k: jnp.asarray(v) for k, v in tables.items()},
                  extra=extra)
    ckpt.save(port_dir, 3, {k: torch.from_numpy(v) for k, v in
                            tables.items()}, extra=extra)
    assert _manifest(ref_dir, 3) == _manifest(port_dir, 3)
    if layout == "split":       # sorted key order, as jax flattens dicts
        assert [l["path"] for l in _manifest(port_dir, 3)["leaves"]] == [
            "cold_in", "cold_out", "hot_in", "hot_out"]
    a, b = _arrays(ref_dir, 3), _arrays(port_dir, 3)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    like = {k: torch.zeros(v.shape) for k, v in tables.items()}
    got, got_extra = ckpt.restore(ref_dir, like, device="cpu")
    assert got_extra == extra
    import jax
    back, _ = ref_ckpt.restore(
        port_dir, {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
                   for k, v in tables.items()})
    for k, v in tables.items():
        assert np.array_equal(got[k].numpy(), v)
        assert np.array_equal(np.asarray(back[k]), v)


def test_bfloat16_leaves_cross_both_ways(tmp_path):
    """bfloat16 leaves are stored as uint16 bytes with ``bfloat16`` in the
    manifest by both packages, and read back through torch here (numpy
    has no bfloat16 without ml_dtypes)."""
    vals = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 1, {"t": jnp.asarray(vals, jnp.bfloat16)})
    ckpt.save(port_dir, 1, {"t": torch.from_numpy(vals).bfloat16()})
    assert _manifest(ref_dir, 1) == _manifest(port_dir, 1)
    got, _ = ckpt.restore(ref_dir, {"t": torch.zeros(3, 4,
                                                     dtype=torch.bfloat16)})
    assert torch.equal(got["t"], torch.from_numpy(vals).bfloat16())
    import jax
    back, _ = ref_ckpt.restore(
        port_dir, {"t": jax.ShapeDtypeStruct((3, 4), jnp.bfloat16)})
    np.testing.assert_array_equal(np.asarray(back["t"], np.float32),
                                  torch.from_numpy(vals).bfloat16()
                                  .float().numpy())


# -- sessions ----------------------------------------------------------------
def _corpus():
    return synthetic_cluster_corpus(n_clusters=4, words_per_cluster=8,
                                    n_sentences=300, mean_len=10, seed=0)


CASES = {"T1": dict(), "T4": dict(tile_windows=4),
         "shard": dict(tile_windows=4, vocab_shard=True, hot_vocab_frac=0.3)}


def _cfg_kw(case, **kw):
    return dict(epochs=2, dim=16, sentences_per_batch=64,
                max_sentence_len=24, **CASES[case], **kw)


def _port(case, ckpt_dir=None, workers=0, **kw):
    cfg = smoke(**_cfg_kw(case, prefetch_workers=workers))
    return TrainSession(make_pipeline(_corpus(), cfg), cfg, device="cpu",
                        ckpt_dir=ckpt_dir, **kw)


def _params(sess):
    return {k: v.numpy() for k, v in sess.state.params().items()}


def _same_tables(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("case", list(CASES))
def test_resume_mid_epoch_is_bit_exact(tmp_path, case):
    """Three batches with two thread workers and a checkpoint each batch,
    then a new session on the synchronous pipeline resumes at batch 3 and
    trains the rest: the tables equal the uninterrupted run's bit for
    bit."""
    full = _port(case)
    full.train()
    d = str(tmp_path / "ck")
    _port(case, d, workers=2, ckpt_every=1).train(max_batches=3)
    resumed = _port(case, d)
    assert resumed.resumed_step == 3 and resumed._resume_skip == 3
    resumed.train()
    assert resumed.state.batches_seen == full.state.batches_seen
    assert resumed.state.words_seen == full.state.words_seen
    _same_tables(_params(resumed), _params(full))


@pytest.mark.parametrize("src,dst", [("shard", "T4"), ("T4", "shard")])
def test_restore_across_table_layouts(tmp_path, src, dst):
    """A vocab-sharded checkpoint restores into a replicated session
    (merged through its recorded placement) and the reverse; one shard
    trains the replicated tables' bits, so the continuation equals the
    uninterrupted run of the restoring layout bit for bit."""
    full = _port(dst)
    full.train()
    d = str(tmp_path / "ck")
    _port(src, d, ckpt_every=1).train(max_batches=3)
    resumed = _port(dst, d)
    assert resumed.resumed_step == 3
    resumed.train()
    _same_tables(_params(resumed), _params(full))


@pytest.mark.parametrize("case", ["T1", "shard"])
def test_session_checkpoints_cross_packages(tmp_path, case):
    """A reference session's checkpoint resumes a port session with the
    same tables and counters; the port's re-save of that state has the
    reference's manifest but for ``extra.backend``; the reference resumes
    from the port's checkpoint with the same tables."""
    rcfg = ref_smoke(**_cfg_kw(case))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = RefSession(RefPipeline(_corpus(), rcfg), rcfg, backend="jnp",
                     ckpt_dir=ref_dir, ckpt_every=1)
    ref.train(max_batches=2)
    want = {k: np.asarray(v) for k, v in ref.state.params().items()}
    port = _port(case, ref_dir)
    assert port.resumed_step == 2
    assert (port.state.words_seen, port.state.epoch_batch) == (
        ref.state.words_seen, ref.state.epoch_batch)
    _same_tables(_params(port), want)
    port.ckpt_dir = port_dir
    port.save_checkpoint()
    m_ref, m_port = _manifest(ref_dir, 2), _manifest(port_dir, 2)
    assert m_ref["extra"].pop("backend") == ref.backend
    assert m_port["extra"].pop("backend") == port.backend
    assert m_ref == m_port
    back = RefSession(RefPipeline(_corpus(), rcfg), rcfg, backend="jnp",
                      ckpt_dir=port_dir)
    assert back.resumed_step == 2
    _same_tables({k: np.asarray(v) for k, v in back.state.params().items()},
                 want)


def test_continuation_from_reference_checkpoint_matches_reference(tmp_path):
    """A port session resumed from a reference checkpoint continues within
    the kernel tolerance of the reference session's own continuation."""
    rcfg = ref_smoke(**_cfg_kw("T1"))
    d = str(tmp_path / "ref")
    RefSession(RefPipeline(_corpus(), rcfg), rcfg, backend="jnp",
               ckpt_dir=d, ckpt_every=1).train(max_batches=2)
    shutil.copytree(d, str(tmp_path / "copy"))
    ref = RefSession(RefPipeline(_corpus(), rcfg), rcfg, backend="jnp",
                     ckpt_dir=str(tmp_path / "copy"))
    port = _port("T1", d)
    assert ref.resumed_step == port.resumed_step == 2
    ref.train(max_batches=3)
    port.train(max_batches=3)
    assert port.state.words_seen == ref.state.words_seen
    for k, v in ref.state.params().items():
        got = port.state.params()[k].numpy()
        np.testing.assert_allclose(got, np.asarray(v), **TOL)


def test_mixed_precision_checkpoint_raises_later_slice(tmp_path):
    """A checkpoint of bf16 tables no longer waits for a later slice: the
    mixed-precision slice restores the reference's into a bf16 session
    with its exact bytes and into an f32 session decoded (reading bf16
    through torch, never ml_dtypes); a ``shards=2`` spec without a mesh
    of two ranks raises."""
    rcfg = ref_smoke(**_cfg_kw("T1", tables="hot=bf16"))
    d = str(tmp_path / "ref")
    ref = RefSession(RefPipeline(_corpus(), rcfg), rcfg, backend="jnp",
                     ckpt_dir=d, ckpt_every=1)
    ref.train(max_batches=1)
    want = np.asarray(ref.state.w_in).view(np.uint16)

    def session(tables=""):
        cfg = smoke(**_cfg_kw("T1", tables=tables))
        return TrainSession(make_pipeline(_corpus(), cfg), cfg,
                            device="cpu", ckpt_dir=d)

    mixed = session("hot=bf16")
    assert mixed.resumed_step == 1
    assert mixed.state.w_in.dtype == torch.bfloat16
    assert np.array_equal(mixed.state.w_in.view(torch.int16).numpy()
                          .view(np.uint16), want)
    f32 = session()
    assert f32.state.w_in.dtype == torch.float32
    assert torch.equal(f32.state.w_in, mixed.state.w_in.float())
    with pytest.raises(ValueError, match="shards=2 .* 1 rank"):
        session("hot=bf16,shards=2")
