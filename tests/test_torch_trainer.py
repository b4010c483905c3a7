"""The port's training session against the reference's: three batches from
the same tables (``params_from_reference``) agree within the kernel
tolerance at T=1 and at T=8; the session refuses to fall back to the CPU
silently; the CLI runs end to end on the CPU, prints the same digest with
prefetch workers as without, and resumes from its checkpoints."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs.w2v import smoke as ref_smoke
from repro.core.trainer import TrainSession as RefSession
from repro.data.batching import BatchingPipeline as RefPipeline
from repro_torch.configs.w2v import smoke
from repro_torch.convert import params_from_reference
from repro_torch.core.trainer import TrainSession
from repro_torch.data.batching import BatchingPipeline
from repro_torch.data.corpus import synthetic_cluster_corpus
from tests.conftest import REPO, SRC

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores and these small-tensor
    tests slow tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_kw(tile):
    return dict(dim=64, window=5, negatives=5, sentences_per_batch=12,
                max_sentence_len=24, tile_windows=tile, tile_gemm_windows=4,
                epochs=1, seed=2)


def _corpus():
    return synthetic_cluster_corpus(n_clusters=4, words_per_cluster=24,
                                    n_sentences=60, mean_len=12, seed=3)


@pytest.mark.parametrize("tile,ref_backend", [(1, "jnp"), (8, "jnp_tiled")])
def test_three_batches_match_reference_session(tile, ref_backend):
    corpus = _corpus()
    ref = RefSession(RefPipeline(corpus, ref_smoke(**_cfg_kw(tile))),
                     ref_smoke(**_cfg_kw(tile)), backend=ref_backend)
    cfg = smoke(**_cfg_kw(tile))
    port = TrainSession(BatchingPipeline(corpus, cfg), cfg, device="cpu")
    assert port.backend == ("torch" if tile == 1 else "torch_tiled")
    params = {k: np.asarray(v) for k, v in ref.state.params().items()}
    port.state = params_from_reference(params, "cpu")

    ref_m = list(ref.stream(max_batches=3))
    port_m = list(port.stream(max_batches=3))
    assert [m.words_seen for m in port_m] == [m.words_seen for m in ref_m]
    assert [m.lr for m in port_m] == [m.lr for m in ref_m]
    for name in ("w_in", "w_out"):
        want = np.asarray(ref.state.params()[name])
        got = port.state.params()[name].numpy()
        np.testing.assert_allclose(got, want, **TOL)
        assert np.abs(got - params[name]).max() > 1e-4     # it trained
    np.testing.assert_allclose(port.embeddings(), np.asarray(ref.state.w_in),
                               **TOL)


def test_session_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke()
    pipe = BatchingPipeline(_corpus(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TrainSession(pipe, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainSession(pipe, cfg, device="cuda")


def test_cuda_backend_on_cpu_session_raises():
    cfg = smoke()
    with pytest.raises(ValueError, match="only on the GPU"):
        TrainSession(BatchingPipeline(_corpus(), cfg), cfg, backend="cuda",
                     device="cpu")


@pytest.mark.parametrize("kw,err,match", [
    (dict(mesh=object()), TypeError, "DataMesh"),
    (dict(cfg_tables="shards=2"), ValueError, "shards=2 .* 1 rank"),
    (dict(cfg_tables="hot=bf16,shards=2"), ValueError, "shards=2 .* 1 rank"),
    (dict(cfg_tables="cold=int8,shards=2"), ValueError,
     "shards=2 .* 1 rank")])
def test_later_slice_features_raise(kw, err, match):
    """Meshes and more than one shard run since the data-parallel slice:
    a mesh that is not a ``DataMesh`` raises a TypeError, and a
    ``shards=N`` spec without a mesh of N ranks a ValueError naming
    both counts."""
    cfg = smoke(tables=kw.pop("cfg_tables", ""))
    with pytest.raises(err, match=match):
        TrainSession(BatchingPipeline(_corpus(), cfg), cfg, device="cpu",
                     **kw)


def test_params_from_reference_validates():
    good = {"w_in": np.zeros((4, 8), np.float32),
            "w_out": np.ones((4, 8), np.float32)}
    st = params_from_reference(good, "cpu")
    assert st.w_out.dtype == torch.float32 and st.w_out.sum() == 32
    with pytest.raises(ValueError, match="w_out"):
        params_from_reference({"w_in": good["w_in"]}, "cpu")
    with pytest.raises(ValueError, match="float32"):
        params_from_reference({**good, "w_in": good["w_in"].astype(
            np.float64)}, "cpu")


def _cli(*args):
    # one OpenMP thread: beside the other test workers, the default thread
    # count oversubscribes the cores and the run slows 20x or more
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "w2v", *args],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("tile", ["1", "8"])
def test_cli_runs_on_cpu(tile):
    out = _cli("--device", "cpu", "--vocab", "128", "--clusters", "8",
               "--sentences", "80", "--sentences-per-batch", "16",
               "--max-batches", "3", "--epochs", "1", "--tile-windows", tile)
    assert out.returncode == 0, out.stderr
    want = "backend=torch " if tile == "1" else "backend=torch_tiled "
    assert want in out.stdout
    for key in ("throughput:", "final_digest=", "quality:"):
        assert key in out.stdout, out.stdout


def test_cli_rejects_later_slice_flags():
    """``--workload doc2vec`` runs since the frontends slice (each
    workload's CLI runs are in test_torch_frontends.py); a workload that
    no frontend registers is still rejected, by the parser."""
    out = _cli("--device", "cpu", "--workload", "doc2vec", "--docs", "8",
               "--sentences-per-batch", "16", "--max-batches", "1",
               "--epochs", "1")
    assert out.returncode == 0, out.stderr
    assert "workload=doc2vec vocab=" in out.stdout, out.stdout
    assert "(+8 doc2vec rows)" in out.stdout, out.stdout
    out = _cli("--device", "cpu", "--workload", "graphsage")
    assert out.returncode == 2 and "invalid choice" in out.stderr


_SMALL = ("--device", "cpu", "--vocab", "128", "--clusters", "8",
          "--sentences", "80", "--sentences-per-batch", "16", "--epochs",
          "1")


def _digest(out):
    assert out.returncode == 0, out.stderr
    return out.stdout.split("final_digest=")[1].split()[0]


def test_cli_prefetch_workers_keep_the_digest():
    sync = _cli(*_SMALL, "--max-batches", "4")
    assert "pipeline=sync" in sync.stdout
    pref = _cli(*_SMALL, "--max-batches", "4", "--prefetch-workers", "2")
    assert "pipeline=async(workers=2 depth=2 mode=thread)" in pref.stdout
    assert _digest(pref) == _digest(sync)


def test_cli_checkpoint_run_resumes(tmp_path):
    """A --ckpt-dir run stopped after 2 batches, run again, resumes at
    batch 2 and ends with the uninterrupted run's digest."""
    full = _cli(*_SMALL)
    d = str(tmp_path / "ck")
    first = _cli(*_SMALL, "--max-batches", "2", "--ckpt-dir", d,
                 "--ckpt-every", "1")
    assert "checkpoint:" in first.stdout and _digest(first) != _digest(full)
    again = _cli(*_SMALL, "--ckpt-dir", d, "--ckpt-every", "1",
                 "--health-every", "1")
    assert "resumed from checkpoint batch 2" in again.stdout, again.stdout
    assert "resilience: restarts=0" in again.stdout
    assert _digest(again) == _digest(full)
