"""Hogwild data parallelism in the port (``TrainSession(mesh=...)`` over
gloo ranks on the CPU) against the reference's N-device sessions
(``TrainSession(mesh=make_host_mesh(model=1))`` on fake host devices),
from the same tables (``params_from_reference``) on the same batches:

* 2 and 4 ranks, T=1 and T=4, 3 batches: f32 within atol 2e-5 / rtol
  1e-4, a bf16 head within two storage quanta;
* the replicas equal across ranks after the run;
* at N=2 one batch bit-identical to the mean of the per-block updates of
  one process (the Hogwild semantics, in any summation order at N=2);
* a T=1 tile plan under the mesh bit-identical to the sequential path;
* the 4-rank quality run at the reference's thresholds.

Both sides run in subprocesses (jax fixes its device count at start, and
spawned ranks import their function from a script's ``__main__``) and
exchange ``.npz`` files; bf16 leaves travel as their uint16 patterns."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.conftest import SRC, run_subprocess

TOL = dict(atol=2e-5, rtol=1e-4)

CASES = {"T1": dict(tile_windows=1), "T4": dict(tile_windows=4),
         "T1_bf16": dict(tile_windows=1, tables="hot=bf16"),
         "T4_bf16": dict(tile_windows=4, tables="hot=bf16")}

# shared by both sides: the corpus, the config, npz leaves
COMMON = textwrap.dedent('''
    import json
    import sys

    import numpy as np


    def corpus_kw():
        return dict(n_clusters=6, words_per_cluster=12, n_sentences=200,
                    mean_len=12, seed=0)


    def cfg_kw(case_kw):
        return dict(dim=16, sentences_per_batch=64, **case_kw)


    def leaves(params, prefix):
        """Storage leaves as numpy; bf16 as its uint16 pattern."""
        out = {}
        for k, v in params.items():
            bf16 = "bfloat16" in str(v.dtype)
            if hasattr(v, "detach"):                    # a torch tensor
                import torch
                v = v.detach().cpu()
                # a copy: the tensor trains on in place
                a = (v.view(torch.int16) if bf16 else v).numpy().copy()
            else:
                a = np.asarray(v)
            if bf16:
                out[prefix + k + "@bf16"] = a.view(np.uint16)
            else:
                out[prefix + k] = a
        return out


    def from_leaves(z, prefix):
        """The reference-format tree under ``prefix`` (bf16 via
        ml_dtypes, as the reference's own numpy leaves are)."""
        import ml_dtypes
        out = {}
        for k in z.files:
            if not k.startswith(prefix):
                continue
            leaf, a = k[len(prefix):], z[k]
            if leaf.endswith("@bf16"):
                leaf, a = leaf[:-5], a.view(ml_dtypes.bfloat16)
            out[leaf] = a
        return out
''')

REF = COMMON + textwrap.dedent('''
    def main(path, cases):
        from repro.configs.w2v import smoke
        from repro.core.trainer import TrainSession
        from repro.data.batching import BatchingPipeline
        from repro.data.corpus import synthetic_cluster_corpus
        from repro.launch.mesh import make_host_mesh

        corpus = synthetic_cluster_corpus(**corpus_kw())
        mesh = make_host_mesh(model=1)
        out = {}
        for name, kw in cases.items():
            cfg = smoke(**cfg_kw(kw))
            s = TrainSession(BatchingPipeline(corpus, cfg), cfg,
                             backend="jnp", mesh=mesh)
            out.update(leaves(s.state.params(), name + "|init|"))
            s.train(max_batches=3)
            out.update(leaves(s.state.params(), name + "|final|"))
        np.savez(path, **out)
''')

PORT = COMMON + textwrap.dedent('''
    import hashlib


    def digest(params):
        import torch
        h = hashlib.sha256()
        for v in params.values():
            v = v.detach().contiguous()
            if v.dtype == torch.bfloat16:
                v = v.view(torch.int16)
            h.update(v.numpy().tobytes())
        return h.hexdigest()


    def ranks_agree(mesh, value):
        import torch.distributed as dist
        every = [None] * mesh.size
        dist.all_gather_object(every, value)
        return len(set(every)) == 1


    def session(mesh, kw, z=None, prefix=None, **sess_kw):
        from repro_torch.configs.w2v import smoke
        from repro_torch.convert import params_from_reference
        from repro_torch.core.trainer import TrainSession
        from repro_torch.data.batching import BatchingPipeline
        from repro_torch.data.corpus import synthetic_cluster_corpus
        cfg = smoke(**cfg_kw(kw))
        s = TrainSession(BatchingPipeline(
            synthetic_cluster_corpus(**corpus_kw()), cfg), cfg,
            device="cpu", mesh=mesh, **sess_kw)
        if z is not None:
            s.state = params_from_reference(from_leaves(z, prefix), "cpu",
                                            mesh)
        return s


    def emulate(mesh, kw, z, prefix):
        """One batch under the mesh against the mean of the per-block
        single-process updates from the same tables."""
        import torch
        from repro_torch.kernels import ops
        from repro_torch.kernels.tables import Tables
        from repro_torch.launch.mesh import DataMesh
        s = session(mesh, kw, z, prefix)
        batch = next(s.pipeline.batches(pad_len=s.cfg.resolved_pad_len,
                                        epoch=0))
        parts = []
        for r in range(mesh.size):
            t = Tables(w_in=s.state.w_in.clone(), w_out=s.state.w_out.clone())
            block = DataMesh(rank=r, size=mesh.size, device=mesh.device)
            ops.step(t, batch.step_inputs(s.current_lr(), "cpu", mesh=block),
                     s.cfg)
            parts.append((t.w_in, t.w_out))
        s.train_batch(batch)
        (a_in, a_out), (b_in, b_out) = parts
        return all(torch.equal(want.view(torch.int32), got.view(torch.int32))
                   for want, got in (((a_in + b_in) / 2, s.state.w_in),
                                     ((a_out + b_out) / 2, s.state.w_out)))


    def t1_plan(mesh):
        """A T=1 tile plan under the mesh against the sequential path."""
        import torch
        from repro_torch.data.batching import Batch, plan_tiles
        kw = dict(tile_windows=4)
        seq = session(mesh, dict(tile_windows=1))
        sb = next(seq.pipeline.batches(pad_len=seq.cfg.resolved_pad_len,
                                       epoch=0))
        tiled = Batch(tokens=sb.tokens, negs=sb.negs, lengths=sb.lengths,
                      n_words=sb.n_words,
                      plan=plan_tiles(sb.tokens, sb.negs, sb.lengths, 1))
        a, b = session(mesh, kw), session(mesh, kw)
        a.train_batch(sb)
        b.train_batch(tiled)
        return (torch.equal(a.state.w_in, b.state.w_in)
                and torch.equal(a.state.w_out, b.state.w_out))


    def resume(mesh, d):
        """Checkpoint a 2-rank run at batch 2 (rank 0 writes), resume a new
        2-rank session there and train batch 3: the uninterrupted run's
        tables, bit for bit."""
        import torch
        kw = dict(tile_windows=4)
        full = session(mesh, kw)
        full.train(max_batches=3)
        first = session(mesh, kw, ckpt_dir=d, ckpt_every=2)
        first.train(max_batches=2)
        emb = first.embeddings()
        again = session(mesh, kw, ckpt_dir=d)
        step = again.resumed_step
        again.train(max_batches=1)
        return {"resumed_step": step, "emb": emb.tolist(), "exact": all(
            torch.equal(a, b) for a, b in zip(
                again.state.params().values(), full.state.params().values()))}


    def dp(mesh, ref_path, cases, ckpt_dir):
        import torch
        torch.set_num_threads(1)
        z = np.load(ref_path)
        out = {"equal": {}, "leaves": {}}
        for name, kw in cases.items():
            s = session(mesh, kw, z, name + "|init|")
            s.train(max_batches=3)
            out["equal"][name] = ranks_agree(mesh, digest(s.state.params()))
            out["leaves"].update(leaves(s.gathered_params(), name + "|"))
        if mesh.size == 2:
            out["emulated"] = {name: emulate(mesh, kw, z, name + "|init|")
                               for name, kw in cases.items()
                               if "tables" not in kw}
            out["t1_plan"] = t1_plan(mesh)
            out["resume"] = resume(mesh, ckpt_dir)
        return out


    def quality(mesh, tile):
        import torch
        torch.set_num_threads(1)
        from repro_torch.configs.w2v import smoke
        from repro_torch.core.quality import evaluate
        from repro_torch.core.trainer import TrainSession
        from repro_torch.data.batching import BatchingPipeline
        from repro_torch.data.corpus import synthetic_cluster_corpus
        cfg = smoke(epochs=10, dim=32, sentences_per_batch=64,
                    tile_windows=tile)
        corpus = synthetic_cluster_corpus(n_clusters=6, words_per_cluster=12,
                                          n_sentences=400, mean_len=12,
                                          seed=0)
        pipe = BatchingPipeline(corpus, cfg)
        s = TrainSession(pipe, cfg, device="cpu", mesh=mesh)
        s.train()
        inv = np.zeros(pipe.vocab.size, dtype=int)
        for w, i in pipe.vocab.ids.items():
            inv[i] = corpus.clusters[w]
        return {"metrics": evaluate(s.embeddings(), inv, seed=0),
                "backend": s.backend, "batches": s.state.batches_seen}


    if __name__ == "__main__":
        from repro_torch.launch.mesh import start_ranks
        mode, n, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
        if mode == "dp":
            res = start_ranks(dp, n, "cpu", sys.argv[4],
                              json.loads(sys.argv[5]), sys.argv[6],
                              timeout=400)
            np.savez(out_path, **res.pop("leaves"))
        else:
            res = start_ranks(quality, n, "cpu", int(sys.argv[4]),
                              timeout=400)
        with open(out_path + ".json", "w") as f:
            json.dump(res, f)
''')


def run_ref(tmp, n: int, cases: dict) -> str:
    path = str(tmp / f"ref{n}.npz")
    code = REF + f"\nmain({path!r}, {cases!r})\n"
    r = run_subprocess(code, n_devices=n, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return path


def run_port(tmp, *args) -> dict:
    script = tmp / "port_ranks.py"
    script.write_text(PORT)
    out = str(tmp / f"port_{args[0]}_{args[1]}.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), args[0], str(args[1]),
                        out, *map(str, args[2:])], env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out + ".json") as f:
        res = json.load(f)
    if os.path.exists(out):
        res["npz"] = dict(np.load(out))
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Reference and port, 2 and 4 ranks, every case of CASES."""
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"dp{n}")
        ref = dict(np.load(run_ref(tmp, n, CASES)))
        out[n] = (ref, run_port(tmp, "dp", n, tmp / f"ref{n}.npz",
                                json.dumps(CASES), tmp / "ckpt"))
        out[f"ckpt{n}"] = tmp / "ckpt"
    return out


def _ordered_bf16(bits: np.ndarray) -> np.ndarray:
    """bf16 patterns as integers ordered like their values."""
    b = bits.astype(np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def assert_leaf(name: str, got: np.ndarray, want: np.ndarray,
                quanta: int, old=None) -> None:
    """f32 leaves within the kernel tolerance (int8 scales within rtol
    1e-6); bf16 and int8 storage within ``quanta`` steps and, given
    ``old`` (the leaf before one step), at least 99% bit-equal among the
    elements the step moved: the f32 stages agree far inside a quantum, so
    a stored difference is a rounding key or a transport that differs."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if got.dtype == np.float32:
        tol = dict(rtol=1e-6) if "scale" in name else TOL
        np.testing.assert_allclose(got, want, **tol, err_msg=name)
        return
    if name.endswith("@bf16"):
        diff = np.abs(_ordered_bf16(got) - _ordered_bf16(want))
    else:
        diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= quanta, (name, int(diff.max()),
                                  float((diff == 0).mean()))
    if old is not None:
        moved = want != old
        assert moved.any() and (diff[moved] == 0).mean() >= 0.99, (
            name, float((diff[moved] == 0).mean()), int(moved.sum()))


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_data_parallel_session_matches_reference(runs, n, case):
    ref, port = runs[n]
    names = [k for k in ref if k.startswith(case + "|final|")]
    assert names
    for key in names:
        leaf = key.split("|")[-1]
        got = port["npz"][f"{case}|{leaf}"]
        assert_leaf(leaf, got, ref[key], 2)
        init = ref[f"{case}|init|{leaf}"]
        assert not np.array_equal(got, init), f"{leaf} did not train"


@pytest.mark.parametrize("n", [2, 4])
def test_replicas_are_equal_across_ranks(runs, n):
    assert runs[n][1]["equal"] == {c: True for c in CASES}


@pytest.mark.parametrize("case", ["T1", "T4"])
def test_two_rank_batch_is_the_mean_of_block_updates(runs, case):
    assert runs[2][1]["emulated"][case]


def test_t1_plan_under_the_mesh_matches_the_sequential_path(runs):
    assert runs[2][1]["t1_plan"]


@pytest.mark.parametrize("tile", [1])
def test_four_rank_hogwild_quality(tmp_path, tile):
    """The reference's Hogwild gate (test_multidevice.py): averaging
    divides each replica's update by the rank count, so the scale-free
    metrics carry it."""
    res = run_port(tmp_path, "quality", 4, tile)
    m = res["metrics"]
    assert res["backend"] == "torch" and res["batches"] == 70
    assert m["spearman"] > 0.3, m
    assert m["nn_purity"] > 0.6, m
    assert m["separation"] > 0.01, m


def test_two_rank_checkpoint_resumes_and_restores(runs):
    """Rank 0 writes the replicas in the reference's format: a new 2-rank
    session resumes from it bit for bit, and one process restores the
    same embeddings."""
    from repro_torch.configs.w2v import smoke
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus

    res = runs[2][1]["resume"]
    assert res["resumed_step"] == 2 and res["exact"]
    cfg = smoke(dim=16, sentences_per_batch=64, tile_windows=4)
    one = TrainSession(BatchingPipeline(synthetic_cluster_corpus(
        n_clusters=6, words_per_cluster=12, n_sentences=200, mean_len=12,
        seed=0), cfg), cfg, device="cpu", ckpt_dir=str(runs["ckpt2"]))
    assert one.resumed_step == 2
    assert np.array_equal(one.embeddings(),
                          np.asarray(res["emb"], np.float32))


def _two_rank_session(**kw):
    from repro_torch.configs.w2v import smoke
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus
    from repro_torch.launch.mesh import DataMesh

    cfg = smoke(dim=16, **kw)
    mesh = DataMesh(rank=0, size=2, device="cpu", backend="gloo")
    return TrainSession(BatchingPipeline(synthetic_cluster_corpus(
        n_clusters=6, words_per_cluster=12, n_sentences=60, mean_len=12,
        seed=0), cfg), cfg, device="cpu", mesh=mesh)


def test_a_batch_that_does_not_split_over_the_ranks_raises():
    s = _two_rank_session(sentences_per_batch=15)
    batch = next(s.pipeline.batches(pad_len=s.cfg.resolved_pad_len))
    with pytest.raises(ValueError, match="15 sentences does not shard "
                                         "over 2"):
        s.train_batch(batch)
