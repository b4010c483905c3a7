"""Vocab sharding past one shard in the port: ``TrainSession(mesh=...)``
with ``cfg.vocab_shard`` over 2 and 4 gloo ranks on the CPU, one shard a
rank, against the reference's N-device sessions from the same tables:

* 2 and 4 shards, T=1 and T=4, the exact and the dense exchange: f32
  within atol 2e-5 / rtol 1e-4 after 3 batches;
* the port's own DESIGN.md §8 rule against its data-parallel run: the hot
  head bit for bit, the cold tail within atol 1e-6 / rtol 1e-5;
* mixed storage at 2 shards (``hot=bf16,cold=int8``, ``cold=bf16`` and the
  ``master=1`` copy) within one storage quantum after one step and two
  after three; the int8 tail's stochastic rounding at 2 shards;
* checkpoints: 4 shards into a replicated session, 4 into 2 with
  coinciding split shapes, 2 into 1 (f32 and mixed), 1 into 2, and the
  reference's 2-device checkpoint into the port's 2 ranks and back, each
  bit for bit in the embeddings;
* the CLI starting 2 ranks, its ``final_digest`` the same with thread
  or process prefetch workers.

Runs as test_torch_data_parallel.py does: each side in subprocesses,
``.npz`` files between them."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tests.conftest import REPO, SRC, run_subprocess
from tests.test_torch_data_parallel import COMMON, assert_leaf

COLD = dict(atol=1e-6, rtol=1e-5)
F32 = {"T1_exact": dict(tile_windows=1, tables="exchange=exact"),
       "T4_exact": dict(tile_windows=4, tables="exchange=exact"),
       "T1_dense": dict(tile_windows=1, tables="exchange=dense"),
       "T4_dense": dict(tile_windows=4, tables="exchange=dense")}
MIXED = {"int8": dict(tile_windows=4, tables="hot=bf16,cold=int8,shards=2"),
         "bf16": dict(tile_windows=1, tables="cold=bf16,shards=2"),
         "master": dict(tile_windows=4,
                        tables="hot=bf16,cold=int8,shards=2,master=1")}
CKPT_F32 = dict(tile_windows=1)

SHARED = COMMON + textwrap.dedent('''
    def corpus_kw():                  # V=128: 8 clusters of 16 words
        return dict(n_clusters=8, words_per_cluster=16, n_sentences=200,
                    mean_len=12, seed=0)


    def cfg_kw(case_kw, n=1):
        kw = dict(dim=16, sentences_per_batch=64, vocab_shard=True,
                  hot_vocab_frac=0.25, epochs=2, **case_kw)
        kw["tables"] = kw.get("tables", "").format(n=n)
        return kw
''')

REF = SHARED + textwrap.dedent('''
    def session(cfg_case, mesh, **kw):
        from repro.configs.w2v import smoke
        from repro.core.trainer import TrainSession
        from repro.data.batching import BatchingPipeline
        from repro.data.corpus import synthetic_cluster_corpus
        cfg = smoke(**cfg_kw(cfg_case, 2))
        return TrainSession(BatchingPipeline(
            synthetic_cluster_corpus(**corpus_kw()), cfg), cfg,
            backend="jnp", mesh=mesh, **kw)


    def main(path, cases, steps, ckpt, back):
        from repro.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=1)
        out = {}
        for name, kw in cases.items():
            s = session(kw, mesh)
            out.update(leaves(s.state.params(), name + "|init|"))
            for k, _ in enumerate(s.stream(max_batches=steps[-1]), 1):
                if k in steps:
                    out.update(leaves(s.state.params(), f"{name}|{k}|"))
        if ckpt:
            s = session(dict(tile_windows=1), mesh, ckpt_dir=ckpt,
                        ckpt_every=2)
            s.train(max_batches=2)
            out["ckpt|emb"] = np.asarray(s.embeddings())
        if back:
            s = session(dict(tile_windows=1), mesh, ckpt_dir=back)
            assert s.resumed_step == 2, s.resumed_step
            out["back|emb"] = np.asarray(s.embeddings())
        np.savez(path, **out)
''')

PORT = SHARED + textwrap.dedent('''
    import hashlib


    def agree(mesh, tensors):
        import torch
        import torch.distributed as dist
        h = hashlib.sha256()
        for t in tensors:
            t = t.detach().contiguous()
            h.update((t.view(torch.int16) if t.dtype == torch.bfloat16
                      else t).numpy().tobytes())
        every = [None] * mesh.size
        dist.all_gather_object(every, h.hexdigest())
        return len(set(every)) == 1


    def session(mesh, kw, z=None, prefix=None, vocab_shard=True, **sess_kw):
        from repro_torch.configs.w2v import smoke
        from repro_torch.convert import params_from_reference
        from repro_torch.core.trainer import TrainSession
        from repro_torch.data.batching import BatchingPipeline
        from repro_torch.data.corpus import synthetic_cluster_corpus
        n = 1 if mesh is None else mesh.size
        cfg = smoke(**{**cfg_kw(kw, n), "vocab_shard": vocab_shard})
        s = TrainSession(BatchingPipeline(
            synthetic_cluster_corpus(**corpus_kw()), cfg), cfg,
            device="cpu", mesh=mesh, **sess_kw)
        if z is not None:
            s.state = params_from_reference(from_leaves(z, prefix), "cpu",
                                            mesh)
        return s


    def rounding(mesh):
        """One exact int8 step from the same tables under two rounding
        keys: the share of the moved cold elements whose stored byte
        depends on the key (0 at one shard, where the write-back already
        lies on the grid)."""
        import torch
        from repro_torch.kernels import ops, quant
        s = session(mesh, dict(tile_windows=4,
                               tables="hot=bf16,cold=int8,shards={n}"))
        batch = next(s.pipeline.batches(pad_len=s.cfg.resolved_pad_len,
                                        epoch=0))
        outs = []
        for key in ((1, 2), (3, 4)):
            t = s._tables()
            t.cold_in, t.scale_in = t.cold_in.clone(), t.scale_in.clone()
            t.cold_out, t.scale_out = t.cold_out.clone(), t.scale_out.clone()
            t.w_in, t.w_out = t.w_in.clone(), t.w_out.clone()
            step = s._make_step(batch, s.current_lr())
            step.round_key = np.array(key, np.uint32)
            ops.step(t, step, s.cfg, mesh=mesh)
            outs.append(quant.decode(t.cold_in, t.scale_in, "int8"))
        before = quant.decode(s.state.cold_in, s.state.scale_in, "int8")
        moved = (outs[0] != before) | (outs[1] != before)
        differ = (outs[0] != outs[1]) & moved
        return [int(differ.sum()), int(moved.sum())]


    def run(mesh, ref_path, cases, steps, ckpt_root, restores):
        import torch
        torch.set_num_threads(1)
        z = np.load(ref_path)
        out = {"leaves": {}, "equal": {}, "emb": {}}
        for name, kw in cases.items():
            s = session(mesh, kw, z, name + "|init|")
            for k, _ in enumerate(s.stream(max_batches=steps[-1]), 1):
                if k in steps:
                    out["leaves"].update(leaves(s.gathered_params(),
                                                f"{name}|{k}|"))
            out["equal"][name] = agree(mesh, (s.state.w_in, s.state.w_out))
        # the port's own §8 rule: sharded vs data-parallel, own init
        for tile in (1, 4):
            for shard in (True, False):
                s = session(mesh, dict(tile_windows=tile), vocab_shard=shard)
                s.train(max_batches=3)
                out["emb"][f"rule|T{tile}|{shard}"] = s.embeddings()
                if shard:
                    out["hot"] = s.placement.hot
        # checkpoints written by N ranks
        written = (("f32", dict(tile_windows=1)),
                   ("mixed", dict(tile_windows=4,
                                  tables="hot=bf16,cold=int8,shards={n}")))
        for name, kw in written[:1 if mesh.size > 2 else 2]:
            d = f"{ckpt_root}/port{mesh.size}_{name}"
            s = session(mesh, kw, ckpt_dir=d, ckpt_every=2)
            s.train(max_batches=2)
            out["emb"][f"ckpt|{name}"] = s.embeddings()
            out[f"placement|{name}"] = s.placement.to_extra()
        # and restored by N ranks
        for name, (kw, d) in restores.items():
            s = session(mesh, kw, ckpt_dir=d)
            assert s.resumed_step == 2, (name, s.resumed_step)
            out["emb"][f"restore|{name}"] = s.embeddings()
            out[f"placement|restore|{name}"] = s.placement.to_extra()
        if mesh.size == 2:
            out["rounding"] = rounding(mesh)
        return out


    if __name__ == "__main__":
        from repro_torch.launch.mesh import start_ranks
        n, spec = int(sys.argv[1]), json.loads(sys.argv[2])
        res = start_ranks(run, n, "cpu", spec["ref"], spec["cases"],
                          spec["steps"], spec["ckpt_root"], spec["restores"],
                          timeout=400)
        np.savez(spec["out"], **res.pop("leaves"),
                 **{"emb|" + k: v for k, v in res.pop("emb").items()})
        with open(spec["out"] + ".json", "w") as f:
            json.dump(res, f)
''')


def _ref(tmp, n, cases, steps, ckpt=None, back=None) -> dict:
    path = str(tmp / f"ref{n}_{'back' if back else 'run'}.npz")
    code = REF + (f"\nmain({path!r}, {cases!r}, {steps!r}, {ckpt!r}, "
                  f"{back!r})\n")
    r = run_subprocess(code, n_devices=n, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(path))


def _port(tmp, n, ref_npz, cases, steps, restores) -> dict:
    script = tmp / "port_ranks.py"
    script.write_text(PORT)
    out = str(tmp / f"port{n}.npz")
    spec = dict(ref=ref_npz, cases=cases, steps=steps, out=out,
                ckpt_root=str(tmp), restores=restores)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, str(script), str(n),
                        json.dumps(spec)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out + ".json") as f:
        res = json.load(f)
    res["npz"] = dict(np.load(out))
    return res


def _one_process(d, write=False, **kw):
    """A session of one process (no mesh) on the same corpus."""
    from repro_torch.configs.w2v import smoke
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus
    base = dict(dim=16, sentences_per_batch=64, vocab_shard=True,
                hot_vocab_frac=0.25, epochs=2, tile_windows=1)
    cfg = smoke(**{**base, **kw})
    return TrainSession(BatchingPipeline(synthetic_cluster_corpus(
        n_clusters=8, words_per_cluster=16, n_sentences=200, mean_len=12,
        seed=0), cfg), cfg, device="cpu", ckpt_dir=d,
        ckpt_every=2 if write else 0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vs")
    torch.set_num_threads(1)
    # one-process checkpoints (1 -> 2 shards), f32 and mixed
    one = {}
    for name, kw in (("f32", {}), ("mixed", dict(
            tile_windows=4, tables="hot=bf16,cold=int8,shards=1"))):
        d = str(tmp / f"one_{name}")
        s = _one_process(d, write=True, **kw)
        s.train(max_batches=2)
        one[name] = (d, s.embeddings())
    ref4 = _ref(tmp, 4, F32, [3])
    port4 = _port(tmp, 4, str(tmp / "ref4_run.npz"), F32, [3], {})
    ref2 = _ref(tmp, 2, {**F32, **MIXED}, [1, 3], ckpt=str(tmp / "ref_ck"))
    mixed2 = dict(tile_windows=4, tables="hot=bf16,cold=int8,shards=2")
    port2 = _port(tmp, 2, str(tmp / "ref2_run.npz"), {**F32, **MIXED},
                  [1, 3], {"from4": (CKPT_F32, str(tmp / "port4_f32")),
                           "from_ref": (CKPT_F32, str(tmp / "ref_ck")),
                           "from1": (CKPT_F32, one["f32"][0]),
                           "from1_mixed": (mixed2, one["mixed"][0])})
    back = _ref(tmp, 2, {}, [], back=str(tmp / "port2_f32"))
    return dict(tmp=tmp, one=one, ref={2: ref2, 4: ref4},
                port={2: port2, 4: port4}, back=back)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", list(F32))
def test_sharded_session_matches_reference(runs, n, case):
    ref, port = runs["ref"][n], runs["port"][n]
    keys = [k for k in ref if k.startswith(f"{case}|3|")]
    assert {k.split("|")[-1] for k in keys} == {"hot_in", "hot_out",
                                                "cold_in", "cold_out"}
    for key in keys:
        assert_leaf(key, port["npz"][key], ref[key], 0)
    assert port["equal"][case]


@pytest.mark.parametrize("case", list(MIXED))
@pytest.mark.parametrize("step,quanta", [(1, 1), (3, 2)])
def test_mixed_two_shards_match_reference(runs, case, step, quanta):
    ref, port = runs["ref"][2], runs["port"][2]
    keys = [k for k in ref if k.startswith(f"{case}|{step}|")]
    assert len(keys) >= 4
    for key in keys:
        leaf = key.split("|")[-1]
        old = ref[f"{case}|init|{leaf}"] if step == 1 else None
        if leaf.startswith("scale"):
            old = None              # scales move with every touched row
        assert_leaf(leaf, port["npz"][key], ref[key], quanta, old)
    assert port["equal"][case]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tile", [1, 4])
def test_port_sharded_vs_data_parallel_rule(runs, n, tile):
    """DESIGN.md §8: the head bit for bit, the tail within 1e-6."""
    port = runs["port"][n]
    vs = port["npz"][f"emb|rule|T{tile}|True"]
    dp = port["npz"][f"emb|rule|T{tile}|False"]
    hot = port["hot"]
    assert np.array_equal(vs[:hot], dp[:hot])
    np.testing.assert_allclose(vs[hot:], dp[hot:], **COLD)


def test_int8_tail_rounding_leaves_the_grid_past_one_shard(runs):
    """At one shard the exact write-back lies on the int8 grid and the
    rounding key moves no stored byte (ROADMAP queue 3); at two the
    Hogwild mean of a quantized transport and the old row leaves it."""
    differ, moved = runs["port"][2]["rounding"]
    assert moved > 0 and differ > 0, (differ, moved)


def _emb(runs, n, key):
    return runs["port"][n]["npz"][f"emb|{key}"]


def test_four_shard_checkpoint_restores_into_a_replicated_session(runs):
    d = str(runs["tmp"] / "port4_f32")
    s = _one_process(d, vocab_shard=False)
    assert s.resumed_step == 2 and s.placement is None
    assert np.array_equal(s.embeddings(), _emb(runs, 4, "ckpt|f32"))


def test_four_shards_restore_into_two_with_coinciding_shapes(runs):
    """V=128, hot=32: cold_pad is 96 at 2 and at 4 shards, the stripe
    order differs; the restore re-splits through the placements."""
    p4 = runs["port"][4]["placement|f32"]
    p2 = runs["port"][2]["placement|restore|from4"]
    assert (p4["n_shards"], p2["n_shards"]) == (4, 2)
    assert p4["hot"] == p2["hot"] == 32 and p4["vocab_size"] == 128
    assert np.array_equal(_emb(runs, 2, "restore|from4"),
                          _emb(runs, 4, "ckpt|f32"))


@pytest.mark.parametrize("name,tables", [
    ("f32", ""), ("mixed", "hot=bf16,cold=int8,shards=1")])
def test_two_shard_checkpoint_restores_into_one(runs, name, tables):
    d = str(runs["tmp"] / f"port2_{name}")
    kw = dict(tile_windows=4, tables=tables) if tables else {}
    s = _one_process(d, **kw)
    assert s.resumed_step == 2 and s.placement.n_shards == 1
    assert np.array_equal(s.embeddings(), _emb(runs, 2, f"ckpt|{name}"))
    if tables:                     # and into a replicated f32 session
        f32 = _one_process(d, vocab_shard=False)
        assert np.array_equal(f32.embeddings(), _emb(runs, 2, "ckpt|mixed"))


@pytest.mark.parametrize("name", ["f32", "mixed"])
def test_one_shard_checkpoint_restores_into_two(runs, name):
    key = "from1" if name == "f32" else "from1_mixed"
    assert runs["port"][2]["placement|restore|" + key]["n_shards"] == 2
    assert np.array_equal(_emb(runs, 2, f"restore|{key}"),
                          runs["one"][name][1])


def test_reference_two_device_checkpoint_into_the_port_and_back(runs):
    ref = runs["ref"][2]["ckpt|emb"]
    assert np.array_equal(_emb(runs, 2, "restore|from_ref"), ref)
    assert np.array_equal(runs["back"]["back|emb"],
                          _emb(runs, 2, "ckpt|f32"))


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "w2v", "--device",
         "cpu", "--vocab", "128", "--clusters", "8", "--sentences", "80",
         "--sentences-per-batch", "16", "--max-batches", "3", "--epochs",
         "1", *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("flags,mode", [
    (("--vocab-shard", "2", "--tile-windows", "4"), "thread"),
    (("--tables", "hot=bf16,cold=int8,shards=2"), "process")])
def test_cli_two_ranks_keep_the_digest_with_workers(flags, mode):
    """Every rank runs its own prefetch workers on the same keyed
    stream, so the digest of the gathered tables is the synchronous
    run's."""
    digests = []
    for extra in ((), ("--prefetch-workers", "2", "--prefetch-mode", mode)):
        out = _cli(*flags, *extra)
        assert out.returncode == 0, out.stderr[-3000:]
        assert "shards=2 ranks=2 backend=gloo" in out.stdout, out.stdout
        assert out.stdout.count("final_digest=") == 1, out.stdout
        digests.append(out.stdout.split("final_digest=")[1].split()[0])
    assert digests[0] == digests[1]
