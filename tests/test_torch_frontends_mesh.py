"""The workload frontends on 2 gloo ranks of the port (``TrainSession(mesh=
...)`` on the CPU) against the reference's 2-device sessions (fake host
devices) from the same tables, for node2vec, doc2vec and subword:

* data-parallel (replicated tables, each rank's block of sentences, its
  doc rows and bags) and vocab-sharded on the exact exchange (one shard a
  rank; doc rows and n-gram buckets in the cold tail), T=4, 3 batches:
  every table leaf within atol 2e-5 / rtol 1e-4;
* subword on ``hot=bf16:frac=0.25,cold=int8,shards=2`` (the n-gram rows in
  the int8 tail): the bf16 head and int8 tail within two storage quanta,
  the int8 scales within rtol 1e-6;
* the port's digest of the gathered tables the same on a rerun and with 2
  thread prefetch workers.

Runs as ``test_torch_data_parallel.py`` does: each side in a subprocess,
``.npz`` files between them."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tests.conftest import SRC, run_subprocess
from tests.test_torch_data_parallel import COMMON, assert_leaf

CASES = {f"{name}|{mode}": (name, mode)
         for name in ("node2vec", "doc2vec", "subword")
         for mode in ("dp", "vs")}
CASES["subword|mixed"] = ("subword", "mixed")

SHARED = COMMON + textwrap.dedent('''
    KNOBS = {
        "node2vec": dict(communities=6, nodes_per=8, walks_per_node=2,
                         walk_length=16),
        "doc2vec": dict(docs=12, sents_per_doc=8, clusters=4,
                        words_per_cluster=12, mean_len=10),
        "subword": dict(vocab=96, clusters=6, sentences=150, mean_len=10,
                        buckets=64),
    }


    def cfg_kw(mode):
        kw = dict(dim=16, sentences_per_batch=32, tile_windows=4)
        if mode == "vs":
            kw.update(vocab_shard=True, hot_vocab_frac=0.3,
                      tables="exchange=exact")
        if mode == "mixed":
            kw.update(tables="hot=bf16:frac=0.25,cold=int8,shards=2")
        return kw
''')

REF = SHARED + textwrap.dedent('''
    def main(path, cases):
        from repro import frontends
        from repro.configs.w2v import smoke
        from repro.core.trainer import TrainSession
        from repro.data.batching import BatchingPipeline
        from repro.launch.mesh import make_host_mesh

        mesh = make_host_mesh(model=1)
        out = {}
        for key, (name, mode) in cases.items():
            w = frontends.get(name).build(smoke(**cfg_kw(mode)),
                                          **KNOBS[name])
            pipe = BatchingPipeline(w.corpus, w.cfg)
            w.attach(pipe)
            s = TrainSession(pipe, w.cfg, backend="jnp", mesh=mesh)
            out.update(leaves(s.state.params(), key + "|init|"))
            s.train(max_batches=3)
            out.update(leaves(s.state.params(), key + "|final|"))
        np.savez(path, **out)
''')

PORT = SHARED + textwrap.dedent('''
    import hashlib


    def session(mesh, name, mode, z=None, prefix=None, workers=0):
        from repro_torch import frontends
        from repro_torch.configs.w2v import smoke
        from repro_torch.convert import params_from_reference
        from repro_torch.core.trainer import TrainSession
        from repro_torch.data.batching import BatchingPipeline
        from repro_torch.data.prefetch import AsyncBatchingPipeline
        w = frontends.get(name).build(smoke(**cfg_kw(mode)), **KNOBS[name])
        pipe = (AsyncBatchingPipeline(w.corpus, w.cfg, workers=workers)
                if workers else BatchingPipeline(w.corpus, w.cfg))
        w.attach(pipe)
        s = TrainSession(pipe, w.cfg, device="cpu", mesh=mesh)
        if z is not None:
            s.state = params_from_reference(from_leaves(z, prefix), "cpu",
                                            mesh)
        return s


    def digest(s):
        import torch
        h = hashlib.sha256()
        for v in s.gathered_params().values():
            v = v.detach().contiguous()
            if v.dtype == torch.bfloat16:
                v = v.view(torch.int16)
            h.update(v.numpy().tobytes())
        return h.hexdigest()


    def run(mesh, ref_path, cases):
        import torch
        torch.set_num_threads(1)
        z = np.load(ref_path)
        out = {"leaves": {}, "digests": {}, "backend": {}}
        for key, (name, mode) in cases.items():
            s = session(mesh, name, mode, z, key + "|init|")
            s.train(max_batches=3)
            out["leaves"].update(leaves(s.gathered_params(), key + "|"))
            out["backend"][key] = s.backend
            runs = []
            for workers in (0, 0, 2):
                s = session(mesh, name, mode, workers=workers)
                s.train(max_batches=3)
                runs.append(digest(s))
            out["digests"][key] = runs
        return out


    if __name__ == "__main__":
        from repro_torch.launch.mesh import start_ranks
        out_path = sys.argv[2]
        res = start_ranks(run, 2, "cpu", sys.argv[1],
                          json.loads(sys.argv[3]), timeout=500)
        np.savez(out_path, **res.pop("leaves"))
        with open(out_path + ".json", "w") as f:
            json.dump(res, f)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frontends_mesh")
    ref_path = str(tmp / "ref.npz")
    r = run_subprocess(REF + f"\nmain({ref_path!r}, {CASES!r})\n",
                       n_devices=2, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    script = tmp / "port_ranks.py"
    script.write_text(PORT)
    out = str(tmp / "port.npz")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, str(script), ref_path, out,
                        json.dumps(CASES)], env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out + ".json") as f:
        res = json.load(f)
    return dict(np.load(ref_path)), dict(np.load(out)), res


@pytest.mark.parametrize("key", list(CASES))
def test_two_rank_session_matches_reference(runs, key):
    ref, port, res = runs
    assert res["backend"][key] == "torch_tiled"
    names = [k for k in ref if k.startswith(key + "|final|")]
    want_leaves = ({"hot_in", "hot_out", "cold_in", "cold_out"}
                   if key.endswith("vs") else {"w_in", "w_out"})
    if key.endswith("mixed"):
        want_leaves = {"hot_in@bf16", "hot_out@bf16", "cold_in", "cold_out",
                       "scale_in", "scale_out"}
    assert {k.split("|")[-1] for k in names} == want_leaves
    for k in names:
        leaf = k.split("|")[-1]
        got = port[f"{key}|{leaf}"]
        assert_leaf(leaf, got, ref[k], 2)
        assert not np.array_equal(got, ref[f"{key}|init|{leaf}"]), leaf
    if key.endswith("mixed"):
        assert port[f"{key}|cold_in"].dtype == np.int8


@pytest.mark.parametrize("key", list(CASES))
def test_two_rank_digest_is_the_same_on_a_rerun_and_with_workers(runs, key):
    digests = runs[2]["digests"][key]
    assert len(digests) == 3 and len(set(digests)) == 1, digests
