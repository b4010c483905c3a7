"""Train a tiny corpus, serve it, and hot-swap a fresh checkpoint on the
PyTorch port: the full training-to-serving story (DESIGN.md §10) in one
script. The port's counterpart of ``examples/serve_w2v.py``.

1. Train FULL-W2V on a synthetic clustered corpus (vocab-sharded layout,
   one shard) and publish a split checkpoint.
2. Stand up the snapshot watcher + batching server over the checkpoint
   directory and answer nearest-neighbour and analogy queries, checking
   every answer against the dense single-process oracle.
3. Train a little more, publish a new checkpoint, and watch the server
   pick it up without restarting (in-flight queries finish on the old
   snapshot; new ones see the new step).

    PYTHONPATH=src python examples/torch_serve_w2v.py [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises without
one: the session, the served index and the queries all live on that
device. Deliberate differences from the reference:

* ``--device`` (the reference has no flags);
* ``backend="auto"`` resolves against the device: the sequential CUDA
  kernel (``cuda``: a vocab-sharded T=1 step takes it, not the pipelined
  one) on the GPU, the plain torch version (``torch``) on the CPU;
* one more line, ``backend=<name> device=<name>``;
* the initial tables come from a ``torch.Generator`` (the reference draws
  with ``jax.random``): :func:`run` takes ``init_tables`` (the split tree
  ``hot_in``, ``hot_out``, ``cold_in``, ``cold_out``) to start from given
  tables instead, as the tests do with the reference's, and returns the
  served answers.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.w2v import smoke
from repro_torch.convert import params_from_reference
from repro_torch.core.trainer import TrainSession
from repro_torch.data.batching import BatchingPipeline
from repro_torch.data.corpus import synthetic_cluster_corpus
from repro_torch.serve import EmbeddingServer, SnapshotWatcher
from repro_torch.serve.query import dense_topk


def check_parity(res, oracle, ids, k, mode):
    want_ids, want_sc = dense_topk(oracle, ids, k=k, mode=mode)
    ok = (np.array_equal(res.ids, want_ids)
          and np.allclose(res.scores, want_sc, atol=1e-5))
    assert ok, f"{mode} results diverge from the dense oracle"
    return want_ids


def run(device=None, init_tables=None) -> dict:
    """Train, serve, hot-swap; print the reference's lines and return the
    served answers (``nn``, ``analogy``, ``post_swap``: ids and scores)
    and the server's query count."""
    cfg = smoke(epochs=4, dim=32, vocab_shard=True)
    corpus = synthetic_cluster_corpus(n_clusters=8, words_per_cluster=16,
                                      n_sentences=800, mean_len=12, seed=0)
    ckpt_dir = tempfile.mkdtemp(prefix="serve_w2v_")
    trainer = TrainSession(BatchingPipeline(corpus, cfg), cfg,
                           backend="auto", device=device, ckpt_dir=ckpt_dir)
    if init_tables is not None:
        trainer.state = params_from_reference(init_tables, trainer.device)
    name = (torch.cuda.get_device_name(trainer.device)
            if trainer.device.type == "cuda" else "cpu")
    print(f"backend={trainer.backend} device={name}")
    # stop short of the last epoch: the run continues (at a live learning
    # rate) after the server is up, for the hot-swap leg below
    trainer.train(max_batches=40)
    print("checkpoint:", trainer.save_checkpoint())
    answers = {}

    with SnapshotWatcher(ckpt_dir, poll_s=0.05,
                         device=trainer.device) as watcher:
        index = watcher.wait_ready()
        print(f"serving: step={index.step} vocab={index.vocab_size} "
              f"dim={index.dim} shards={index.n_shards}")
        with EmbeddingServer(watcher, batch_size=16, deadline_ms=1.0,
                             k=4) as server:
            oracle = index.dense_embeddings()

            # nearest neighbours: same-cluster words should dominate
            inv = np.zeros(index.vocab_size, dtype=int)
            for w, i in trainer.pipeline.vocab.ids.items():
                inv[i] = corpus.clusters[w]
            ids = np.array([0, 20, 40], np.int32)
            res = answers["nn"] = server.neighbors(ids)
            check_parity(res, oracle, ids, k=4, mode="nn")
            for q, row in zip(ids, res.ids):
                print(f"  word {q} (cluster {inv[q]}) -> neighbours "
                      f"{[(int(n), int(inv[n])) for n in row]}")
            print("oracle_parity=ok (nn)")

            # analogy a - b + c: clustermate of c expected near the top
            triples = np.array([[0, 1, 20], [20, 21, 40]], np.int32)
            res = answers["analogy"] = server.analogy(triples)
            check_parity(res, oracle, triples, k=4, mode="analogy")
            print("oracle_parity=ok (analogy)")

            # --- hot-swap: publish a newer checkpoint mid-serving -------
            old_step = index.step
            old_res = server.neighbors(ids)
            trainer.train(max_batches=10)
            print("checkpoint:", trainer.save_checkpoint())
            deadline = time.monotonic() + 30.0
            while watcher.current().step == old_step:
                assert time.monotonic() < deadline, "swap not picked up"
                time.sleep(0.05)
            new_index = watcher.current()
            print(f"swap: step {old_step} -> {new_index.step} "
                  f"(server not restarted)")
            res = answers["post_swap"] = server.neighbors(ids)
            assert res.snapshot_step == new_index.step
            check_parity(res, new_index.dense_embeddings(), ids, k=4,
                         mode="nn")
            print("oracle_parity=ok (post-swap)")
            # ten more training batches move the scores (the ids of a
            # converged tiny model may legitimately hold steady)
            changed = not np.allclose(old_res.scores, res.scores)
            assert changed, "post-swap answers identical to pre-swap"
            print(f"answers_changed={changed} "
                  f"(served {server.served} queries, 0 dropped)")
            served = server.served
    print("serve_w2v: ok")
    return {"answers": {k: (np.asarray(r.ids), np.asarray(r.scores))
                        for k, r in answers.items()},
            "served": served, "backend": trainer.backend}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the GPU; raises "
                         "without one)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
