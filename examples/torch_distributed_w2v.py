"""Data-parallel Hogwild W2V on the PyTorch port: sentences shard over the
ranks of a ``torch.distributed`` group, each rank runs the FULL-W2V pass
on its shard, table replicas are averaged every batch. The mesh composes
with window tiling (``tile_windows=4``): the host tile schedule is
per-sentence, so each rank consumes exactly its shard's ``plan_tiles``
rows. The port's counterpart of ``examples/distributed_w2v.py``.

    PYTHONPATH=src python examples/torch_distributed_w2v.py [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises without
one. Deliberate differences from the reference:

* the reference re-executes itself with 4 fake XLA host devices; the port
  starts 4 processes, one rank each (``repro_torch.launch.mesh.
  start_ranks``): NCCL when each rank can have a card of its own, else
  gloo (4 CPU ranks, or 4 ranks sharing one card); rank 0 prints; a
  CPU rank takes an equal share of the cores for torch's threads (each
  taking them all oversubscribes the cores many times over);
* ``--device`` (the reference has no flags);
* ``backend="auto"`` (the reference asks for ``jnp``, its compiled
  plain version): the window-tiled CUDA kernel (``cuda_tiled`` at T=4) on
  each rank's card, the plain tiled version (``torch_tiled``) on the CPU;
* one more line, ``backend=<name> device=<name>``;
* the initial tables come from a ``torch.Generator`` (the reference draws
  with ``jax.random``): :func:`run` takes ``init_tables`` to start from
  given tables instead, as the tests do with the reference's. Every rank
  computes the quality metrics of its own replica; :func:`run` returns
  them all.
"""
import argparse
import os


def rank_main(mesh, init_tables=None) -> dict:
    """One rank's session; rank 0 prints. Returns every rank's quality
    dict, rank 0's embeddings and the words per second."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.w2v import smoke
    from repro_torch.convert import params_from_reference
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus

    if mesh.device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    lead = mesh.rank == 0
    # tile_windows=4: mesh sharding x window tiling compose (per-shard
    # tile plans; Hogwild averaging unchanged)
    cfg = smoke(epochs=5, dim=32, sentences_per_batch=64, tile_windows=4)
    corpus = synthetic_cluster_corpus(n_clusters=8, words_per_cluster=16,
                                      n_sentences=800, mean_len=12, seed=0)
    pipe = BatchingPipeline(corpus, cfg)
    trainer = TrainSession(pipe, cfg, backend="auto", mesh=mesh)
    if init_tables is not None:
        trainer.state = params_from_reference(init_tables, trainer.device,
                                              mesh)
    if lead:
        name = (torch.cuda.get_device_name(trainer.device)
                if trainer.device.type == "cuda" else "cpu")
        print("backend:", trainer.backend)
        print(f"backend={trainer.backend} device={name} "
              f"ranks={mesh.size} collectives={mesh.backend}", flush=True)
    trainer.train()
    if lead:
        print(f"throughput: {trainer.words_per_sec:,.0f} words/s over "
              f"{mesh.size} devices", flush=True)
    inv = np.zeros(pipe.vocab.size, dtype=int)
    for w, i in pipe.vocab.ids.items():
        inv[i] = corpus.clusters[w]
    emb = trainer.embeddings()
    quality = evaluate(emb, inv)
    every = [None] * mesh.size
    dist.all_gather_object(every, quality, group=mesh.group)
    if lead:
        print("quality:", {k: round(v, 3) for k, v in quality.items()},
              flush=True)
    return {"quality": every, "embeddings": emb,
            "words_per_sec": trainer.words_per_sec,
            "backend": trainer.backend}


def run(device=None, ranks: int = 4, init_tables=None) -> dict:
    """Start ``ranks`` ranks on ``device`` and return rank 0's report."""
    from repro_torch.launch.mesh import start_ranks
    print("devices:", ranks, flush=True)
    return start_ranks(rank_main, ranks, device, init_tables)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda or cpu (default: the GPU; raises without "
                         "one)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
