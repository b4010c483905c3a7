"""Quickstart on the PyTorch port: train FULL-W2V embeddings on a
synthetic clustered corpus, then inspect nearest neighbours and quality
metrics. The port's counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises without
one. Deliberate differences from the reference:

* ``--device`` (the reference has no flags);
* ``backend="auto"`` resolves against the device: the pipelined CUDA
  kernel (``cuda_pipelined``, through its runtime-shaped body at the
  smoke config's d=32, W=3, N=3) on the GPU, the plain torch version
  (``torch``) on the CPU;
* one more line, ``backend=<name> device=<name>``;
* the initial tables come from a ``torch.Generator`` (the reference draws
  with ``jax.random``): :func:`run` takes ``init_tables`` to start from
  given tables instead, as the tests do with the reference's.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.w2v import smoke
from repro_torch.convert import params_from_reference
from repro_torch.core.quality import evaluate
from repro_torch.core.trainer import TrainSession
from repro_torch.data.batching import BatchingPipeline
from repro_torch.data.corpus import synthetic_cluster_corpus


def run(device=None, init_tables=None) -> dict:
    """Train, print the reference's lines, and return the session, the
    quality dict and the neighbour ids of words 0, 20 and 40."""
    cfg = smoke(epochs=8, dim=32)
    corpus = synthetic_cluster_corpus(n_clusters=8, words_per_cluster=16,
                                      n_sentences=800, mean_len=12, seed=0)
    pipe = BatchingPipeline(corpus, cfg)
    print(f"vocab={pipe.vocab.size} words/epoch={pipe.epoch_words}")

    # backend="auto" resolves against the device (cuda_pipelined on the
    # GPU, torch on the CPU); on_metrics streams per-batch progress
    trainer = TrainSession(
        pipe, cfg, backend="auto", device=device,
        on_metrics=lambda m: (m.batches_seen % 40 == 0) and print(
            f"  epoch {m.epoch} batch {m.batches_seen}: "
            f"{m.words_seen:,} words, lr={m.lr:.4f}"))
    if init_tables is not None:
        trainer.state = params_from_reference(init_tables, trainer.device)
    name = (torch.cuda.get_device_name(trainer.device)
            if trainer.device.type == "cuda" else "cpu")
    print(f"backend={trainer.backend} device={name}")
    trainer.train()
    print(f"throughput: {trainer.words_per_sec:,.0f} words/sec "
          f"(backend={trainer.backend})")

    # ground-truth clusters mapped through vocab ids
    inv = np.zeros(pipe.vocab.size, dtype=int)
    for w, i in pipe.vocab.ids.items():
        inv[i] = corpus.clusters[w]
    quality = evaluate(trainer.embeddings(), inv)
    print("quality:", {k: round(v, 3) for k, v in quality.items()})

    neighbours = {}
    for wid in (0, 20, 40):
        nn = neighbours[wid] = trainer.nearest(wid, k=4)
        print(f"word {wid} (cluster {inv[wid]}) -> neighbours "
              f"{[(int(n), int(inv[n])) for n in nn]}")
    return {"session": trainer, "quality": quality, "neighbours": neighbours}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the GPU; raises "
                         "without one)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
