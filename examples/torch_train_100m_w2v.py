"""End-to-end training on the PyTorch port (the paper's kind: embedding
training): a ~100M-parameter Word2Vec model (400k vocabulary x d=128 x
two tables) trained for a few hundred batches with checkpointing and the
full host batching pipeline. The port's counterpart of
``examples/train_100m_w2v.py``.

    PYTHONPATH=src python examples/torch_train_100m_w2v.py [--batches 200]
        [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises without
one. Deliberate differences from the reference:

* ``--device``;
* ``backend="auto"`` where the reference asks for ``jnp`` (its compiled
  plain version, since it ran on the CPU): the pipelined CUDA kernel
  (``cuda_pipelined``) on the GPU, the plain torch version (``torch``) on
  the CPU. Not the plain version everywhere: the plain version loops over
  the windows in Python, and on the card it costs about 10 s per 1,000
  sentences at this width (PERF.md §6), which would make a 200-batch run
  take hours;
* one more line, ``backend=<name> device=<name>``;
* the initial tables come from a ``torch.Generator`` (the reference draws
  with ``jax.random``): :func:`run` takes ``init_tables`` to start a fresh
  run from given tables instead (a resumed run keeps what it restored),
  as the tests do with the reference's, and returns the session.

The prefetch workers are threads (``W2VConfig.prefetch_mode``'s default,
as in the reference).
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.configs.w2v import W2VConfig
from repro_torch.convert import params_from_reference
from repro_torch.core.trainer import TrainSession
from repro_torch.data.corpus import synthetic_zipf_corpus
from repro_torch.data.prefetch import make_pipeline


def run(batches: int = 200, vocab: int = 400_000, ckpt_dir=None,
        prefetch_workers: int = 2, device=None, init_tables=None
        ) -> TrainSession:
    """Train (or resume) and print the reference's lines; returns the
    session."""
    cfg = W2VConfig(dim=128, window=5, negatives=5, epochs=1, min_count=1,
                    subsample_t=0.0, sentences_per_batch=512,
                    max_sentence_len=64, prefetch_workers=prefetch_workers)
    print("building corpus...")
    corpus = synthetic_zipf_corpus(vocab_size=vocab,
                                   n_sentences=batches * 512,
                                   mean_len=24, zipf_a=1.1, seed=0)
    pipe = make_pipeline(corpus, cfg)   # async when prefetch_workers > 0
    n_params = 2 * pipe.vocab.size * cfg.dim
    print(f"vocab={pipe.vocab.size:,} params={n_params / 1e6:.1f}M")

    ckpt_dir = ckpt_dir or os.path.join(tempfile.gettempdir(),
                                        "w2v_100m_ckpt")

    # TrainSession owns periodic checkpointing (atomic, pruned) and
    # resumes from the latest checkpoint in ckpt_dir automatically
    trainer = TrainSession(
        pipe, cfg, backend="auto", device=device, ckpt_dir=ckpt_dir,
        ckpt_every=50,
        on_metrics=lambda m: (m.batches_seen % 50 == 0) and print(
            f"  batch {m.batches_seen}: {m.words_seen:,} words "
            f"(checkpointed)"))
    if trainer.resumed_step is not None:
        print(f"resumed from checkpoint batch {trainer.resumed_step}")
    elif init_tables is not None:
        trainer.state = params_from_reference(init_tables, trainer.device)
    name = (torch.cuda.get_device_name(trainer.device)
            if trainer.device.type == "cuda" else "cpu")
    print(f"backend={trainer.backend} device={name}")
    t0 = time.time()
    trainer.train(max_batches=batches)
    print(f"trained {trainer.state.words_seen:,} words in "
          f"{time.time() - t0:.0f}s -> {trainer.words_per_sec:,.0f} words/s "
          f"(pipeline wait {trainer.pipeline_wait_frac:.0%} of it)")
    print("final checkpoint:", trainer.save_checkpoint())
    emb = trainer.embeddings()
    print("embedding norms: mean", float(np.linalg.norm(emb, axis=1).mean()))
    return trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=200)
    ap.add_argument("--vocab", type=int, default=400_000)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--prefetch-workers", type=int, default=2,
                    help="async host batching workers (0 = synchronous)")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the GPU; raises "
                         "without one)")
    args = ap.parse_args(argv)
    run(args.batches, args.vocab, args.ckpt_dir, args.prefetch_workers,
        args.device)


if __name__ == "__main__":
    main()
