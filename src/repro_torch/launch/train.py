"""End-to-end launcher of the torch port: FULL-W2V embedding training.

The ``w2v`` subcommand of ``repro.launch.train``, with the same flags and
defaults, on the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train w2v --vocab 65536 \\
      --sentences 30000 --sentences-per-batch 10000 --tile-windows 8

``--vocab-shard`` (one shard) and ``--hot-vocab-frac`` train with a
vocab-sharded table; ``--tables`` takes any storage spec on at most one
shard (``hot=bf16``, ``hot=bf16,cold=int8,shards=1,master=1``).
``--prefetch-workers/--prefetch-depth/--prefetch-mode`` run the async host
pipeline (``repro_torch.data.prefetch``), ``--ckpt-dir/--ckpt-every``
checkpoint and resume, and ``--max-restarts/--step-timeout/--health-every
/--reset-after`` train under the recovery supervisor
(``TrainSession.train_resilient``). Flags of features that arrive with
later slices of the port (other workloads, more than one vocab shard)
are accepted by the parser and exit with an error that says so.

The module imports no torch at top level: process prefetch workers import
the ``python -m`` module as their ``__mp_main__``.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
from typing import List, Optional

import numpy as np

WORKLOADS = ("w2v", "doc2vec", "node2vec", "subword")


def _tables_later_slice(tables: str) -> bool:
    """Whether a ``--tables`` spec needs a later slice: more than one
    shard (an unparsable spec is left to the session, which raises the
    parser's own error)."""
    from repro_torch.kernels.tables import parse
    try:
        spec = parse(tables)
    except ValueError:
        return False
    return spec.shards > 1


def _unsupported(args) -> Optional[str]:
    """The first flag naming a later slice's feature, or None."""
    checks = (
        (args.workload != "w2v", f"--workload {args.workload}"),
        (args.vocab_shard > 1,
         f"--vocab-shard {args.vocab_shard} (more than one shard needs the "
         f"data-parallel slice, ROADMAP item 7)"),
        (_tables_later_slice(args.tables),
         f"--tables {args.tables} (more than one shard of the "
         f"vocabulary, in f32 or mixed precision; ROADMAP item 8)"),
    )
    for bad, flag in checks:
        if bad:
            return flag
    return None


def run_w2v(args) -> int:
    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.corpus import synthetic_cluster_corpus
    from repro_torch.data.prefetch import AsyncBatchingPipeline, make_pipeline

    flag = _unsupported(args)
    if flag is not None:
        print(f"error: {flag} arrives with a later slice of the torch port; "
              f"run it with `python -m repro.launch.train` meanwhile",
              file=sys.stderr)
        return 2
    cfg = W2VConfig(dim=args.dim, epochs=args.epochs, min_count=1,
                    subsample_t=0.0, negatives=args.negatives,
                    window=args.window,
                    sentences_per_batch=args.sentences_per_batch,
                    max_sentence_len=args.max_sentence_len,
                    tile_windows=args.tile_windows,
                    tile_gemm_windows=args.tile_gemm_windows,
                    pad_len=args.pad_len,
                    prefetch_workers=args.prefetch_workers,
                    prefetch_depth=args.prefetch_depth,
                    prefetch_mode=args.prefetch_mode,
                    vocab_shard=bool(args.vocab_shard),
                    hot_vocab_frac=args.hot_vocab_frac,
                    tables=args.tables)
    # the w2v workload's corpus, built as repro.frontends' w2v frontend
    # builds it
    corpus = synthetic_cluster_corpus(
        n_clusters=args.clusters,
        words_per_cluster=max(args.vocab // args.clusters, 1),
        n_sentences=args.sentences, mean_len=24, seed=0)
    pipe = make_pipeline(corpus, cfg)
    print(f"workload=w2v vocab={pipe.vocab.size} "
          f"params={2 * pipe.table_rows * cfg.dim / 1e6:.1f}M "
          f"words/epoch={pipe.epoch_words}")
    if isinstance(pipe, AsyncBatchingPipeline):
        print(f"pipeline=async(workers={pipe.workers} depth={pipe.depth} "
              f"mode={pipe.mode})")
    else:
        print("pipeline=sync")
    trainer = TrainSession(pipe, cfg, backend=args.backend,
                           device=args.device, ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every)
    print(f"backend={trainer.backend} device={trainer.device}")
    if trainer.placement is not None:
        p = trainer.placement
        print(f"vocab_shard: hot={p.hot} cold={p.cold} shards={p.n_shards} "
              f"rows/device={p.rows_per_device} "
              f"(replicated would be {p.vocab_size})")
    if trainer.resumed_step is not None:
        print(f"resumed from checkpoint batch {trainer.resumed_step} "
              f"({trainer.state.words_seen:,} words seen)")
    resilient = (args.max_restarts > 0 or args.step_timeout > 0
                 or args.health_every > 0)
    if resilient:
        trainer.train_resilient(
            max_batches=args.max_batches,
            max_restarts=args.max_restarts or 3,
            step_timeout_s=args.step_timeout,
            health_every=args.health_every,
            reset_after=args.reset_after)
        r = trainer.last_report
        print(f"resilience: restarts={r.restarts} rollbacks={r.rollbacks} "
              f"health_failures={r.health_failures} timeouts={r.timeouts} "
              f"skipped={r.batches_skipped} "
              f"recovery_seconds={r.recovery_seconds:.3f}")
    else:
        trainer.train(max_batches=args.max_batches)
    if args.ckpt_dir:
        print("checkpoint:", trainer.save_checkpoint())
    steps = max(1, trainer.state.batches_seen - (trainer.resumed_step or 0))
    print(f"throughput: {trainer.words_per_sec:,.0f} words/sec "
          f"({trainer.state.words_seen:,} words) "
          f"device_busy_frac={trainer.device_busy_frac:.3f} "
          f"host_batching_s_per_step={pipe.stats.seconds / steps:.4f} "
          f"host_wait_s_per_step={trainer.fetch_seconds / steps:.4f}")
    # bit-exactness witness: identical configs print identical digests,
    # whatever the prefetch worker count or a resume in between
    import torch
    digest = hashlib.sha1()
    for part in trainer.state.params().values():
        digest.update(part.detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
    print(f"final_digest={digest.hexdigest()}")
    inv = np.zeros(pipe.vocab.size, dtype=int)
    for w, i in pipe.vocab.ids.items():
        inv[i] = corpus.clusters[w]
    metrics = evaluate(trainer.embeddings()[:pipe.vocab.size], inv)
    print("quality:", {k: round(v, 4) for k, v in metrics.items()})
    return 0


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.kernels import registry

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    sub = ap.add_subparsers(dest="mode", required=True)
    w = sub.add_parser("w2v")
    w.add_argument("--device", default=None,
                   help="cuda, cuda:N or cpu (default: the GPU; fails "
                        "without one)")
    w.add_argument("--workload", default="w2v", choices=WORKLOADS,
                   help="workload frontend (only w2v in this slice)")
    w.add_argument("--node2vec-p", type=float, default=1.0)
    w.add_argument("--node2vec-q", type=float, default=0.5)
    w.add_argument("--walk-length", type=int, default=40)
    w.add_argument("--walks-per-node", type=int, default=10)
    w.add_argument("--docs", type=int, default=64)
    w.add_argument("--subword-buckets", type=int, default=4096)
    w.add_argument("--vocab", type=int, default=8192)
    w.add_argument("--clusters", type=int, default=64)
    w.add_argument("--sentences", type=int, default=20000)
    w.add_argument("--dim", type=int, default=128)
    w.add_argument("--window", type=int, default=5)
    w.add_argument("--negatives", type=int, default=5)
    w.add_argument("--epochs", type=int, default=2)
    w.add_argument("--sentences-per-batch", type=int, default=2048)
    w.add_argument("--max-sentence-len", type=int, default=64)
    w.add_argument("--max-batches", type=int, default=None)
    w.add_argument("--tile-windows", type=int, default=1,
                   help="T: windows fused per kernel step")
    w.add_argument("--tile-gemm-windows", type=int, default=4,
                   help="G: windows per GEMM group inside a tile")
    w.add_argument("--pad-len", type=int, default=0,
                   help="padded batch length L (0: min(max-sentence-len, "
                        "1024))")
    w.add_argument("--prefetch-workers", type=int, default=0)
    w.add_argument("--prefetch-depth", type=int, default=2)
    w.add_argument("--prefetch-mode", default="thread",
                   choices=("thread", "process"))
    w.add_argument("--vocab-shard", type=int, nargs="?", const=1, default=0,
                   metavar="N")
    w.add_argument("--hot-vocab-frac", type=float, default=0.0)
    w.add_argument("--tables", default="")
    w.add_argument("--backend", default="auto",
                   choices=registry.cli_choices(),
                   help="kernel backend; 'auto' resolves per device and "
                        "tile-windows against the registry descriptors")
    w.add_argument("--ckpt-dir", default=None)
    w.add_argument("--ckpt-every", type=int, default=0)
    w.add_argument("--max-restarts", type=int, default=0)
    w.add_argument("--step-timeout", type=float, default=0.0)
    w.add_argument("--health-every", type=int, default=0)
    w.add_argument("--reset-after", type=int, default=0)
    w.set_defaults(fn=run_w2v)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
