"""End-to-end launcher of the torch port: FULL-W2V embedding training and
the LM substrate's training loop.

The ``w2v`` and ``lm`` subcommands of ``repro.launch.train``, with the
same flags and defaults, on the GPU unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train w2v --vocab 65536 \\
      --sentences 30000 --sentences-per-batch 10000 --tile-windows 8
  PYTHONPATH=src python -m repro_torch.launch.train lm \\
      --arch starcoder2-3b --smoke --steps 12 --batch 2 --seq 16

``lm`` runs ``repro_torch.train.loop.Trainer`` (AdamW with
``warmup_steps = max(steps // 20, 1)``, optional microbatches and
checkpoints) and prints ``final step N; loss a -> b``.

``--vocab-shard [N]`` and ``--hot-vocab-frac`` train with a
vocab-sharded table; ``--tables`` takes any storage spec (``hot=bf16``,
``hot=bf16,cold=int8,shards=2,master=1``). With N > 1 shards
(``--vocab-shard N`` or ``--tables ...,shards=N``) the command starts N
ranks, one process each (``repro_torch.launch.mesh.start_ranks``: NCCL
with a card per rank, else gloo), as the reference re-executes itself with
N host devices; rank 0 prints. ``--prefetch-workers/--prefetch-depth
/--prefetch-mode`` run the async host pipeline
(``repro_torch.data.prefetch``), ``--ckpt-dir/--ckpt-every`` checkpoint
and resume, and ``--max-restarts/--step-timeout/--health-every
/--reset-after`` train under the recovery supervisor
(``TrainSession.train_resilient``; with N ranks they vote on every
batch and roll back together). ``--workload`` takes
every frontend of ``repro_torch.frontends`` (``w2v``, ``doc2vec``,
``node2vec``, ``subword``), built from the reference's flags; doc2vec and
subword steps run the plain versions, which alone consume their doc rows
and bags. Data parallelism without vocab sharding has no flag, as in the
reference: it runs through ``TrainSession(mesh=...)``.

The module imports no torch at top level: process prefetch workers and
the ranks import the ``python -m`` module as their ``__mp_main__``.
"""
from __future__ import annotations

import argparse
import hashlib
import sys
from typing import List, Optional

import numpy as np


def _ranks(args) -> int:
    """The vocab shards the flags ask for, one rank each: ``--vocab-shard
    N`` or ``--tables ...,shards=N`` (an unparsable spec counts none; the
    session raises the parser's own error)."""
    from repro_torch.kernels.tables import parse
    try:
        shards = parse(args.tables).shards
    except ValueError:
        shards = 0
    return max(args.vocab_shard, shards, 1)


def run_w2v(args) -> int:
    n = _ranks(args)
    if n == 1:
        return train_rank(None, args)
    from repro_torch.launch.mesh import start_ranks
    return start_ranks(train_rank, n, args.device, args)


def train_rank(mesh, args) -> int:
    """Train on this rank of ``mesh`` (``None``: the only process); rank
    0 prints."""
    from repro_torch import frontends
    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.prefetch import AsyncBatchingPipeline, make_pipeline

    def say(*a) -> None:
        if mesh is None or mesh.rank == 0:
            print(*a, flush=True)

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
    # every workload rides the same engine: the frontend adapts a corpus
    # (words, graph walks, documents, subword bags) into the batch schema
    # and attaches its table extras to the pipeline (DESIGN.md §12)
    workload = frontends.get(args.workload).build(
        cfg, vocab=args.vocab, clusters=args.clusters,
        sentences=args.sentences,
        p=args.node2vec_p, q=args.node2vec_q,
        walk_length=args.walk_length, walks_per_node=args.walks_per_node,
        docs=args.docs, buckets=args.subword_buckets, seed=0)
    cfg, corpus = workload.cfg, workload.corpus
    pipe = make_pipeline(corpus, cfg)
    workload.attach(pipe)
    extras = (f" (+{pipe.extra_rows} {args.workload} rows)"
              if pipe.extra_rows else "")
    say(f"workload={args.workload} vocab={pipe.vocab.size}{extras} "
        f"params={2 * pipe.table_rows * cfg.dim / 1e6:.1f}M "
        f"words/epoch={pipe.epoch_words}")
    if isinstance(pipe, AsyncBatchingPipeline):
        say(f"pipeline=async(workers={pipe.workers} depth={pipe.depth} "
            f"mode={pipe.mode})")
    else:
        say("pipeline=sync")
    trainer = TrainSession(pipe, cfg, backend=args.backend,
                           device=args.device, mesh=mesh,
                           ckpt_dir=args.ckpt_dir,
                           ckpt_every=args.ckpt_every)
    say(f"backend={trainer.backend} device={trainer.device}")
    if trainer.spec.is_mixed:
        s = trainer.spec
        say(f"tables: hot={s.hot_dtype} cold={s.cold_dtype} "
            f"master_copy={s.master_copy}")
    if trainer.placement is not None:
        p = trainer.placement
        ranks = ("" if mesh is None else
                 f"ranks={mesh.size} backend={mesh.backend} ")
        say(f"vocab_shard: hot={p.hot} cold={p.cold} shards={p.n_shards} "
            f"{ranks}rows/device={p.rows_per_device} "
            f"(replicated would be {p.vocab_size})")
    if trainer.resumed_step is not None:
        say(f"resumed from checkpoint batch {trainer.resumed_step} "
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
        say(f"resilience: restarts={r.restarts} rollbacks={r.rollbacks} "
            f"health_failures={r.health_failures} timeouts={r.timeouts} "
            f"skipped={r.batches_skipped} "
            f"recovery_seconds={r.recovery_seconds:.3f}")
    else:
        trainer.train(max_batches=args.max_batches)
    if args.ckpt_dir:
        say("checkpoint:", trainer.save_checkpoint())
    steps = max(1, trainer.state.batches_seen - (trainer.resumed_step or 0))
    say(f"throughput: {trainer.words_per_sec:,.0f} words/sec "
        f"({trainer.state.words_seen:,} words) "
        f"device_busy_frac={trainer.device_busy_frac:.3f} "
        f"host_batching_s_per_step={pipe.stats.seconds / steps:.4f} "
        f"host_wait_s_per_step={trainer.fetch_seconds / steps:.4f}")
    # bit-exactness witness: identical configs print identical digests,
    # whatever the prefetch worker count or a resume in between; a sharded
    # mesh hashes the gathered tables (a collective on every rank)
    import torch
    digest = hashlib.sha1()
    for part in trainer.gathered_params().values():
        digest.update(part.detach().cpu().contiguous().view(torch.uint8)
                      .numpy().tobytes())
    say(f"final_digest={digest.hexdigest()}")
    emb = trainer.embeddings()          # a collective on a sharded mesh
    if corpus.clusters is not None and (mesh is None or mesh.rank == 0):
        inv = np.zeros(pipe.vocab.size, dtype=int)
        for w, i in pipe.vocab.ids.items():
            inv[i] = corpus.clusters[w]
        # frontend extras (doc rows, n-gram buckets) sit past the
        # vocabulary: cluster quality is a word/node-vector property
        metrics = evaluate(emb[:pipe.vocab.size], inv)
        say("quality:", {k: round(v, 4) for k, v in metrics.items()})
    return 0


def run_lm(args) -> int:
    """The ``lm`` subcommand: the reference's LM ``Trainer`` run, on the
    port's ``Trainer`` on ``--device``."""
    from repro_torch.configs.base import get_arch, get_smoke
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optim import AdamWConfig

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    loop = LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      microbatches=args.microbatches)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    trainer = Trainer(cfg, opt, loop, batch=args.batch, seq=args.seq,
                      device=args.device)
    out = trainer.train()
    losses = out["losses"]
    print(f"final step {out['final_step']}; loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    return 0


def build_parser() -> argparse.ArgumentParser:
    from repro_torch import frontends
    from repro_torch.kernels import registry

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    sub = ap.add_subparsers(dest="mode", required=True)
    w = sub.add_parser("w2v")
    w.add_argument("--device", default=None,
                   help="cuda, cuda:N or cpu (default: the GPU; fails "
                        "without one)")
    w.add_argument("--workload", default="w2v", choices=frontends.names(),
                   help="workload frontend (DESIGN.md §12): plain w2v, "
                        "node2vec random walks, PV-DM doc2vec, or "
                        "fastText-style subword bags")
    w.add_argument("--node2vec-p", type=float, default=1.0,
                   help="node2vec return parameter (1/p weight on "
                        "backtracking to the previous node)")
    w.add_argument("--node2vec-q", type=float, default=0.5,
                   help="node2vec in-out parameter (1/q weight on "
                        "exploring away; q<1 favors communities)")
    w.add_argument("--walk-length", type=int, default=40,
                   help="node2vec: nodes per walk")
    w.add_argument("--walks-per-node", type=int, default=10,
                   help="node2vec: walks started from each node")
    w.add_argument("--docs", type=int, default=64,
                   help="doc2vec: number of synthetic documents")
    w.add_argument("--subword-buckets", type=int, default=4096,
                   help="subword: hashed n-gram bucket rows appended past "
                        "the vocabulary")
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

    l = sub.add_parser("lm")
    l.add_argument("--device", default=None,
                   help="cuda, cuda:N or cpu (default: the GPU; fails "
                        "without one)")
    l.add_argument("--arch", required=True)
    l.add_argument("--smoke", action="store_true")
    l.add_argument("--steps", type=int, default=100)
    l.add_argument("--batch", type=int, default=8)
    l.add_argument("--seq", type=int, default=128)
    l.add_argument("--lr", type=float, default=3e-4)
    l.add_argument("--microbatches", type=int, default=1)
    l.add_argument("--ckpt-dir", default=None)
    l.add_argument("--ckpt-every", type=int, default=50)
    l.set_defaults(fn=run_lm)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
