#!/usr/bin/env python3
"""Time the port's CUDA kernels and its T=1 trainer in two source trees on
one GPU, in turns (A, B, B, A), so that two versions are compared on the
same card in the same call.

    python3 tools/torch_kernel_ab.py --tree build/parent --tree . \
        [--sentences-per-batch 10000] [--batches 3] [--seed 0] [--rounds 1]

Each turn is a fresh process that imports ``repro_torch`` from
``<tree>/src`` (its kernels build into ``<tree>/build/``) and measures, at
the paper's width (d=128, W=5 so w_f=3, N=5, the 65,536-word cluster
corpus of ``chip_smoke.py``):

* the T=1 and the T=8 ``auto`` trainers (``TrainSession`` on the
  synchronous pipeline: K2, then K3): seconds per step, words per second,
  host batching seconds per step (the pipeline's busy seconds), the step
  loop's wait on the host per step (``fetch_seconds``: batching plus the
  lift onto the card) and ``pipeline_wait_frac``, over ``--batches``
  batches;
* K1 (``cuda``) and K2 (``cuda_pipelined``) on the trainer's first batch,
  K3 (``cuda_tiled``, T=8, G=4) on the T=8 pipeline's first batch and K4
  (the split-table ``update_fused``) on the one-shard vocab-sharded
  pipeline's first batch: ms per launch (CUDA events, mean of ``--reps``
  launches after one warm-up), µs per window, and the sha256 of the
  tables after one launch from tables drawn from a generator seeded with
  0 (the same in every tree, so equal digests mean the same bits).

``--rounds R`` repeats the four turns R times. Each turn prints one JSON
line; the parent prints them and, last, one JSON
object with every turn and the card's name and power limit (nvidia-smi).
Needs a CUDA device; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time


def measure(tree: str, S: int, batches: int, seed: int, reps: int) -> dict:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    import repro_torch
    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus
    from repro_torch.distributed.vocab_placement import (VocabPlacement,
                                                         plan_exchange)
    from repro_torch.kernels import _build, fullw2v, ops, registry

    if not os.path.abspath(repro_torch.__file__).startswith(
            os.path.abspath(tree)):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {tree}")
    t0 = time.perf_counter()
    lib = _build.load()
    build_s = time.perf_counter() - t0
    corpus = synthetic_cluster_corpus(
        n_clusters=64, words_per_cluster=65536 // 64,
        n_sentences=S * batches, mean_len=24, seed=seed)

    def config(tile, **kw):
        return W2VConfig(dim=128, window=5, negatives=5, epochs=1,
                         min_count=1, subsample_t=0.0,
                         sentences_per_batch=S, max_sentence_len=64,
                         tile_windows=tile, tile_gemm_windows=4, seed=seed,
                         **kw)

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    out = {"tree": tree, "build_s": build_s, "built": lib.built}
    # the T=1 and T=8 auto trainers
    for key, tile in (("trainer", 1), ("trainer_t8", 8)):
        cfg = config(tile)
        sess = TrainSession(BatchingPipeline(corpus, cfg), cfg,
                            device="cuda")
        sess.train(max_batches=batches)
        torch.cuda.synchronize()
        n = sess.state.batches_seen
        out[key] = {"backend": sess.backend, "batches": n,
                    "s_per_step": sess.wall_seconds / n,
                    "words_per_s": sess.words_per_sec,
                    "host_batching_s_per_step":
                        sess.pipeline.stats.seconds / n,
                    "host_wait_s_per_step": sess.fetch_seconds / n,
                    "pipeline_wait_frac": getattr(
                        sess, "pipeline_wait_frac", None)}

    def tables(rows, d):
        gen = torch.Generator(device="cuda").manual_seed(0)
        return [(torch.rand((rows, d), generator=gen, device="cuda") - 0.5)
                / d for _ in range(2)]

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    kernels = {}
    for tile, names in ((1, ("cuda", "cuda_pipelined")), (8, ("cuda_tiled",))):
        cfg = config(tile)
        pipe = BatchingPipeline(corpus, cfg)
        batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
        step = batch.step_inputs(cfg.lr, torch.device("cuda"))
        static = ops.static_for(cfg, step.tile)
        windows = int(batch.lengths.sum())
        for name in names:
            be = registry.get(name)
            w_in, w_out = tables(pipe.table_rows, cfg.dim)
            be.update(w_in, w_out, step, static)
            sha = digest(w_in, w_out)
            if hasattr(fullw2v, "SEQ_LAUNCHES"):
                fullw2v.reset_launch_counts()
            ms = time_ms(lambda: be.update(w_in, w_out, step, static))
            kernels[name] = {"ms": ms, "us_per_window": ms * 1e3 / windows,
                             "windows": windows, "sha256": sha}
            for counts in ("SEQ_LAUNCHES", "TILED_LAUNCHES"):
                took = [k for k, v in getattr(fullw2v, counts, {}).items()
                        if v]
                if took:
                    kernels[name]["instantiation"] = took[0]
    # K4 on the sharded pipeline's first batch (one shard, default head)
    cfg = config(8, vocab_shard=True)
    pipe = BatchingPipeline(corpus, cfg)
    pl = VocabPlacement.plan(pipe.vocab.counts, 1)
    pipe.placement = pl
    batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    ex = batch.exchange if batch.exchange is not None else \
        plan_exchange(batch, pl)
    step = ex.step_inputs(cfg.lr, torch.device("cuda"))
    static = ops.static_for(cfg, step.tile)
    full = [t.cpu().numpy() for t in tables(pipe.table_rows, cfg.dim)]
    (hot_in, cold_in), (hot_out, cold_out) = (
        [torch.from_numpy(a).cuda() for a in pl.split(t)] for t in full)
    run = ops._VocabShardedRun("cuda_tiled", static, pl, exchange="exact")
    route = run.route(step)
    got_in, got_out = run.gather(route, cold_in), run.gather(route, cold_out)
    args = (step.tokens, step.negs, step.lengths, step.lr, static.w_f,
            static.tile, step.plan_uniq, step.plan_scatter, step.plan_ucount,
            step.plan_strict)
    windows = int(batch.lengths.sum())
    parts = [t.clone() for t in (hot_in, hot_out, got_in, got_out)]
    fullw2v.fullw2v_cuda_tiled_fused(*parts, *args,
                                     gemm_windows=static.gemm_windows)
    sha = digest(*parts)
    ms = time_ms(lambda: fullw2v.fullw2v_cuda_tiled_fused(
        hot_in, hot_out, got_in, got_out, *args,
        gemm_windows=static.gemm_windows))
    kernels["cuda_tiled_fused"] = {"ms": ms, "windows": windows,
                                   "us_per_window": ms * 1e3 / windows,
                                   "sha256": sha}
    out["kernels"] = kernels
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="source tree (give two: A then B)")
    ap.add_argument("--sentences-per-batch", dest="S", type=int,
                    default=10_000)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the turns A, B, B, A this many times")
    ap.add_argument("--measure", action="store_true",
                    help=argparse.SUPPRESS)     # one turn, in this process
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; this script times the GPU kernels",
              file=sys.stderr)
        return 1
    if args.measure:
        print(json.dumps(measure(args.tree[0], args.S, args.batches,
                                 args.seed, args.reps)), flush=True)
        return 0
    if len(args.tree) != 2:
        ap.error("give --tree twice: A, then B")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    a, b = args.tree
    turns = []
    order = [a, b, b, a] * args.rounds
    for tree in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--measure",
             "--tree", tree, "--sentences-per-batch", str(args.S),
             "--batches", str(args.batches), "--seed", str(args.seed),
             "--reps", str(args.reps)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        turn = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(turn), flush=True)
        turns.append(turn)
    print(json.dumps({"card": smi, "order": order, "turns": turns}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
