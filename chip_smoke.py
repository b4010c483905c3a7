#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, trains through the port's
main path and times the kernels.

    python3 chip_smoke.py [--seed 0] [--sentences-per-batch 10000]

About 14-18 min on an H100, most of it in the host batching of the
training phases and in the plain versions of phases 5 and 11.

Phases (each prints one line; any failure raises and the script exits
non-zero):

1. device   — the card's name and power limit (nvidia-smi).
2. build    — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``.
3. parity   — ``cuda``, ``cuda_pipelined``, ``cuda_tiled`` (T=8, G=4,
              some strict tiles) and ``cuda_tiled_fused`` (K4, the same
              batch on the table split at hot=V/4) against their plain
              versions on the card (atol 2e-5, rtol 1e-4, the JAX
              package's kernel tolerance); K2 == K1, K3(T=1) == K1, K3
              with prefetch == K3 without and K4 == K3 on concat(hot,
              got) bit for bit; K1 and K2 once more at a shape outside
              the compiled list (w_f=4, N=7), and K3 at T=6, G=4, both
              on the runtime-shaped bodies; then K1 and K2 at the
              quickstart and serve examples' smoke shape (d=32, w_f=2,
              N=3) and K3 at the distributed example's (the same at T=4,
              one rank's 16 sentences), each on the first batch of the
              examples' cluster corpus, each launch on the runtime body.
4. trainer  — ``TrainSession`` with ``backend="auto"`` on the card at the
              paper's width (d=128, W=5 so w_f=3, N=5, S=10,000 sentences
              per batch, 65,536-word cluster corpus, 3 batches): T=1 must
              resolve to ``cuda_pipelined``, T=8 to ``cuda_tiled``; a third
              run asks for ``cuda`` by name; a fourth shards the vocabulary
              (one shard, T=8) and must launch K4 once per batch and K3
              never, and end with embeddings bit-identical to the
              replicated T=8 run's. Launch counts are zeroed before each
              run and read after it; the T=1 runs must have gone through
              K1/K2's compiled instantiation for their shape, the T=8 runs
              through K3/K4's.
5. timing   — each kernel on the trainer's first batch (the main path's
              shapes; for K4 the sharded run's first batch, with the
              exchange timed apart): each against its plain version on
              the batch's first 1,000 sentences (their own tile and
              exchange plans; the plain versions loop in Python; K3's on
              the whole batch took 64.8-86.0 s on an H100), with K2 ==
              K1 == K3(T=1) bit for bit on the whole batch (and K4 == K3
              at phase 4); then timed (CUDA events) on the whole batch
              beside its
              bound and the plain version's time on the sentences it
              held, in ms per launch and µs per window; one JSON line
              lists them. For K3/K4 also the batch's strict-tile share,
              its mean unique rows per tile, and the columns the
              cross-tile prefetch took and rejected (the kernel's device
              counters, held against the host's count from the plan).
              One line gives ``plan_costs`` of the T=1 and T=8 batches
              (row moves and GEMMs a window, the T=8 reduction) beside
              K1-K3's ms and the card; the deprecated
              ``ops.sgns_update`` must equal ``ops.step`` (K2) bit for
              bit on the T=1 batch.
6. prefetch — the main path again through the async host pipeline on
              phase 4's corpus: T=1 ``auto`` with 2 and 4 thread workers
              and 2 process workers, T=8 ``auto`` with 2 thread and 2
              process workers; each must launch its phase-4 kernel once
              per batch and end with phase 4's synchronous tables bit for
              bit. Prints words/s, s per step, the steady step cadence
              after the first batch, host batching (the produce and
              finalize busy seconds) and host wait per step, the first
              batch's wait, ``pipeline_wait_frac`` (the share of the wall
              time blocked on the pipeline), the queue's mean ready depth
              and its high-water mark.
7. resume   — T=1 ``auto`` and the T=8 vocab-sharded session (K4), each
              with 2 process workers and a checkpoint every batch: 2
              batches, the session dropped, a new one on the same
              directory resumes at batch 2 (``skip_batches`` 2) and
              trains the third, bit-identical to phase 4's run; the
              sharded checkpoint at batch 2 also restores into a
              replicated T=8 session, whose third batch gives phase 4's
              replicated tables bit for bit. Prints save and restore ms
              per checkpoint and its bytes.
8. chaos    — ``repro_torch.train.chaos.run_chaos`` with the ``heal``
              schedule (two failed steps, a killed process worker, a
              truncated newest checkpoint, NaN in ``w_in``) at d=128, T=1
              ``auto``, 2 process workers, at phase 4's S: the faulted
              run must end with the fault-free run's digest, every fault
              fired, at least one pool heal and one quarantined
              checkpoint. Prints the report and the health probe's cost
              per batch.
9. mixed    — mixed-precision tables (bf16 and int8 storage with keyed
              stochastic rounding). ``encode_stochastic`` for bf16 and int8
              on a (V, 128) f32 table on the card must give the CPU run's
              bytes. Then 3 batches at phase 4's shapes for each of
              ``hot=bf16`` T=1 (K2), ``hot=bf16`` T=8 (K3),
              ``hot=bf16,cold=bf16,shards=1`` T=8 (K4) and
              ``hot=bf16,cold=int8,shards=1,master=1`` T=8 (K4, the f32
              master copy): a first run of one batch holds every stochastic
              encode of the step (its f32 input: the kernel's output on the
              card) against the CPU codec's bytes; the 3-batch run must
              launch its kernel once per batch and prints words/s, s per
              step, the codec's ms per step (CUDA events around each decode
              and encode inside the step) and the tables' device bytes
              against f32. The int8 run resumes from a checkpoint bit for
              bit (as phase 7). Last, the reference's quality gate on the
              card: bench_quality's shape (d=64, S=128, L=48, 8 clusters of
              16 words, 8 epochs), ``hot=bf16:frac=0.1,cold=int8,shards=1,
              master=1`` (K1) against f32 (K2) on the same batches; the
              separation ratio must lie in 1.00 ± 0.01.
10. mesh    — ranks of ``repro_torch.launch.mesh.start_ranks`` on the one
              card over gloo (NCCL refuses two ranks on one device); they
              time-slice it, so no scaling shows. N=2: (a) each collective
              on CUDA tensors (f32, bf16, int8) against its numpy
              definition; (b) data parallelism at phase 4's shapes (5,000
              sentences a rank, 3 batches), T=1 (K2) and T=8 (K3): each rank
              launches its kernel once per batch, the replicas hash alike
              after every batch, and batch 1 equals, bit for bit, the mean
              of the kernel launched in one process on each rank's block;
              (c) vocab sharding, T=8 exact and dense (K4) and T=1 (K1): the
              head bit for bit against (b) at the same T, the tail within
              atol 1e-6 / rtol 1e-5 (DESIGN.md §8), exact against dense by
              the same rule; (d) ``hot=bf16,cold=bf16,shards=2`` and
              ``hot=bf16,cold=int8,shards=2,master=1`` (K4) at T=8: the heads
              hash alike on every rank, each 2-rank checkpoint restores bit
              for bit (embeddings) into a one-shard single-process session of
              the same storage and into a replicated f32 session, and a
              rerun of the int8 run ends with the same digest (the
              owner-side merge's fixed order). N=4 (e), at reduced depth
              (S=2,000, 2 batches): a data-parallel and an f32 exact sharded
              T=8 run under the same rules. Prints each rank's kernel ms
              (CUDA events; a span includes the other ranks' slices), each
              collective's ms per step (host clock between synchronizes), s
              per step, words/s and host batching per step.
11. frontends — the workload frontends of ``repro_torch.frontends`` at the
              paper's widths. node2vec on the kernels: 16,384 walks
              (``community_graph(256, 32)``, 2 walks a node of 40 steps,
              p=1, q=0.5) built once, one epoch at S=10,000 through
              ``TrainSession``: T=1 ``auto`` (K2), T=8 ``auto`` (K3),
              sharded T=1 (K1) and sharded T=8 (K4), each launching its
              kernel once per batch; each kernel against its plain version
              on the first 256 walks of the first batch (atol 2e-5, rtol
              1e-4); the T=8 run again with 2 thread workers (same digest);
              a 2-rank gloo run, sharded exact T=8 (K4), twice (same
              digest). doc2vec (2,048 documents of 24 sentences, S=250)
              and subword (65,536 words, 2,000,000 n-gram rows, S=125) run
              one batch each at T=1 and T=8 on the plain versions
              (``torch``, ``torch_tiled``: no kernel consumes doc rows or
              bags), tables on the card, a rerun with the same digest. Last,
              the pWord2Vec-like baseline (``core.baselines.matrix_sgns``)
              beside K2 at ``bench_quality``'s shape (4 epochs): their
              separation ratio, no gate.

12. serve   — the serving stack (``repro_torch.serve``; no kernel: the
              scores are one f32 ``torch.matmul`` with TF32 off, the
              ranking plain torch). (a) Checkpoints of phase 4's T=1 auto
              session (K2, replicated), its one-shard T=8 session (K4,
              split) and phase 9's int8 session, each loaded by
              ``EmbeddingIndex.load`` on the card and indexed live by
              ``from_session``: nn and analogy top-10 of 256 random ids
              plus the hot/cold boundary ids, ids equal to ``dense_topk``
              on the card and to the live index, scores within 1e-6; a
              float64 host recompute within 1e-5 (ids equal but at near
              ties under 1e-6, counted); the int8 tail decoded on the
              card equals the CPU's bit for bit. (b) A seeded 2,000,000 ×
              128 table (hot 10%) behind ``EmbeddingServer`` at batch 32
              and 256 (deadline 2 ms, k=10) from 8 client threads, 2,000
              nn queries each: qps, p50/p99 µs, device ms per batch (CUDA
              events) beside its bound, and the product, the ranking key
              and ``torch.topk`` timed apart; a second publish
              hot-swapped under load (stage ms, swap ms, p99 during it);
              16 answers against the f64 host oracle. (c) ``run_serve_chaos`` with
              the ``ci`` schedule and at d=128, V=65,532, 2 shards: no
              dropped, torn or failed query, every crash fired, the last
              publish served. (d) 2 and 4 gloo ranks on the card serve
              (a)'s split checkpoint re-striped, rank 0's server with
              followers: every answer equals the one-rank run's; a
              publish swaps on every rank, one that rank 1 alone fails to
              load on none. (e) ``python -m repro_torch.launch.serve
              --check-oracle`` on (a)'s split checkpoint.

13. mesh chaos — supervised recovery under a mesh: 2 gloo ranks on the
              card, d=128, S=2,000 (phase 10's N=4 size), ~5 batches an
              epoch, 2 process workers a rank; ``run_chaos`` on the mesh
              with the ``ci`` schedule, its failed steps, worker kill and
              NaN on rank 1 and the truncation from rank 0: data-parallel
              T=1 (auto, K2) and vocab-sharded exact T=8 (auto, K4, the
              NaN in rank 1's cold block). Gates: the faulted run's
              gathered digest equals the fault-free 2-rank run's, every
              fault fired, the reports are equal on both ranks, the
              truncated checkpoint was quarantined, and each rank launched
              its kernel once per batch of both runs (replays included).
              Prints each rank's vote ms (one vote a batch and one a
              restore; host clock, waiting for the other rank included:
              the mean, a batch vote's median and maximum, a restore
              vote's mean), probe ms per batch, recovery s, wall s and
              launches. Then the
              train CLI on 2 ranks with ``--vocab-shard 2 --max-restarts 3
              --health-every 1 --ckpt-dir ... --ckpt-every 2`` must print
              the plain run's ``final_digest``.
14. lm      — the LM substrate (``repro_torch.models``, no kernel: plain
              torch products, f32 with TF32 off) at the published widths
              of qwen3-8b, moonshot-v1-16b-a3b and mamba2-1.3b, depth cut
              to 2 layers, parameters from a seeded ``torch.Generator`` on
              the card, B=1, S=512: ``forward``, ``lm_loss`` with its
              backward (every gradient finite), ``prefill`` and 16
              ``decode_step``s, each timed (CUDA events) beside its bound
              (2 FLOPs per product parameter and token at the f32 peak;
              a decode token's product-parameter bytes at the memory
              rate), tokens/s and peak memory. Gates: prefill + decode at
              an f32 cache equal ``forward``'s logits at those positions
              (relative error under 1e-4; for the MoE at a capacity that
              drops no token), and the CPU on the same parameters at 32
              tokens gives the card's logits within 1e-4 relative, and
              for the MoE the same routing indices; ``compress_tree`` of
              a 4M-element f32 tree gives the CPU's int8 bytes and scales.
15. lm-train — LM training (``repro_torch.train.loop.Trainer``, AdamW,
              f32 with TF32 off; no kernel). (a) ``python -m
              repro_torch.launch.train lm --arch starcoder2-3b --smoke
              --steps 12 --batch 2 --seq 16`` on the card, a process
              started at the phase's start and read before (c): exit 0,
              12 steps, finite losses (its first and last loss printed;
              with random tokens whether the last is lower depends on the
              draw). ``tests/test_train_loop.py``'s Trainer at smoke size:
              12 steps on one fixed batch lose more than 0.5 nats (the
              stream's first- and last-three means are printed), a
              checkpointed 6-step run resumes at 6 and ends at 10,
              failures at steps 5 and 9 recover to 12 with finite losses,
              one without checkpoints ends at 6. (b) The first Trainer
              step of the smoke configs of phase 14's three archs on the
              card from the CPU Trainer's parameters: the loss within 1e-5
              relative of the CPU's, every parameter within the sign-flip
              bound 2·lr·(1 + wd·max|p|) (Adam's first update is about
              lr·sign(g)), 99.9% of each leaf's entries within 1e-6 +
              1e-5·|p|. (c) Phase 14's 2-layer cuts at published width:
              two Trainers at B=2, S=512 with microbatches 1 and 2 give
              one first loss within 1e-5 relative and, after that step,
              parameters held as in (b) (the MoE at a capacity that drops
              no token, as in phase 14); a Trainer at B=1, S=512 takes 4
              steps,
              steps 2-4 timed (CUDA events) with the AdamW update timed
              apart, beside the bound (phase 14's forward+backward bound
              plus 28 optimizer bytes a parameter at the memory rate),
              tokens/s and peak memory; the losses finite; then one more
              step, untimed, under ``repro_torch.launch.roofline``'s
              count for phase 16.
16. lm-ep   — (a) the MoE's expert parallelism at moonshot-v1-16b-a3b's
              published width (d=2048, 64 experts top-6, ff=1408,
              capacity factor 1.25, so tokens drop; B=1, S=512; f32, TF32
              off) on 2 gloo ranks sharing the card as a (model=2) mesh,
              32 experts a rank: the block's forward and the backward of
              sum(out·w) through ``moe_block`` under the rules, against
              the card's one-process local path with every expert (the
              output within 3·2^-8 of the largest partial or output
              entry: the bf16 roundings of the 2 partials and of their
              sum; every gradient within 3·2^-8 of its largest entry: the
              cotangent's bf16 rounding) and against the same ranks'
              expert parallelism on the CPU (a gloo group over the same
              ranks; at least 99.9% of the output's entries equal bit for
              bit and all within 3 bf16 ulps of the CPU's (ulps of the
              entry's largest rounded operand, a partial or the sum: each
              of the 2 partials may round to its neighbour, and the sum's
              rounding may add one more; plus 1e-5 of the largest
              partial, the f32 partials' own difference where a partial
              cancels to near 0), except on tokens the two hosts route otherwise (a
              near tie of the k-th and (k+1)-th gates, under 1e-6 apart,
              which their f32 logits order differently) or keep
              otherwise with them, at most 4 tokens; every
              gradient within 2^-8 of its largest entry); some token must
              drop; ms per forward+backward per rank (CUDA events, 3
              after a warm-up) and the sum's ms (host clock around the
              rank-order sum of the partials, an all-to-all and an
              all-gather): the ranks time-slice one card, so
              no scaling shows. (b) Phase 15's counted step of each
              2-layer cut: the counted FLOPs (``FlopCounterMode``:
              matmul-class ops only) beside phase 14's analytic product
              FLOPs, and their time at the f32 rate beside the measured
              step. (c) ``python -m repro_torch.launch.dryrun`` on
              qwen3-8b's ``train_4k`` and ``decode_32k`` on the single-pod
              fake mesh (the host's CPU; processes started at the phase's
              start): a ``status: "ok"`` record each with finite terms (a
              model on H100 constants, not a measurement).
17. lm-tp   — tensor-parallel compute (``repro_torch.launch.steps`` on
              local shards over ``model``; no kernel) of qwen3-8b's and
              mamba2-1.3b's 2-layer cuts at published width (f32, TF32
              off, B=1, S=512) on 2 gloo ranks sharing the card as a
              (data=1, model=2) mesh: a train step, a prefill and a
              decode token through ``build_cell``'s cells (the decode
              from one process's prefill cache with 16 free slots), each
              timed (CUDA events), then run once more under a spy that
              times every c10d collective (host clock between
              synchronizes) and counts DTensor's functional collectives;
              peak memory a rank. Against one process on the card from
              the same seeded parameters and tokens (rank by rank, the
              other rank waiting with its memory freed): the loss within
              1e-5 relative, every parameter block within the sign-flip
              bound 2·lr·(1 + wd·max|p|) and 99.9% of each leaf within
              1e-6 + 1e-5·|p|; each rank's block of the prefill logits
              within 1e-4 of the largest entry, of the decode logits
              within 2^-8 (the token's attention weights are rounded to
              the bf16 cache's dtype before the PV product, so a last-bit
              f32 difference upstream can move one to its neighbour);
              each cache block within one bf16 step of the entry (bf16
              leaves) plus 1e-4 of the leaf's largest; no DTensor functional
              collective (the data gathers of a data=1 mesh are local,
              the TP collectives c10d calls).
18. examples — the five port examples as a user runs them, one after
              another, each its own process on the default device (the
              card), at their defaults: ``torch_quickstart.py`` (K2 on
              its runtime-shaped body, d=32, W=3, N=3, 8 epochs),
              ``torch_serve_w2v.py`` (a vocab-sharded T=1 session on K1,
              served and hot-swapped), ``torch_lm_train_smoke.py`` (smoke
              qwen3-8b, 20 steps, no kernel), ``torch_distributed_w2v.py``
              (4 gloo ranks sharing the card, K3 at T=4 on each), and
              ``torch_train_100m_w2v.py`` at ``--batches 60`` (d=128,
              K2's compiled body, 2 prefetch threads, checkpoints at
              batches 50 and 60; its Zipf corpus over 400,000 words is
              only 60 x 512 sentences, so the vocabulary it builds holds
              the words that occur, 74,279 rows), then again on its
              checkpoint directory (resumes at 60, no kernel). Each must
              exit 0, print its closing lines and launch the kernel of its
              path and no other (counted in each of its processes, each
              rank's too); one line each with its seconds, launches,
              bodies and printed numbers. Phase 3 holds each example's
              kernel against its plain version at the example's shape.

The last line is ``{"ok": true, "device": {...}}``. Without a GPU, or
without the repository's ``src/`` beside it, the script fails before
printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 peak outside the tensor cores
ATOL, RTOL = 2e-5, 1e-4
# phase 5 holds K1-K4 against their plain versions on this prefix of the
# trainer's first batch (the plain versions loop in Python on the host)
PARITY_SENTENCES = 1000


def _line(phase: str, **kw) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


# ---------------------------------------------------------------------------
# phase 3 inputs (numpy, from --seed)
# ---------------------------------------------------------------------------

def _distinct_negs(rng, np, tokens, vocab, n_neg):
    """Per-window negatives distinct from each other and the target."""
    S, L = tokens.shape
    negs = np.zeros((S, L, n_neg), dtype=np.int32)
    for s in range(S):
        for t in range(L):
            c = rng.choice(vocab - 1, size=n_neg, replace=False)
            negs[s, t] = c + (c >= tokens[s, t])
    return negs


def parity_inputs(np, seed: int, tile: int):
    """d=128, N=5, W_f=3, V=4096, S=8, L=96 with mixed lengths. Sentences
    0-1 force strict tiles (a tile target reused as another window's
    negative); sentences 4-7 share one negative set per tile, so the tile
    plan dedups repeated rows across windows."""
    rng = np.random.default_rng(seed)
    V, d, S, L, N = 4096, 128, 8, 96, 5
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = np.stack([rng.choice(V, size=L, replace=False)
                       for _ in range(S)]).astype(np.int32)
    lengths = np.array([96, 90, 2, 5, 96, 41, 1, 77], np.int32)
    negs = _distinct_negs(rng, np, tokens, V, N)
    for s in (0, 1):
        for t0 in range(0, L, tile):
            tgts = set(tokens[s, t0:t0 + tile].tolist())
            for t in range(t0, min(t0 + tile, L)):
                first = tokens[s, t0 + 1] if t == t0 else tokens[s, t0]
                pool = [x for x in rng.permutation(V)[:64].tolist()
                        if x not in tgts and x != first][:N - 1]
                negs[s, t] = [first] + pool
    for s in range(4, S):
        for t0 in range(0, L, tile):
            tgts = set(tokens[s, t0:t0 + tile].tolist())
            pool = [x for x in rng.permutation(V)[:64].tolist()
                    if x not in tgts][:N]
            negs[s, t0:t0 + tile] = pool
    return dict(w_in=w_in, w_out=w_out, tokens=tokens, negs=negs,
                lengths=lengths, lr=0.05, w_f=3)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _check_close(torch, name, got, want) -> float:
    err = (got - want).abs()
    bad = err > ATOL + RTOL * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={ATOL} "
            f"rtol={RTOL}; max abs err {float(err.max()):.3e}")
    return float(err.max())


def _time_ms(torch, fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events)."""
    fn()                                   # warm-up (and first-use build)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _host_ms(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(np, tokens, negs, lengths, d, w_f, extra_index_bytes=0):
    """Least time the card could take for one batch: the larger of the
    bytes the update must move (every touched table row read and written
    once, the index arrays read once) over HBM bandwidth and its FLOPs
    (3 products of 2*d FLOPs per real (context, output) pair) over the f32
    peak. Counted from this batch's data."""
    S, L = tokens.shape
    N = negs.shape[-1]
    valid = np.arange(L)[None, :] < lengths[:, None]
    rows_in = np.unique(tokens[valid]).size
    out_ids = np.concatenate([tokens[valid], negs[valid].reshape(-1)])
    rows_out = np.unique(out_ids).size
    nbytes = (2 * (rows_in + rows_out) * d * 4 + tokens.nbytes + negs.nbytes
              + lengths.nbytes + extra_index_bytes)
    pairs = 0
    for off in [o for o in range(-w_f, w_f + 1) if o != 0]:
        pos = np.arange(L)[None, :] + off
        pairs += int((valid & (pos >= 0) & (pos < lengths[:, None])).sum())
    flops = 3 * 2 * pairs * (N + 1) * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_parity(torch, np, seed):
    from repro_torch.data.batching import plan_tiles
    from repro_torch.kernels import fullw2v, ref

    tile, G = 8, 4
    inp = parity_inputs(np, seed, tile)
    dev = torch.device("cuda")

    def tens(a):
        return torch.from_numpy(a).to(dev)

    def tables():
        return tens(inp["w_in"].copy()), tens(inp["w_out"].copy())

    idx = [tens(inp[k]) for k in ("tokens", "negs", "lengths")]
    lr, w_f = inp["lr"], inp["w_f"]
    plan8 = plan_tiles(inp["tokens"], inp["negs"], inp["lengths"], tile)
    plan1 = plan_tiles(inp["tokens"], inp["negs"], inp["lengths"], 1)
    if not plan8.strict.any() or plan8.strict.all():
        raise AssertionError("phase-3 batch must mix strict and fused tiles")
    p8 = [tens(a) for a in (plan8.uniq, plan8.scatter, plan8.ucount,
                            plan8.strict)]
    p1 = [tens(a) for a in (plan1.uniq, plan1.scatter, plan1.ucount,
                            plan1.strict)]

    plain_seq = ref.batch_sgns_ref(*tables(), *idx, lr, w_f)
    plain_til = ref.batch_sgns_tiled_ref(*tables(), *idx, lr, w_f, tile, *p8,
                                         gemm_windows=G)
    k1 = fullw2v.fullw2v_cuda(*tables(), *idx, lr, w_f)
    k2 = fullw2v.fullw2v_cuda(*tables(), *idx, lr, w_f, pipeline=True)
    k3 = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, lr, w_f, tile, *p8,
                                    gemm_windows=G)
    k3_t1 = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, lr, w_f, 1, *p1)
    k3_nopf = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, lr, w_f, tile, *p8,
                                         gemm_windows=G, prefetch=False)
    # K4 on the same batch, the table split at hot = V/4 so that rows come
    # from both sides: ids below hot from hot_*, the rest from got_*
    hot = inp["w_in"].shape[0] // 4

    def split():
        w_in, w_out = tables()
        return (w_in[:hot].clone(), w_out[:hot].clone(), w_in[hot:].clone(),
                w_out[hot:].clone())

    plain_fused = ref.batch_sgns_tiled_fused_ref(*split(), *idx, lr, w_f,
                                                 tile, *p8, gemm_windows=G)
    k4 = fullw2v.fullw2v_cuda_tiled_fused(*split(), *idx, lr, w_f, tile, *p8,
                                          gemm_windows=G)
    torch.cuda.synchronize()

    errs = {}
    for name, got, want in (("cuda", k1, plain_seq),
                            ("cuda_pipelined", k2, plain_seq),
                            ("cuda_tiled", k3, plain_til)):
        errs[name] = max(_check_close(torch, f"{name} w_in", got[0], want[0]),
                         _check_close(torch, f"{name} w_out", got[1],
                                      want[1]))
        _line("parity", kernel=name, max_abs_err=f"{errs[name]:.3e}",
              atol=ATOL, rtol=RTOL)
    errs["cuda_tiled_fused"] = max(
        _check_close(torch, f"cuda_tiled_fused {part}", got, want)
        for part, got, want in zip(("hot_in", "hot_out", "got_in", "got_out"),
                                   k4, plain_fused))
    _line("parity", kernel="cuda_tiled_fused", hot=hot,
          max_abs_err=f"{errs['cuda_tiled_fused']:.3e}", atol=ATOL, rtol=RTOL)
    for name, got in (("cuda_pipelined", k2), ("cuda_tiled(T=1)", k3_t1)):
        same = torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
        if not same:
            raise AssertionError(f"{name} is not bit-identical to cuda")
        _line("parity", bitwise=f"{name}==cuda")
    if not (torch.equal(k3[0], k3_nopf[0]) and torch.equal(k3[1], k3_nopf[1])):
        raise AssertionError("cuda_tiled with prefetch is not bit-identical "
                             "to cuda_tiled without it")
    _line("parity", bitwise="cuda_tiled(prefetch)==cuda_tiled(no prefetch)")
    if not (torch.equal(torch.cat([k4[0], k4[2]]), k3[0])
            and torch.equal(torch.cat([k4[1], k4[3]]), k3[1])):
        raise AssertionError("cuda_tiled_fused is not bit-identical to "
                             "cuda_tiled on concat(hot, got)")
    _line("parity", bitwise="cuda_tiled_fused==cuda_tiled(concat)")
    moved = float((k1[0] - tens(inp["w_in"])).abs().max())
    if moved < 1e-4:
        raise AssertionError(f"cuda left w_in unchanged (max delta {moved})")
    phase_parity_runtime_shape(torch, np, seed)
    phase_parity_tiled_runtime_shape(torch, np, seed)
    phase_parity_example_shapes(torch, np)

    # timings at this shape: the plain versions (host clock, they loop in
    # Python) and the kernels (CUDA events)
    timing = {
        "cuda": dict(
            plain_ms=_host_ms(torch, lambda: ref.batch_sgns_ref(
                *tables(), *idx, lr, w_f)),
            small_ms=_time_ms(torch, lambda: fullw2v.fullw2v_cuda(
                *tables(), *idx, lr, w_f), 3)),
        "cuda_tiled": dict(
            plain_ms=_host_ms(torch, lambda: ref.batch_sgns_tiled_ref(
                *tables(), *idx, lr, w_f, tile, *p8, gemm_windows=G)),
            small_ms=_time_ms(torch, lambda: fullw2v.fullw2v_cuda_tiled(
                *tables(), *idx, lr, w_f, tile, *p8, gemm_windows=G), 3)),
    }
    timing["cuda_pipelined"] = dict(
        plain_ms=timing["cuda"]["plain_ms"],
        small_ms=_time_ms(torch, lambda: fullw2v.fullw2v_cuda(
            *tables(), *idx, lr, w_f, pipeline=True), 3))
    timing["cuda_tiled_fused"] = dict(
        plain_ms=_host_ms(torch, lambda: ref.batch_sgns_tiled_fused_ref(
            *split(), *idx, lr, w_f, tile, *p8, gemm_windows=G)),
        small_ms=_time_ms(torch, lambda: fullw2v.fullw2v_cuda_tiled_fused(
            *split(), *idx, lr, w_f, tile, *p8, gemm_windows=G), 3))
    return errs, timing


def phase_parity_runtime_shape(torch, np, seed):
    """K1 and K2 at w_f=4, N=7 (outside the compiled list: the
    runtime-shaped body) against the plain version, and K2 == K1."""
    from repro_torch.kernels import fullw2v, ref

    rng = np.random.default_rng(seed + 1)
    V, d, S, L, N, w_f = 4096, 128, 4, 48, 7, 4
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, 64, size=(S, L)).astype(np.int32)  # repeats
    negs = _distinct_negs(rng, np, tokens, V, N)
    lengths = np.array([L, 3, 1, 37], np.int32)
    dev = torch.device("cuda")
    tens = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731
    tables = lambda: (tens(w_in.copy()), tens(w_out.copy()))  # noqa: E731
    idx = [tens(a) for a in (tokens, negs, lengths)]
    want = ref.batch_sgns_ref(*tables(), *idx, 0.05, w_f)
    fullw2v.reset_launch_counts()
    k1 = fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, w_f)
    k2 = fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, w_f, pipeline=True)
    torch.cuda.synchronize()
    took = {k: v for k, v in fullw2v.SEQ_LAUNCHES.items() if v}
    if took != {"runtime": 2}:
        raise AssertionError(f"w_f=4, N=7 took {took}, not the runtime "
                             f"body twice")
    err = max(_check_close(torch, f"cuda (w_f=4, N=7) {part}", g, w)
              for part, g, w in zip(("w_in", "w_out"), k1, want))
    if not (torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])):
        raise AssertionError("cuda_pipelined is not bit-identical to cuda "
                             "at w_f=4, N=7")
    _line("parity", kernel="cuda+cuda_pipelined", shape="w_f=4 N=7",
          instantiation="runtime", max_abs_err=f"{err:.3e}",
          bitwise="cuda_pipelined==cuda")


def phase_parity_tiled_runtime_shape(torch, np, seed):
    """K3 at T=6, G=4 (outside the compiled list: the runtime-shaped body,
    a whole group and a partial one per tile) on phase 3's batch, built
    for T=6, against the plain version."""
    from repro_torch.data.batching import plan_tiles
    from repro_torch.kernels import fullw2v, ref

    inp = parity_inputs(np, seed, 6)
    dev = torch.device("cuda")
    tens = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731
    tables = lambda: (tens(inp["w_in"].copy()),            # noqa: E731
                      tens(inp["w_out"].copy()))
    idx = [tens(inp[k]) for k in ("tokens", "negs", "lengths")]
    plan = plan_tiles(inp["tokens"], inp["negs"], inp["lengths"], 6)
    p = [tens(a) for a in (plan.uniq, plan.scatter, plan.ucount, plan.strict)]
    want = ref.batch_sgns_tiled_ref(*tables(), *idx, inp["lr"], inp["w_f"], 6,
                                    *p, gemm_windows=4)
    fullw2v.reset_launch_counts()
    got = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, inp["lr"], inp["w_f"],
                                     6, *p, gemm_windows=4)
    torch.cuda.synchronize()
    took = {k: v for k, v in fullw2v.TILED_LAUNCHES.items() if v}
    if took != {"runtime": 1}:
        raise AssertionError(f"T=6, G=4 took {took}, not the runtime body")
    err = max(_check_close(torch, f"cuda_tiled (T=6 G=4) {part}", g, w)
              for part, g, w in zip(("w_in", "w_out"), got, want))
    _line("parity", kernel="cuda_tiled", shape="T=6 G=4",
          instantiation="runtime", max_abs_err=f"{err:.3e}")


def phase_parity_example_shapes(torch, np):
    """K1 and K2 at the quickstart's and serve example's shape (the smoke
    config: d=32, W=3 so w_f=2, N=3), and K3 at the distributed example's
    (the same at T=4, on one rank's 16 sentences of a 64-sentence batch),
    each on the first batch of the examples' cluster corpus, against the
    plain version; each launch must take the runtime-shaped body, and K2
    must equal K1 bit for bit."""
    from repro_torch.configs.w2v import smoke
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus
    from repro_torch.kernels import fullw2v, ops, registry

    corpus = synthetic_cluster_corpus(n_clusters=8, words_per_cluster=16,
                                      n_sentences=800, mean_len=12, seed=0)
    dev = torch.device("cuda")
    for cfg, names, rows in (
            (smoke(epochs=8, dim=32), ("cuda", "cuda_pipelined"), None),
            (smoke(epochs=5, dim=32, sentences_per_batch=64,
                   tile_windows=4), ("cuda_tiled",), 64 // 4)):
        pipe = BatchingPipeline(corpus, cfg)
        batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
        if rows:
            batch = _head(batch, rows)
        step = batch.step_inputs(cfg.lr, dev)
        static = ops.static_for(cfg, step.tile)
        S, L, N = batch.negs.shape
        if step.has_plan:
            inst = fullw2v.tiled_choice(static.w_f, N, cfg.dim, L,
                                        static.tile, static.gemm_windows)[0]
        else:
            inst = fullw2v.seq_instantiation(static.w_f, N, cfg.dim, L)
        gen = torch.Generator(device="cuda").manual_seed(0)
        shape = (pipe.table_rows, cfg.dim)
        w_in = (torch.rand(shape, generator=gen, device=dev) - 0.5) / cfg.dim
        w_out = (torch.rand(shape, generator=gen, device=dev) - 0.5) / cfg.dim
        want = (w_in.clone(), w_out.clone())
        registry.get("torch_tiled" if step.has_plan else "torch").update(
            *want, step, static)
        got = {}
        for name in names:
            got[name] = (w_in.clone(), w_out.clone())
            fullw2v.reset_launch_counts()
            registry.get(name).update(*got[name], step, static)
            torch.cuda.synchronize()
            took = {k: v for k, v in (fullw2v.TILED_LAUNCHES if step.has_plan
                                      else fullw2v.SEQ_LAUNCHES).items() if v}
            if not inst.startswith("runtime") or took != {inst: 1} or \
                    fullw2v.LAUNCHES[name] != 1:
                raise AssertionError(f"{name} at d={cfg.dim} took {took}, "
                                     f"not the runtime body ({inst}) once")
            where = f"{name} (example shape d={cfg.dim} T={static.tile})"
            err = max(_check_close(torch, f"{where} {part}", g, w)
                      for part, g, w in zip(("w_in", "w_out"), got[name],
                                            want))
            _line("parity", kernel=name, shape=f"d={cfg.dim} w_f={static.w_f}"
                  f" N={N} T={static.tile} S={S} L={L}", instantiation=inst,
                  max_abs_err=f"{err:.3e}")
        if len(got) == 2 and not all(
                torch.equal(a, b) for a, b in zip(*got.values())):
            raise AssertionError("cuda_pipelined is not bit-identical to "
                                 "cuda at the examples' shape")


def make_config(args, tile: int, **kw):
    """The main path's configuration: the paper's widths at S=args.S."""
    from repro_torch.configs.w2v import W2VConfig

    return W2VConfig(dim=128, window=5, negatives=5, epochs=1, min_count=1,
                     subsample_t=0.0, sentences_per_batch=args.S,
                     max_sentence_len=64, tile_windows=tile,
                     tile_gemm_windows=4, seed=args.seed, **kw)


def make_corpus(args, n_sentences: int):
    from repro_torch.data.corpus import synthetic_cluster_corpus

    return synthetic_cluster_corpus(
        n_clusters=64, words_per_cluster=65536 // 64,
        n_sentences=n_sentences, mean_len=24, seed=args.seed)


def make_pipeline(args, tile: int, **shard):
    from repro_torch.data.batching import BatchingPipeline

    cfg = make_config(args, tile, **shard)
    corpus = make_corpus(args, args.S * args.batches)
    return BatchingPipeline(corpus, cfg), cfg, corpus


def phase_trainer(torch, np, args, tile: int, backend: str, expect: str,
                  around_train=None, **shard):
    """One main-path run; returns (session, launches, seconds/step, the
    K1/K2 instantiation it took or None, host seconds/step). Host seconds:
    the pipeline's numpy batching (``BatchingStats.seconds``: produce and
    finalize busy time) and the step loop's wait for its batch
    (``fetch_seconds``: the pipeline, a pinned slot and the
    host-to-device copies), each per step. ``around_train``: a context
    manager entered around the training run alone."""
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import TrainSession
    from repro_torch.kernels import fullw2v

    pipe, cfg, corpus = make_pipeline(args, tile, **shard)
    sess = TrainSession(pipe, cfg, backend=backend, device="cuda")
    if sess.backend != expect:
        raise AssertionError(f"backend={backend!r} at T={tile} resolved to "
                             f"{sess.backend!r}, expected {expect!r}")
    w0 = sess.state.w_in.clone()
    fullw2v.reset_launch_counts()
    with around_train or contextlib.nullcontext():
        sess.train(max_batches=args.batches)
    launches = dict(fullw2v.LAUNCHES)
    seq = {k: v for k, v in fullw2v.SEQ_LAUNCHES.items() if v}
    tiled = {k: v for k, v in fullw2v.TILED_LAUNCHES.items() if v}
    batches = sess.state.batches_seen
    kernel = "cuda_tiled_fused" if sess.placement is not None else expect
    others = {k: v for k, v in launches.items() if k != kernel and v}
    if launches[kernel] != batches or batches != args.batches or others:
        raise AssertionError(f"{kernel}: {launches[kernel]} launches for "
                             f"{batches} batches ({launches})")
    extra = {}
    if kernel in ("cuda", "cuda_pipelined"):
        # the main path's shape must take a compiled instantiation
        want = fullw2v.seq_instantiation(cfg.fixed_window, cfg.negatives,
                                         cfg.dim, cfg.resolved_pad_len)
        if want not in fullw2v.SEQ_INSTANTIATIONS[:len(
                fullw2v.SEQ_COMPILED)] or seq != {want: batches}:
            raise AssertionError(f"{kernel} took {seq}, not the compiled "
                                 f"{want} {batches} times")
        extra = dict(instantiation=want)
    else:
        # the T=8 runs (K3, K4) must take the compiled tiled instantiation
        want = fullw2v.tiled_instantiation(
            cfg.fixed_window, cfg.negatives, cfg.dim, cfg.resolved_pad_len,
            tile, cfg.tile_gemm_windows)
        if want not in fullw2v.TILED_INSTANTIATIONS[:len(
                fullw2v.TILED_COMPILED)] or tiled != {want: batches}:
            raise AssertionError(f"{kernel} took {tiled}, not the compiled "
                                 f"{want} {batches} times")
        extra = dict(instantiation=want)
    for name, t in sess.state.params().items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} has non-finite values")
    if not bool((sess.state.w_in != w0).any()):
        raise AssertionError("training left w_in unchanged")
    inv = np.zeros(pipe.vocab.size, dtype=int)
    for w, i in pipe.vocab.ids.items():
        inv[i] = corpus.clusters[w]
    q = evaluate(sess.embeddings(), inv)
    step_s = sess.wall_seconds / batches
    host = {"host_batching_s_per_step": pipe.stats.seconds / batches,
            "host_wait_s_per_step": sess.fetch_seconds / batches}
    if sess.placement is not None:
        extra.update(kernel=kernel, hot=sess.placement.hot,
                     cold=sess.placement.cold,
                     hot_vocab_frac=cfg.hot_vocab_frac)
    _line("trainer", T=tile, backend=sess.backend, S=cfg.sentences_per_batch,
          batches=batches, words_per_s=f"{sess.words_per_sec:.0f}",
          s_per_step=f"{step_s:.4f}", launches=launches[kernel],
          **{k: f"{v:.4f}" for k, v in host.items()},
          separation=f"{q['separation']:.4f}",
          nn_purity=f"{q['nn_purity']:.4f}", **extra)
    return sess, launches[kernel], step_s, extra.get("instantiation"), host


def sharded_hot_frac(np, pipe) -> float:
    """The sharded phase's hot_vocab_frac: 0 (the 90 % coverage head)
    unless fewer than 10 % of the first batch's distinct rows are then
    cold, else 0.25. ``pipe`` is the replicated run's pipeline (the same
    corpus and batches)."""
    from repro_torch.distributed.vocab_placement import (VocabPlacement,
                                                         plan_exchange)

    batch = next(pipe.batches(pad_len=pipe.cfg.resolved_pad_len, epoch=0))
    ex = plan_exchange(batch, VocabPlacement.plan(pipe.vocab.counts, 1))
    distinct = np.unique(np.concatenate([batch.tokens.ravel(),
                                         batch.negs.ravel()])).size
    share = ex.n_distinct[0] / distinct
    frac = 0.0 if share >= 0.1 else 0.25
    _line("trainer", sharded="cold share of distinct rows",
          cold_rows=ex.n_distinct[0], distinct_rows=distinct,
          share=f"{share:.4f}", hot_vocab_frac=frac)
    return frac


def tiled_plan_stats(np, uniq, ucount, strict, lengths, tile) -> dict:
    """The tile plan's traffic facts: the share of the batch's live tiles
    (inside their sentence) that are strict, their mean unique output rows,
    and the columns the cross-tile prefetch takes and rejects (host count,
    the reference's was_prefetched)."""
    from repro_torch.kernels.fullw2v import prefetch_columns

    nt = strict.shape[1]
    live = np.arange(nt)[None, :] * tile < lengths[:, None]
    taken, rejected = prefetch_columns(uniq, ucount, strict, lengths, tile)
    return dict(live_tiles=int(live.sum()),
                strict_share=float(strict[live].mean()),
                mean_unique_rows=float(ucount[live].mean()),
                host_prefetched=taken, host_rejected=rejected)


def device_prefetch_counts(torch, run) -> tuple:
    """(prefetched, rejected) columns counted by the kernel on the card in
    one launch, ``run(counters)``."""
    counters = torch.zeros(2, dtype=torch.int64, device="cuda")
    run(counters)
    torch.cuda.synchronize()
    return tuple(int(c) for c in counters.tolist())


def _check_prefetch(name, stats, dev_counts):
    host = (stats["host_prefetched"], stats["host_rejected"])
    if dev_counts != host:
        raise AssertionError(f"{name}: the kernel counted {dev_counts} "
                             f"prefetched/rejected columns, the plan {host}")
    _line("main-shape", kernel=name, live_tiles=stats["live_tiles"],
          strict_tile_share=f"{stats['strict_share']:.4f}",
          mean_unique_rows_per_tile=f"{stats['mean_unique_rows']:.2f}",
          prefetched_columns=dev_counts[0], rejected_columns=dev_counts[1])


def phase_sharded_shape(torch, np, sess, step_s):
    """K4 on the sharded session's first batch: held against its plain
    version on the batch's first ``PARITY_SENTENCES`` sentences (their own
    exchange plan) and timed (CUDA events) on the whole batch beside its
    bound; the exchange (route, gather and write-back of both tables)
    timed apart; the kernel's share of the trainer's step."""
    from repro_torch.distributed.vocab_placement import plan_exchange
    from repro_torch.kernels import fullw2v, ops, ref

    pipe, cfg, pl = sess.pipeline, sess.cfg, sess.placement
    batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    ex = batch.exchange if batch.exchange is not None else \
        plan_exchange(batch, pl)
    step = ex.step_inputs(cfg.lr, torch.device("cuda"))
    static = ops.static_for(cfg, step.tile)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (pipe.table_rows, cfg.dim)
    full = [((torch.rand(shape, generator=gen, device="cuda") - 0.5)
             / cfg.dim).cpu().numpy() for _ in range(2)]
    (hot_in, cold_in), (hot_out, cold_out) = (
        [torch.from_numpy(a).cuda() for a in pl.split(t)] for t in full)
    run = ops._VocabShardedRun("cuda_tiled", static, pl, exchange="exact")

    def working(step):
        """The split working tables of ``step`` and the kernel's
        arguments after them."""
        route = run.route(step)
        split = (hot_in, hot_out, run.gather(route, cold_in),
                 run.gather(route, cold_out))
        return split, (step.tokens, step.negs, step.lengths, step.lr,
                       static.w_f, static.tile, step.plan_uniq,
                       step.plan_scatter, step.plan_ucount, step.plan_strict)

    head = _head(batch, PARITY_SENTENCES)
    split, args = working(plan_exchange(head, pl).step_inputs(
        cfg.lr, torch.device("cuda")))
    want = [t.clone() for t in split]
    plain_ms = _host_ms(torch, lambda: ref.batch_sgns_tiled_fused_ref(
        *want, *args, gemm_windows=static.gemm_windows))
    got = [t.clone() for t in split]
    fullw2v.fullw2v_cuda_tiled_fused(*got, *args,
                                     gemm_windows=static.gemm_windows)
    torch.cuda.synchronize()
    err = max(_check_close(torch, f"cuda_tiled_fused {part} (main shape, "
                           f"first {PARITY_SENTENCES})", g, w)
              for part, g, w in zip(("hot_in", "hot_out", "got_in",
                                     "got_out"), got, want))
    split, args = working(step)

    def tables():
        return tuple(t.clone() for t in split)

    got = tables()
    stats = tiled_plan_stats(np, ex.plan_uniq, ex.plan_ucount,
                             ex.plan_strict, ex.lengths, static.tile)
    _check_prefetch("cuda_tiled_fused", stats, device_prefetch_counts(
        torch, lambda c: fullw2v.fullw2v_cuda_tiled_fused(
            *tables(), *args, gemm_windows=static.gemm_windows, counters=c)))
    fullw2v.reset_launch_counts()
    ms = _time_ms(torch, lambda: fullw2v.fullw2v_cuda_tiled_fused(
        *got, *args, gemm_windows=static.gemm_windows), 2)
    took = [k for k, v in fullw2v.TILED_LAUNCHES.items() if v]
    if not all(bool(torch.isfinite(t).all()) for t in got):
        raise AssertionError("cuda_tiled_fused: timing runs produced "
                             "non-finite tables")

    def exchange():
        r = run.route(step)
        new_in, new_out = run.gather(r, cold_in), run.gather(r, cold_out)
        run.write_back(r, cold_in, new_in)
        run.write_back(r, cold_out, new_out)

    exchange_ms = _time_ms(torch, exchange, 5)
    p = ex
    extra = (p.plan_uniq.nbytes + p.plan_scatter.nbytes
             + p.plan_ucount.nbytes + p.plan_strict.nbytes)
    # rows counted in the working table's space: hot and got rows alike
    b_ms, b_by = bound(np, ex.tokens, ex.negs, ex.lengths, cfg.dim,
                       cfg.fixed_window, extra)
    share = ms / (step_s * 1e3)
    windows = int(batch.lengths.sum())
    out = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b_ms,
               bound_by=b_by, windows=windows,
               parity_sentences=int(head.tokens.shape[0]),
               parity_windows=int(head.lengths.sum()),
               us_per_window=ms * 1e3 / windows,
               S=int(batch.tokens.shape[0]), exchange_ms=exchange_ms,
               hot=pl.hot, R=ex.request_width, cold_rows=ex.n_distinct[0],
               step_share=share, instantiation=took[0], **stats)
    _line("main-shape", kernel="cuda_tiled_fused", S=out["S"],
          L=int(batch.tokens.shape[1]), hot=pl.hot, R=ex.request_width,
          cold_rows=ex.n_distinct[0], max_abs_err=f"{err:.3e}",
          parity_sentences=out["parity_sentences"],
          plain_ms=f"{plain_ms:.1f}")
    _line("timing", kernel="cuda_tiled_fused", ms_per_launch=f"{ms:.3f}",
          us_per_window=f"{out['us_per_window']:.4f}",
          launches_per_step=1, bound_ms=f"{b_ms:.4f}", bound_by=b_by,
          windows=out["windows"], exchange_ms=f"{exchange_ms:.3f}",
          kernel_share_of_step=f"{share:.3f}")
    return out


def phase_main_shape(torch, np, pipe, cfg, names, parity_sentences=None):
    """Each named kernel on the pipeline's first batch, at the shapes the
    main path gives it: held against its plain version on the whole batch,
    or on its first ``parity_sentences`` sentences (same tolerance as
    phase 3; the plain version's Python loop is the time this phase would
    otherwise spend), then timed (CUDA events) on the whole batch beside
    its bound and the plain version's time on the sentences it held. K1
    and K2 report the instantiation they took, and must equal each other
    and K3 at T=1 (its plan from ``plan_tiles``) bit for bit on the whole
    batch. Each row carries ``plan_costs`` of the batch (its own tile
    plan, or ``plan_tiles`` at T=1) and the seconds the replay took. At
    T=1 (``cuda_pipelined`` named) the deprecated ``ops.sgns_update``
    must return what ``ops.step`` returns on copies of the same tables,
    bit for bit, through one K2 launch each."""
    from repro_torch.data.batching import plan_costs, plan_tiles
    from repro_torch.kernels import fullw2v, ops, registry
    from repro_torch.kernels.tables import Tables

    batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    t0 = time.perf_counter()
    plan = batch.plan if batch.plan is not None else plan_tiles(
        batch.tokens, batch.negs, batch.lengths, 1)
    costs = plan_costs(plan, batch.lengths, cfg.negatives,
                       cfg.tile_gemm_windows)
    costs["replay_s"] = time.perf_counter() - t0
    step = batch.step_inputs(cfg.lr, torch.device("cuda"))
    head, step_head, where = batch, step, "whole batch"
    if parity_sentences and parity_sentences < len(batch.tokens):
        head = _head(batch, parity_sentences)
        step_head = head.step_inputs(cfg.lr, torch.device("cuda"))
        where = f"first {parity_sentences}"
    static = ops.static_for(cfg, step.tile)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (pipe.table_rows, cfg.dim)
    w_in = (torch.rand(shape, generator=gen, device="cuda") - 0.5) / cfg.dim
    w_out = (torch.rand(shape, generator=gen, device="cuda") - 0.5) / cfg.dim

    def tables():
        return w_in.clone(), w_out.clone()

    plain = registry.get("torch_tiled" if step.has_plan else "torch")
    want = tables()
    plain_ms = _host_ms(torch, lambda: plain.update(*want, step_head,
                                                    static))
    extra = 0
    if batch.plan is not None:
        p = batch.plan
        extra = p.uniq.nbytes + p.scatter.nbytes + p.ucount.nbytes \
            + p.strict.nbytes
    b_ms, b_by = bound(np, batch.tokens, batch.negs, batch.lengths, cfg.dim,
                       cfg.fixed_window, extra)
    out, results = {}, {}
    for name in names:
        be = registry.get(name)
        got = tables()
        be.update(*got, step_head, static)
        torch.cuda.synchronize()
        err = max(_check_close(torch, f"{name} w_in (main shape, {where})",
                               got[0], want[0]),
                  _check_close(torch, f"{name} w_out (main shape, {where})",
                               got[1], want[1]))
        if head is not batch:
            got = tables()
            be.update(*got, step, static)
            torch.cuda.synchronize()
        results[name] = (got[0].clone(), got[1].clone())
        fullw2v.reset_launch_counts()
        ms = _time_ms(torch, lambda: be.update(*got, step, static), 2)
        took = [k for k, v in {**fullw2v.SEQ_LAUNCHES,
                               **fullw2v.TILED_LAUNCHES}.items() if v]
        windows = int(batch.lengths.sum())
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         bound_ms=b_ms, bound_by=b_by, windows=windows,
                         us_per_window=ms * 1e3 / windows,
                         S=int(batch.tokens.shape[0]),
                         parity_sentences=int(head.tokens.shape[0]),
                         parity_windows=int(head.lengths.sum()),
                         plan_costs=costs)
        inst = {}
        if took:
            out[name]["instantiation"] = took[0]
            inst = dict(instantiation=took[0])
        _line("main-shape", kernel=name, S=out[name]["S"],
              L=int(batch.tokens.shape[1]), max_abs_err=f"{err:.3e}",
              parity_sentences=out[name]["parity_sentences"],
              plain_ms=f"{plain_ms:.1f}", **inst)
        _line("timing", kernel=name, ms_per_launch=f"{ms:.3f}",
              us_per_window=f"{out[name]['us_per_window']:.4f}",
              launches_per_step=1, bound_ms=f"{b_ms:.4f}", bound_by=b_by,
              windows=windows)
        if not bool(torch.isfinite(got[0]).all()):
            raise AssertionError(f"{name}: timing runs produced non-finite "
                                 f"tables")
        if batch.plan is not None:
            p = batch.plan
            stats = tiled_plan_stats(np, p.uniq, p.ucount, p.strict,
                                     batch.lengths, p.tile)
            _check_prefetch(name, stats, device_prefetch_counts(
                torch, lambda c: fullw2v.fullw2v_cuda_tiled(
                    *tables(), step.tokens, step.negs, step.lengths,
                    step.lr, static.w_f, static.tile, step.plan_uniq,
                    step.plan_scatter, step.plan_ucount, step.plan_strict,
                    gemm_windows=static.gemm_windows, counters=c)))
            out[name].update(stats)
    if "cuda" in results and "cuda_pipelined" in results:
        plan = plan_tiles(batch.tokens, batch.negs, batch.lengths, 1)
        p1 = [torch.from_numpy(a).cuda() for a in (
            plan.uniq, plan.scatter, plan.ucount, plan.strict)]
        got = tables()
        fullw2v.fullw2v_cuda_tiled(*got, step.tokens, step.negs,
                                   step.lengths, step.lr, static.w_f, 1, *p1)
        torch.cuda.synchronize()
        k1 = results["cuda"]
        for other, k in (("cuda_pipelined", results["cuda_pipelined"]),
                         ("cuda_tiled(T=1)", got)):
            if not (torch.equal(k1[0], k[0]) and torch.equal(k1[1], k[1])):
                raise AssertionError(f"{other} is not bit-identical to cuda "
                                     f"at the main path's shape")
        _line("main-shape", bitwise="cuda_pipelined==cuda==cuda_tiled(T=1)",
              S=int(batch.tokens.shape[0]))
    if "cuda_pipelined" in names:
        t0 = time.perf_counter()
        want = ops.step(Tables(*tables()), step, cfg)
        fullw2v.reset_launch_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = ops.sgns_update(*tables(), step, cfg)
        torch.cuda.synchronize()
        _launched("cuda_pipelined", 1)
        if not any(issubclass(w.category, DeprecationWarning)
                   for w in caught):
            raise AssertionError("ops.sgns_update did not warn "
                                 "DeprecationWarning")
        if not (torch.equal(got[0], want.w_in)
                and torch.equal(got[1], want.w_out)):
            raise AssertionError("ops.sgns_update differs from ops.step on "
                                 "copies of the same tables")
        _line("main-shape", bitwise="ops.sgns_update==ops.step",
              kernel="cuda_pipelined", S=int(batch.tokens.shape[0]),
              seconds=f"{time.perf_counter() - t0:.2f}")
    return out


def plan_costs_line(timing: dict, smi: str) -> None:
    """The replayed row traffic of phase 5's batches (``plan_costs``) at
    T=1 (K1/K2's batch) and T=8 (K3's), beside K1-K3's ms a launch and
    the card: row moves and GEMMs a window and the T=8 reduction."""
    c1 = timing["cuda_pipelined"]["plan_costs"]
    c8 = timing["cuda_tiled"]["plan_costs"]
    rows = c8["dma_per_window"] / c1["dma_per_window"]
    gemms = c8["gemms_per_window"] / c1["gemms_per_window"]
    _line("plan-costs", T1_windows=c1["windows"],
          T1_rows_per_window=f"{c1['dma_per_window']:.4f}",
          T1_gemms_per_window=f"{c1['gemms_per_window']:.4f}",
          T8_windows=c8["windows"],
          T8_rows_per_window=f"{c8['dma_per_window']:.4f}",
          T8_gemms_per_window=f"{c8['gemms_per_window']:.4f}",
          row_reduction=f"{1 - rows:.4f}", gemm_reduction=f"{1 - gemms:.4f}",
          K1_ms=f"{timing['cuda']['ms']:.3f}",
          K2_ms=f"{timing['cuda_pipelined']['ms']:.3f}",
          K3_ms=f"{timing['cuda_tiled']['ms']:.3f}",
          replay_s=f"{c1['replay_s'] + c8['replay_s']:.3f}",
          card=json.dumps(smi))


# ---------------------------------------------------------------------------
# phases 6-8: prefetch workers, checkpoints with exact resume, chaos
# ---------------------------------------------------------------------------

def _same_tables(torch, name, got, want) -> None:
    """Raise unless two sessions' tables are equal bit for bit."""
    a, b = got.state.params(), want.state.params()
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError(f"{name}: tables differ from the synchronous "
                             f"run's")


def _launched(kernel, want_at_least) -> int:
    """Launches of ``kernel`` since the last reset; raise unless at least
    ``want_at_least`` and no other kernel ran."""
    from repro_torch.kernels import fullw2v

    launches = dict(fullw2v.LAUNCHES)
    others = {k: v for k, v in launches.items() if k != kernel and v}
    if launches[kernel] < want_at_least or others:
        raise AssertionError(f"{kernel}: {launches[kernel]} launches, "
                             f"wanted {want_at_least} ({launches})")
    return launches[kernel]


def phase_prefetch(torch, np, args, base, workers: int, mode: str):
    """The main path again through the async pipeline (``workers`` of
    ``mode``) on phase 4's corpus and vocabulary: the same kernels
    ``args.batches`` times and tables bit-identical to phase 4's
    synchronous run ``base``."""
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.prefetch import AsyncBatchingPipeline
    from repro_torch.kernels import fullw2v

    cfg = dataclasses.replace(base.cfg, prefetch_workers=workers,
                              prefetch_mode=mode)
    pipe = AsyncBatchingPipeline(base.pipeline.corpus, cfg,
                                 vocab=base.pipeline.vocab)
    sess = TrainSession(pipe, cfg, backend="auto", device="cuda")
    waits, stamps = [], []

    def seen(m):
        waits.append(m.fetch_seconds)
        stamps.append(time.perf_counter())

    sess.on_metrics = seen
    fullw2v.reset_launch_counts()
    sess.train(max_batches=args.batches)
    n = _launched(base.backend, args.batches)
    took = {k: v for k, v in {**fullw2v.SEQ_LAUNCHES,
                              **fullw2v.TILED_LAUNCHES}.items() if v}
    if len(took) != 1:
        raise AssertionError(f"prefetch run took {took}")
    _same_tables(torch, f"T={cfg.tile_windows} {mode} x{workers}", sess,
                 base)
    batches = sess.state.batches_seen
    out = dict(words_per_s=sess.words_per_sec,
               s_per_step=sess.wall_seconds / batches,
               host_batching_s_per_step=pipe.stats.seconds / batches,
               host_wait_s_per_step=sess.fetch_seconds / batches,
               first_wait_s=waits[0],
               later_wait_s_per_step=sum(waits[1:]) / max(1, batches - 1),
               # launch to launch after the first batch: the steady cadence
               steady_s_per_step=(stamps[-1] - stamps[0]) / max(1,
                                                               batches - 1),
               pipeline_wait_frac=sess.pipeline_wait_frac,
               mean_depth=pipe.prefetch.mean_depth,
               max_in_flight=pipe.prefetch.max_in_flight,
               heals=pipe.prefetch.heals)
    _line("prefetch", T=cfg.tile_windows, backend=sess.backend, mode=mode,
          workers=workers, depth=pipe.depth, batches=batches, launches=n,
          words_per_s=f"{out['words_per_s']:.0f}",
          **{k: f"{v:.4f}" for k, v in out.items()
             if k not in ("words_per_s", "max_in_flight", "heals")},
          max_in_flight=out["max_in_flight"], instantiation=next(iter(took)),
          bitwise="==sync")
    return out


def _ckpt_bytes(d: str) -> int:
    from repro_torch.train import checkpoint as ckpt

    step = ckpt.latest_step(d)
    sd = os.path.join(d, f"step_{step:08d}")
    return sum(os.path.getsize(os.path.join(sd, f)) for f in os.listdir(sd))


def _timed_saves(torch, sess, saves: list) -> None:
    """Time every checkpoint the session writes, from a synchronize (so
    the step's kernel is not counted) to the published directory."""
    save = sess.save_checkpoint

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save()
        saves.append(time.perf_counter() - t0)
        return path

    sess.save_checkpoint = timed


def phase_resume(torch, np, args, base, tmp: str, name: str, workers: int):
    """Train ``args.batches - 1`` batches checkpointing each, drop the
    session, resume a new one on the same directory at that batch and
    train the last: bit-identical to phase 4's uninterrupted ``base``.
    Returns the timings and a copy of the directory as the first session
    left it (the resumed one adds a newer checkpoint)."""
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.prefetch import make_pipeline as make_pipe
    from repro_torch.kernels import fullw2v

    cfg = dataclasses.replace(base.cfg, prefetch_workers=workers,
                              prefetch_mode="process")
    corpus, vocab = base.pipeline.corpus, base.pipeline.vocab
    d = os.path.join(tmp, name)
    first = args.batches - 1
    saves = []
    sess = TrainSession(make_pipe(corpus, cfg, vocab), cfg, device="cuda",
                        ckpt_dir=d, ckpt_every=1)
    _timed_saves(torch, sess, saves)
    sess.train(max_batches=first)
    del sess
    copy = d + ".first"
    shutil.copytree(d, copy)
    resumed = TrainSession(make_pipe(corpus, cfg, vocab), cfg, device="cuda",
                           ckpt_dir=d, ckpt_every=1)
    if resumed.resumed_step != first or resumed._resume_skip != first:
        raise AssertionError(f"{name}: resumed at {resumed.resumed_step} "
                             f"(skip {resumed._resume_skip}), not {first}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resumed.restore_latest()              # the same step again, timed
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    _timed_saves(torch, resumed, saves)
    fullw2v.reset_launch_counts()
    resumed.train(max_batches=args.batches - first)
    kernel = "cuda_tiled_fused" if resumed.placement is not None else \
        resumed.backend
    n = _launched(kernel, args.batches - first)
    if resumed.state.epoch_batch != args.batches:
        raise AssertionError(f"{name}: ended at batch "
                             f"{resumed.state.epoch_batch}")
    _same_tables(torch, f"{name} resumed", resumed, base)
    out = dict(save_ms=1e3 * sum(saves) / len(saves), saves=len(saves),
               restore_ms=1e3 * restore_s, ckpt_bytes=_ckpt_bytes(d))
    _line("resume", run=name, T=cfg.tile_windows, backend=resumed.backend,
          workers=f"{workers}xprocess", resumed_step=resumed.resumed_step,
          skip_batches=first, launches_after_resume=n, kernel=kernel,
          save_ms=f"{out['save_ms']:.1f}", saves=out["saves"],
          restore_ms=f"{out['restore_ms']:.1f}", ckpt_bytes=out["ckpt_bytes"],
          bitwise="==uninterrupted")
    return out, copy


def phase_cross_restore(torch, args, base8, d_sharded):
    """The sharded run's checkpoint at batch ``args.batches - 1`` restored
    into a replicated T=8 session (merged through the recorded placement):
    it trains the last batch to phase 4's replicated T=8 tables, bit for
    bit."""
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.kernels import fullw2v

    cfg = base8.cfg
    sess = TrainSession(BatchingPipeline(base8.pipeline.corpus, cfg,
                                         vocab=base8.pipeline.vocab), cfg,
                        device="cuda", ckpt_dir=d_sharded)
    if sess.placement is not None or sess.resumed_step != args.batches - 1:
        raise AssertionError(f"cross-layout restore resumed at "
                             f"{sess.resumed_step}")
    fullw2v.reset_launch_counts()
    sess.train(max_batches=1)
    n = _launched("cuda_tiled", 1)
    _same_tables(torch, "sharded checkpoint -> replicated T=8", sess, base8)
    _line("resume", run="sharded checkpoint -> replicated T=8",
          resumed_step=sess.resumed_step, launches_after_resume=n,
          kernel="cuda_tiled", bitwise="==uninterrupted replicated T=8")


def phase_chaos(torch, args):
    """``run_chaos`` with the reference's fault kinds (the ``heal``
    schedule: failed steps, a killed process worker, a truncated newest
    checkpoint, NaN in ``w_in``) on the card at d=128, T=1 auto, two
    process workers; the supervised run must end with the fault-free
    run's bits."""
    from repro_torch.kernels import fullw2v
    from repro_torch.train.chaos import SCHEDULES, run_chaos

    sched = SCHEDULES["heal"]
    S = args.S
    cfg = make_config(args, 1)
    # ~5 batches an epoch, so the 10-batch schedule crosses the boundary
    corpus = make_corpus(args, S * 9 // 2)
    fullw2v.reset_launch_counts()
    r = run_chaos(sched, backend="auto", device="cuda", cfg=cfg,
                  corpus=corpus)
    n = _launched(r["backend"], sched.max_batches + r["batches_trained"])
    bad = []
    if r["digest_match"] != 1:
        bad.append("the faulted run's tables differ from the fault-free "
                   "run's")
    if r["faults_fired"] != r["faults_scheduled"]:
        bad.append(f"{r['faults_fired']}/{r['faults_scheduled']} faults")
    if r["heals"] < 1 or r["workers_killed"] < 1:
        bad.append(f"heals={r['heals']} workers_killed="
                   f"{r['workers_killed']}")
    if r["ckpt_quarantined"] < 1:
        bad.append("the truncated checkpoint was never quarantined")
    if bad:
        raise AssertionError(f"chaos: {'; '.join(bad)} ({r})")
    probe_ms = 1e3 * r["probe_seconds"] / max(1, r["probes"])
    _line("chaos", schedule="heal", S=S, d=cfg.dim, T=1,
          backend=r["backend"], workers="2xprocess", launches=n,
          **{k: r[k] for k in ("digest_match", "faults_fired",
                               "faults_scheduled", "restarts", "rollbacks",
                               "health_failures", "heals", "workers_killed",
                               "ckpts_truncated", "ckpt_quarantined",
                               "batches", "batches_trained", "probes")},
          probe_ms_per_batch=f"{probe_ms:.3f}",
          recovery_s=f"{r['recovery_seconds']:.3f}",
          wall_s=f"{r['wall_seconds']:.3f}")
    return r


# ---------------------------------------------------------------------------
# phase 9: mixed-precision tables
# ---------------------------------------------------------------------------

MIXED_RUNS = (("hot=bf16", 1, "cuda_pipelined"),
              ("hot=bf16", 8, "cuda_tiled"),
              ("hot=bf16,cold=bf16,shards=1", 8, "cuda_tiled_fused"),
              ("hot=bf16,cold=int8,shards=1,master=1", 8, "cuda_tiled_fused"))
QUALITY_MIXED = "hot=bf16:frac=0.1,cold=int8,shards=1,master=1"


def _same_bytes(torch, a, b) -> bool:
    """Equal storage bytes of two tensors (any dtype, any device)."""
    view = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    a, b = a.detach().cpu(), b.detach().cpu()
    return a.dtype == b.dtype and torch.equal(a.view(view.get(a.dtype,
                                                              a.dtype)),
                                              b.view(view.get(b.dtype,
                                                              b.dtype)))


class CodecSpy:
    """Wraps the storage codec (``quant.decode`` and the stochastic
    encoders ``bf16_stochastic`` / ``int8_stochastic``) while a session
    trains: CUDA events around each call give the codec's device time
    (:meth:`ms`, read after a synchronize), and with ``check_cpu`` every
    encode's bytes are held against the CPU run of the same function on
    the same f32 input (the step's kernel output on the card) and key."""
    NAMES = ("decode", "bf16_stochastic", "int8_stochastic")

    def __init__(self, torch, check_cpu: bool = False):
        from repro_torch.kernels import quant
        self.torch, self.quant, self.check_cpu = torch, quant, check_cpu
        self.spans, self.encodes, self.elements = [], 0, 0

    def __enter__(self):
        self.real = {n: getattr(self.quant, n) for n in self.NAMES}
        for n, fn in self.real.items():
            setattr(self.quant, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.real.items():
            setattr(self.quant, n, fn)

    def _wrap(self, name, fn):
        torch = self.torch

        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.spans.append((start, end))
            if self.check_cpu and name != "decode":
                x, key = a[0], a[1]
                cpu = fn(x.cpu(), key)
                got = out if isinstance(out, tuple) else (out,)
                want = cpu if isinstance(cpu, tuple) else (cpu,)
                if not all(_same_bytes(torch, g, w)
                           for g, w in zip(got, want)):
                    raise AssertionError(f"{name} on the card stored other "
                                         f"bytes than on the CPU")
                self.encodes += 1
                self.elements += x.numel()
            return out
        return run

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.spans)


def phase_codec(torch, np, args, rows: int, dim: int) -> dict:
    """``encode_stochastic`` (bf16, int8) on a (rows, dim) f32 table with a
    fixed key: the card's bytes equal the CPU's; encode and decode timed
    on the card (CUDA events)."""
    from repro_torch.kernels import quant

    gen = torch.Generator().manual_seed(args.seed)
    x = (torch.rand((rows, dim), generator=gen) - 0.5) / dim
    xd = x.cuda()
    key = quant.round_key(args.seed, 0, 0)
    out = {}
    for dtype in ("bfloat16", "int8"):
        cpu = quant.encode_stochastic(x, dtype, key, quant.TAG_FULL_IN)
        dev = quant.encode_stochastic(xd, dtype, key, quant.TAG_FULL_IN)
        same = all(_same_bytes(torch, g, w) for g, w in zip(dev, cpu)
                   if w is not None)
        if not same:
            raise AssertionError(f"encode_stochastic({dtype}) on the card "
                                 f"differs from the CPU's bytes")
        enc_ms = _time_ms(torch, lambda: quant.encode_stochastic(
            xd, dtype, key, quant.TAG_FULL_IN), 5)
        dec_ms = _time_ms(torch, lambda: quant.decode(dev[0], dev[1],
                                                      dtype), 5)
        out[dtype] = dict(encode_ms=enc_ms, decode_ms=dec_ms)
        _line("mixed", codec=dtype, rows=rows, dim=dim, bitwise="card==cpu",
              encode_ms=f"{enc_ms:.3f}", decode_ms=f"{dec_ms:.3f}")
    return out


def phase_mixed_run(torch, np, args, tables: str, tile: int, kernel: str,
                    frac: float):
    """One mixed-precision run at phase 4's shapes: the first step's
    stored bytes against the CPU codec (a one-batch session), then the
    3-batch run with the codec timed inside its steps."""
    from repro_torch.core.trainer import TrainSession

    kw = dict(tables=tables, hot_vocab_frac=frac)
    expect = "cuda_tiled" if tile > 1 else "cuda_pipelined"
    pipe, cfg, _ = make_pipeline(args, tile, **kw)
    first = TrainSession(pipe, cfg, backend="auto", device="cuda")
    with CodecSpy(torch, check_cpu=True) as check:
        first.train(max_batches=1)
    if not check.encodes:
        raise AssertionError(f"{tables}: the step stored nothing")
    del first
    spy = CodecSpy(torch)
    sess, n, step_s, inst, host = phase_trainer(
        torch, np, args, tile, "auto", expect, around_train=spy, **kw)
    if (sess.placement is not None) != (kernel == "cuda_tiled_fused"):
        raise AssertionError(f"{tables}: placement {sess.placement}")
    params = sess.state.params()
    nbytes = sum(t.numel() * t.element_size() for t in params.values())
    f32 = 4 * sum(t.numel() for k, t in params.items()
                  if not k.startswith("scale"))
    codec_ms = spy.ms() / sess.state.batches_seen
    out = dict(tables=tables, T=tile, kernel=kernel, launches=n,
               words_per_s=sess.words_per_sec, s_per_step=step_s,
               codec_ms_per_step=codec_ms,
               codec_share_of_step=codec_ms / (step_s * 1e3),
               table_bytes=nbytes, f32_table_bytes=f32,
               bytes_ratio=nbytes / f32, in_situ_encodes=check.encodes,
               in_situ_elements=check.elements, instantiation=inst, **host)
    _line("mixed", tables=tables, T=tile, kernel=kernel, launches=n,
          words_per_s=f"{out['words_per_s']:.0f}",
          s_per_step=f"{step_s:.4f}", codec_ms_per_step=f"{codec_ms:.3f}",
          codec_share_of_step=f"{out['codec_share_of_step']:.4f}",
          table_bytes=nbytes, f32_table_bytes=f32,
          bytes_ratio=f"{out['bytes_ratio']:.4f}",
          in_situ=f"{check.encodes} encodes of {check.elements} elements "
                  f"card==cpu", instantiation=inst)
    return sess, out


def phase_mixed_quality(torch, np, args) -> dict:
    """The reference's mixed-precision quality gate (bench_quality's
    shape) on the card: ``QUALITY_MIXED`` (K1 under the f32 master copy)
    against f32 (K2) on the same batches; the separation ratio must lie
    in 1.00 ± 0.01."""
    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus
    from repro_torch.kernels import fullw2v

    corpus = synthetic_cluster_corpus(n_clusters=8, words_per_cluster=16,
                                      n_sentences=400, mean_len=14, seed=0)
    out = {}
    for name, tables, kernel in (("f32", "", "cuda_pipelined"),
                                 ("mixed", QUALITY_MIXED, "cuda")):
        cfg = W2VConfig(dim=64, window=5, negatives=5, epochs=8,
                        min_count=1, subsample_t=0.0,
                        sentences_per_batch=128, max_sentence_len=48,
                        tables=tables, seed=args.seed)
        pipe = BatchingPipeline(corpus, cfg)
        sess = TrainSession(pipe, cfg, backend="auto", device="cuda")
        fullw2v.reset_launch_counts()
        sess.train()
        n = _launched(kernel, sess.state.batches_seen)
        inv = np.zeros(pipe.vocab.size, dtype=int)
        for w, i in pipe.vocab.ids.items():
            inv[i] = corpus.clusters[w]
        q = evaluate(sess.embeddings()[:pipe.vocab.size], inv, seed=1)
        out[name] = dict(separation=q["separation"], launches=n,
                         kernel=kernel, batches=sess.state.batches_seen)
    ratio = out["mixed"]["separation"] / out["f32"]["separation"]
    out["ratio"] = ratio
    _line("mixed", gate="quality", tables=QUALITY_MIXED,
          f32_separation=f"{out['f32']['separation']:.4f}",
          mixed_separation=f"{out['mixed']['separation']:.4f}",
          ratio=f"{ratio:.4f}", limit="1.00+-0.01",
          f32_kernel=f"cuda_pipelined x{out['f32']['launches']}",
          mixed_kernel=f"cuda x{out['mixed']['launches']}")
    if abs(ratio - 1.0) > 0.01:
        raise AssertionError(f"mixed/f32 separation ratio {ratio:.4f} "
                             f"outside 1.00 +- 0.01")
    return out


# ---------------------------------------------------------------------------
# phase 10: multi-rank on the one card (ranks time-slice it over gloo)
# ---------------------------------------------------------------------------

# DESIGN.md §8's rule for the cold tail of a sharded run against the
# replicated (data-parallel) run: summation orders differ at n > 2
COLD_ATOL, COLD_RTOL = 1e-6, 1e-5
MESH_MIXED = (("hot=bf16,cold=bf16,shards=2", "hot=bf16,cold=bf16,shards=1"),
              ("hot=bf16,cold=int8,shards=2,master=1",
               "hot=bf16,cold=int8,shards=1,master=1"))


def _digest(torch, tensors) -> str:
    """sha256 of the tensors' storage bytes, in order."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy())
    return h.hexdigest()


def _all_ranks(mesh, value) -> list:
    """Every rank's picklable ``value``, by rank."""
    import torch.distributed as dist
    out = [None] * mesh.size
    dist.all_gather_object(out, value)
    return out


class MeshSpy:
    """Wraps, while a rank trains, the collectives
    (``repro_torch.distributed.collectives``: host ms per call between two
    ``torch.cuda.synchronize()``, outermost calls only, so ``pmean``
    counts its gather) and the kernels' launch functions in ``ops``
    (device ms per launch, CUDA events on the rank's stream: with ranks
    time-slicing one card a launch's span includes the other ranks'
    work)."""
    COLL = ("all_gather", "all_to_all", "psum_scatter", "pmean")
    KERNELS = ("fullw2v_cuda", "fullw2v_cuda_tiled",
               "fullw2v_cuda_tiled_fused")

    def __init__(self, torch):
        from repro_torch.distributed import collectives
        from repro_torch.kernels import ops
        self.torch, self.coll, self.ops = torch, collectives, ops
        self.coll_s = {n: 0.0 for n in self.COLL}
        self.calls = {n: 0 for n in self.COLL}
        self.spans = []
        self.depth = 0

    def __enter__(self):
        self.real = [(self.coll, n, getattr(self.coll, n))
                     for n in self.COLL]
        self.real += [(self.ops, n, getattr(self.ops, n))
                      for n in self.KERNELS]
        for mod, n, fn in self.real:
            wrap = self._coll if mod is self.coll else self._kernel
            setattr(mod, n, wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.real:
            setattr(mod, n, fn)

    def _coll(self, name, fn):
        torch = self.torch

        def run(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                self.depth -= 1
            self.coll_s[name] += time.perf_counter() - t0
            self.calls[name] += 1
            return out
        return run

    def _kernel(self, name, fn):
        torch = self.torch

        def run(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            self.spans.append((start, end))
            return out
        return run

    def kernel_ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.spans]


def mesh_probe(torch, np, mesh) -> dict:
    """Each collective on CUDA tensors (f32, bf16, int8; ``pmean`` f32)
    against its numpy definition; every op runs on the tensors' device
    (``collectives`` stages nothing through the host)."""
    from repro_torch.distributed import collectives as coll

    n, me, dev = mesh.size, mesh.rank, mesh.device
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "int8": torch.int8}

    def make(r, dt):
        rng = np.random.default_rng(r)
        return rng.integers(-20, 20, size=(n, 3, 4)).astype(np.float64), dt

    out = {}
    for op in ("all_gather", "all_to_all", "psum_scatter", "pmean"):
        for name, dt in dtypes.items():
            if op == "pmean" and name != "float32":
                continue
            xs = [make(r, dt)[0] for r in range(n)]
            x = torch.tensor(xs[me], device=dev).to(dt)
            got = getattr(coll, op)(x, mesh)
            if op == "all_gather":
                want = np.stack(xs)
            elif op == "all_to_all":
                want = np.stack([xs[s][me] for s in range(n)])
            elif op == "psum_scatter":
                want = sum(x_[me] for x_ in xs)[None]
            else:
                want = sum(xs[1:], xs[0].astype(np.float32)) / np.float32(n)
            if got.device != dev or got.dtype != dt or not np.array_equal(
                    got.float().cpu().numpy(), np.asarray(want, np.float32)):
                raise AssertionError(f"{op}({name}) on the card differs from "
                                     f"its definition")
            out[f"{op}/{name}"] = "ok"
    return out


def mesh_run(torch, np, mesh, args, corpus, vocab, tile: int, kernel: str,
             emulate: bool = False, ckpt_dir=None, **cfg_kw) -> dict:
    """One run on every rank of ``mesh``: ``args.batches`` batches of
    ``args.S`` sentences (``args.S / n`` a rank) through
    ``TrainSession(mesh=...)``, each rank launching ``kernel`` once per
    batch (counts zeroed before, read after). After every batch the ranks'
    replicated tables (the head of a sharded run) must hash alike.
    ``emulate``: the first batch must equal, bit for bit, the mean of the
    same kernel launched in one process on each rank's block from the same
    tables. Returns timings and, on rank 0, the embeddings and the
    gathered tables' digest."""
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.kernels import fullw2v, ops
    from repro_torch.kernels.tables import Tables
    from repro_torch.launch.mesh import DataMesh

    cfg = make_config(args, tile, **cfg_kw)
    pipe = BatchingPipeline(corpus, cfg, vocab=vocab)
    sess = TrainSession(pipe, cfg, backend="auto", mesh=mesh,
                        ckpt_dir=ckpt_dir)
    want_be = "cuda_tiled" if tile > 1 else (
        "cuda" if sess.placement is not None else "cuda_pipelined")
    if sess.backend != want_be:
        raise AssertionError(f"T={tile} resolved to {sess.backend}")
    first = None
    if emulate:
        batch = next(BatchingPipeline(corpus, cfg, vocab=vocab).batches(
            pad_len=cfg.resolved_pad_len, epoch=0))
        lr = sess.current_lr()
        halves = []
        for r in range(mesh.size):
            tabs = Tables(w_in=sess.state.w_in.clone(),
                          w_out=sess.state.w_out.clone())
            block = DataMesh(rank=r, size=mesh.size, device=mesh.device)
            ops.step(tabs, batch.step_inputs(lr, mesh.device, mesh=block),
                     cfg, backend=sess.backend)
            halves.append((tabs.w_in, tabs.w_out))
        first = []
        for i in (0, 1):            # (a + b) / 2, summed as pmean sums
            acc = halves[0][i].clone()
            for h in halves[1:]:
                acc += h[i]
            first.append(acc / mesh.size)
    checks = {"digest_s": 0.0, "replicas_equal": 0}

    def after(state):
        t0 = time.perf_counter()
        if first is not None and state.batches_seen == 1:
            if not all(torch.equal(a.view(torch.int32),
                               b.view(torch.int32)) for a, b in zip(
                    first, (state.w_in, state.w_out))):
                raise AssertionError(f"T={tile}: batch 1 differs from the "
                                     f"mean of the per-block updates")
            checks["emulated"] = True
        digests = _all_ranks(mesh, _digest(torch, (state.w_in,
                                                   state.w_out)))
        if len(set(digests)) != 1:
            raise AssertionError(f"T={tile} batch {state.batches_seen}: "
                                 f"replicas differ across ranks")
        checks["replicas_equal"] += 1
        checks["digest_s"] += time.perf_counter() - t0

    sess.on_batch = after
    fullw2v.reset_launch_counts()
    with MeshSpy(torch) as spy:
        sess.train(max_batches=args.batches)
    n = _launched(kernel, args.batches)
    kms = spy.kernel_ms()
    batches = sess.state.batches_seen
    if ckpt_dir:
        sess.save_checkpoint()
    emb = sess.embeddings()
    digest = _digest(torch, sess.gathered_params().values())
    for name, t in sess.state.params().items():
        if not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"{name} has non-finite values")
    step_s = (sess.wall_seconds - checks["digest_s"]) / batches
    mine = dict(launches=n, kernel_ms=sum(kms) / len(kms),
                coll_ms={k: 1e3 * v / batches for k, v in spy.coll_s.items()
                         if spy.calls[k]},
                coll_calls={k: v // batches for k, v in spy.calls.items()
                            if v},
                host_batching_s_per_step=pipe.stats.seconds / batches,
                s_per_step=step_s,
                words_per_s=sess.state.words_seen / (step_s * batches))
    ranks = _all_ranks(mesh, mine)
    out = dict(ranks=ranks, digest=digest, emb=emb,
               emulated=checks.get("emulated", False),
               replicas_equal=checks["replicas_equal"], placement=(
                   None if sess.placement is None else
                   sess.placement.to_extra()))
    if mesh.rank == 0:
        r0 = ranks[0]
        _line("mesh", n=mesh.size, T=tile, S=args.S,
              S_per_rank=args.S // mesh.size, batches=batches,
              tables=cfg.tables or "f32", vocab_shard=cfg.vocab_shard,
              exchange=sess.exchange if sess.placement else "-",
              backend=f"{mesh.backend}@{mesh.device}", kernel=kernel,
              launches_per_rank=[r["launches"] for r in ranks],
              kernel_ms_per_rank=[f"{r['kernel_ms']:.1f}" for r in ranks],
              coll_ms_per_step={k: f"{v:.1f}" for k, v in
                                r0["coll_ms"].items()},
              coll_calls_per_step=r0["coll_calls"],
              s_per_step=f"{r0['s_per_step']:.4f}",
              words_per_s=f"{r0['words_per_s']:.0f}",
              host_batching_s_per_step=f"{r0['host_batching_s_per_step']:.4f}",
              replicas_equal=f"{checks['replicas_equal']}/{batches}",
              emulated="bitwise" if first is not None else "-",
              note=("ranks time-slice one card" if mesh.backend == "gloo"
                    else "a card a rank"))
    return out


def _hot_cold(np, name, emb, base, placement) -> float:
    """DESIGN.md §8: the head bit for bit, the tail within the rule."""
    hot = placement["hot"]
    if not np.array_equal(emb[:hot], base[:hot]):
        raise AssertionError(f"{name}: hot head differs")
    err = np.abs(emb[hot:] - base[hot:])
    bad = err > COLD_ATOL + COLD_RTOL * np.abs(base[hot:])
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} cold elements "
                             f"outside atol={COLD_ATOL} rtol={COLD_RTOL}")
    return float(err.max()) if err.size else 0.0


def mesh_phase(mesh, args, frac: float, tmp: str) -> dict:
    """Phase 10 on one rank of the N=2 mesh (a-d); every rank runs it,
    rank 0's result returns to the parent."""
    import numpy as np
    import torch

    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.kernels import _build, fullw2v

    _build.load()
    out = {"probe": mesh_probe(torch, np, mesh)}
    if mesh.rank == 0:
        _line("mesh", probe=out["probe"], path="direct (every op)",
              backend=f"{mesh.backend}@{mesh.device}", ranks=mesh.size)
    corpus = make_corpus(args, args.S * args.batches)
    vocab = BatchingPipeline(corpus, make_config(args, 1)).vocab
    launches = {}

    def keep(key, kernel, r):
        launches.setdefault(kernel, {})[key] = [x["launches"]
                                                for x in r["ranks"]]
        return r

    # b. data parallelism: K2 at T=1, K3 at T=8
    dp = {}
    for tile, kernel in ((1, "cuda_pipelined"), (8, "cuda_tiled")):
        dp[tile] = keep(f"N=2 dp T={tile}", kernel, mesh_run(
            torch, np, mesh, args, corpus, vocab, tile, kernel,
            emulate=True))
        if not dp[tile]["emulated"]:
            raise AssertionError("the emulation was not checked")
    # c. vocab sharding: K4 exact and dense at T=8, K1 at T=1
    vs = {}
    for tile, exchange, kernel in ((8, "exact", "cuda_tiled_fused"),
                                   (8, "dense", "cuda_tiled_fused"),
                                   (1, "exact", "cuda")):
        r = keep(f"N=2 sharded {exchange} T={tile}", kernel, mesh_run(
            torch, np, mesh, args, corpus, vocab, tile, kernel,
            vocab_shard=True, hot_vocab_frac=frac,
            tables=f"shards=2,exchange={exchange}"))
        vs[tile, exchange] = r
        if mesh.rank == 0:
            err = _hot_cold(np, f"sharded {exchange} T={tile} vs dp",
                            r["emb"], dp[tile]["emb"], r["placement"])
            _line("mesh", rule="§8", n=2, T=tile, exchange=exchange,
                  against=f"dp T={tile}", hot="bitwise",
                  cold_max_abs_err=f"{err:.3e}")
    if mesh.rank == 0:
        err = _hot_cold(np, "exact vs dense", vs[8, "exact"]["emb"],
                        vs[8, "dense"]["emb"], vs[8, "exact"]["placement"])
        _line("mesh", rule="§8", n=2, T=8, exchange="exact vs dense",
              hot="bitwise", cold_max_abs_err=f"{err:.3e}")
    del dp, vs
    # d. mixed storage, checkpoints across layouts, a rerun's digest
    mixed = {}
    for tables, one in MESH_MIXED:
        d = os.path.join(tmp, tables.replace(",", "_").replace("=", "-"))
        r = keep(f"N=2 {tables} T=8", "cuda_tiled_fused", mesh_run(
            torch, np, mesh, args, corpus, vocab, 8, "cuda_tiled_fused",
            ckpt_dir=d, vocab_shard=True, hot_vocab_frac=frac,
            tables=tables))
        mixed[tables] = r
        if mesh.rank == 0:
            for spec in (one, ""):
                cfg = make_config(args, 8, tables=spec,
                                  vocab_shard=bool(spec),
                                  hot_vocab_frac=frac)
                back = TrainSession(BatchingPipeline(corpus, cfg,
                                                     vocab=vocab),
                                    cfg, device=mesh.device, ckpt_dir=d)
                if back.resumed_step != args.batches or not np.array_equal(
                        back.embeddings(), r["emb"]):
                    raise AssertionError(f"{tables} checkpoint restored "
                                         f"into {spec or 'f32'} differs")
                _line("mesh", restore=f"{tables} (2 ranks) -> "
                      f"{spec or 'replicated f32'} (1 process)",
                      resumed_step=back.resumed_step, embeddings="bitwise")
                del back
        mesh.barrier()
    tables = MESH_MIXED[1][0]
    again = mesh_run(torch, np, mesh, args, corpus, vocab, 8,
                     "cuda_tiled_fused", vocab_shard=True,
                     hot_vocab_frac=frac, tables=tables)
    if again["digest"] != mixed[tables]["digest"]:
        raise AssertionError(f"{tables}: a rerun's final digest differs")
    if mesh.rank == 0:
        _line("mesh", rerun=tables, final_digest=again["digest"][:16],
              same="bitwise (the owner-side merge's fixed order)")
    fullw2v.reset_launch_counts()
    return dict(launches=launches, probe=out["probe"], backend=mesh.backend)


def mesh_phase_four(mesh, args, frac: float) -> dict:
    """Phase 10e on one rank of the N=4 mesh: a data-parallel T=8 run and
    an f32 exact sharded T=8 run at reduced depth, held to §8's rules."""
    import numpy as np
    import torch

    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.kernels import _build

    _build.load()
    corpus = make_corpus(args, args.S * args.batches)
    vocab = BatchingPipeline(corpus, make_config(args, 1)).vocab
    dp = mesh_run(torch, np, mesh, args, corpus, vocab, 8, "cuda_tiled",
                  emulate=False)
    vs = mesh_run(torch, np, mesh, args, corpus, vocab, 8,
                  "cuda_tiled_fused", vocab_shard=True, hot_vocab_frac=frac,
                  tables="shards=4,exchange=exact")
    if mesh.rank == 0:
        err = _hot_cold(np, "N=4 sharded vs dp", vs["emb"], dp["emb"],
                        vs["placement"])
        _line("mesh", rule="§8", n=4, T=8, exchange="exact",
              against="dp T=8", hot="bitwise",
              cold_max_abs_err=f"{err:.3e}",
              note=f"reduced depth: S={args.S}, {args.batches} batches")
    return {"launches": {
        "cuda_tiled": {"N=4 dp T=8": [r["launches"] for r in dp["ranks"]]},
        "cuda_tiled_fused": {"N=4 sharded exact T=8": [
            r["launches"] for r in vs["ranks"]]}}}


def phase_mesh(args, frac: float) -> dict:
    """Phase 10: the ranks on the one card over gloo, N=2 (a-d) then N=4
    (e, reduced depth); returns the launches by run."""
    from repro_torch.launch.mesh import start_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        two = start_ranks(mesh_phase, 2, "cuda", args, frac, tmp,
                          timeout=600)
    four = start_ranks(mesh_phase_four, 4, "cuda",
                       argparse.Namespace(**{**vars(args), "S": 2000,
                                             "batches": 2}), frac,
                       timeout=300)
    _line("mesh", seconds=f"{time.perf_counter() - t0:.1f}",
          note=("ranks share one card over gloo: no scaling is shown"
                if two["backend"] == "gloo" else "NCCL, a card a rank"))
    out = two["launches"]
    for kernel, runs in four["launches"].items():
        out.setdefault(kernel, {}).update(runs)
    return out


# ---------------------------------------------------------------------------
# phase 11: the workload frontends and the baselines
# ---------------------------------------------------------------------------

# node2vec's graph and walks (the reference's CLI defaults for p, q and the
# walk length; 2 walks a node): 8,192 nodes, about 655K walk tokens
NODE2VEC = dict(communities=256, nodes_per=32, walks_per_node=2,
                walk_length=40, p=1.0, q=0.5)
NODE2VEC_RUNS = ((1, False, "cuda_pipelined", "cuda_pipelined"),
                 (8, False, "cuda_tiled", "cuda_tiled"),
                 (1, True, "cuda", "cuda"),
                 (8, True, "cuda_tiled", "cuda_tiled_fused"))
PARITY_WALKS = 256
# doc2vec and subword run the plain versions: depth cut to one batch of
# S sentences (fastText's default -bucket 2000000 n-gram rows, -minn 3,
# -maxn 5); S cut to a quarter (from 1,000 and 500) when phase 16 took
# the script past 900 s
DOC2VEC = dict(docs=2048, sents_per_doc=24, clusters=64,
               words_per_cluster=1024)
DOC2VEC_S = 250
SUBWORD = dict(vocab=65_536, clusters=64, sentences=20_000,
               buckets=2_000_000, minn=3, maxn=5)
SUBWORD_S = 125


def _inv_clusters(np, pipe, corpus):
    """Ground-truth cluster of each vocabulary id."""
    inv = np.zeros(pipe.vocab.size, dtype=int)
    for w, i in pipe.vocab.ids.items():
        inv[i] = corpus.clusters[w]
    return inv


def _head(batch, n: int):
    """The first ``n`` sentences of a host batch, with its tile plan."""
    from repro_torch.data.batching import Batch, TilePlan

    plan = None
    if batch.plan is not None:
        p = batch.plan
        plan = TilePlan(tile=p.tile, uniq=p.uniq[:n], scatter=p.scatter[:n],
                        ucount=p.ucount[:n], strict=p.strict[:n])
    return Batch(tokens=batch.tokens[:n], negs=batch.negs[:n],
                 lengths=batch.lengths[:n],
                 n_words=int(batch.lengths[:n].sum()), plan=plan)


def node2vec_workload(args):
    """The node2vec workload at the paper's widths, walks built once."""
    from repro_torch import frontends

    t0 = time.perf_counter()
    w = frontends.get("node2vec").build(make_config(args, 1), **NODE2VEC,
                                        seed=args.seed)
    walks_s = time.perf_counter() - t0
    steps = sum(len(s) - 1 for s in w.corpus.sentences)
    _line("frontends", workload="node2vec", nodes=w.corpus.vocab_size,
          walks=len(w.corpus.sentences),
          tokens=sum(len(s) for s in w.corpus.sentences),
          walk_seconds=f"{walks_s:.2f}",
          us_per_walk_step=f"{walks_s / max(steps, 1) * 1e6:.2f}")
    return w


def node2vec_run(torch, np, args, w, tile: int, shard: bool, expect: str,
                 kernel: str, vocab=None, workers: int = 0):
    """One epoch of node2vec through ``TrainSession`` (``auto``): it must
    resolve to ``expect`` and launch ``kernel`` once per batch and nothing
    else (counts zeroed before the run, read after). Returns the session,
    its launches and its tables' digest."""
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.prefetch import AsyncBatchingPipeline
    from repro_torch.kernels import fullw2v

    cfg = dataclasses.replace(w.cfg, tile_windows=tile, vocab_shard=shard)
    pipe = (AsyncBatchingPipeline(w.corpus, cfg, vocab=vocab,
                                  workers=workers, mode="thread")
            if workers else BatchingPipeline(w.corpus, cfg, vocab=vocab))
    w.attach(pipe)
    sess = TrainSession(pipe, cfg, backend="auto", device="cuda")
    if sess.backend != expect:
        raise AssertionError(f"node2vec T={tile} shard={shard} resolved to "
                             f"{sess.backend!r}, expected {expect!r}")
    fullw2v.reset_launch_counts()
    sess.train()
    batches = sess.state.batches_seen
    launches = dict(fullw2v.LAUNCHES)
    others = {k: v for k, v in launches.items() if k != kernel and v}
    if launches[kernel] != batches or others or batches < 2:
        raise AssertionError(f"node2vec {kernel}: {launches[kernel]} "
                             f"launches for {batches} batches ({launches})")
    for name, t in sess.state.params().items():
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"node2vec {name} has non-finite values")
    q = evaluate(sess.embeddings(), _inv_clusters(np, pipe, w.corpus))
    digest = _digest(torch, sess.state.params().values())
    name = f"T={tile}" + (" sharded" if shard else "") + (
        f" {workers} thread workers" if workers else "")
    _line("frontends", workload="node2vec", run=name, backend=sess.backend,
          kernel=kernel, launches=launches[kernel], batches=batches,
          S=cfg.sentences_per_batch,
          s_per_step=f"{sess.wall_seconds / batches:.4f}",
          words_per_s=f"{sess.words_per_sec:.0f}",
          host_batching_s_per_step=f"{pipe.stats.seconds / batches:.4f}",
          host_wait_s_per_step=f"{sess.fetch_seconds / batches:.4f}",
          separation=f"{q['separation']:.4f}",
          communities=NODE2VEC["communities"], digest=digest[:16])
    return sess, launches[kernel], digest


def node2vec_parity(torch, np, args, sessions) -> dict:
    """K1, K2, K3 and K4 each against its plain version on the first
    ``PARITY_WALKS`` walks of the node2vec runs' first batch (K4 on the
    sharded run's exchange, the table split by its placement), from
    seeded random tables; returns the max abs error by kernel."""
    from repro_torch.distributed.vocab_placement import plan_exchange
    from repro_torch.kernels import fullw2v, ops, ref, registry

    errs = {}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    for tile in (1, 8):
        sess = sessions[tile, False]
        cfg, pipe = sess.cfg, sess.pipeline
        batch = _head(next(pipe.batches(pad_len=cfg.resolved_pad_len,
                                        epoch=0)), PARITY_WALKS)
        step = batch.step_inputs(cfg.lr, torch.device("cuda"))
        static = ops.static_for(cfg, step.tile)
        shape = (pipe.table_rows, cfg.dim)
        w = [(torch.rand(shape, generator=gen, device="cuda") - 0.5)
             / cfg.dim for _ in range(2)]
        want = [t.clone() for t in w]
        registry.get("torch_tiled" if tile > 1 else "torch").update(
            *want, step, static)
        for name in (("cuda", "cuda_pipelined") if tile == 1
                     else ("cuda_tiled",)):
            got = [t.clone() for t in w]
            registry.get(name).update(*got, step, static)
            torch.cuda.synchronize()
            errs[name] = max(_check_close(torch, f"node2vec {name} {part}",
                                          g, x)
                             for part, g, x in zip(("w_in", "w_out"), got,
                                                   want))
    sess = sessions[8, True]
    cfg, pipe, pl = sess.cfg, sess.pipeline, sess.placement
    batch = _head(next(pipe.batches(pad_len=cfg.resolved_pad_len,
                                    epoch=0)), PARITY_WALKS)
    step = plan_exchange(batch, pl).step_inputs(cfg.lr,
                                                torch.device("cuda"))
    static = ops.static_for(cfg, step.tile)
    full = [((torch.rand((pipe.table_rows, cfg.dim), generator=gen,
                         device="cuda") - 0.5) / cfg.dim).cpu().numpy()
            for _ in range(2)]
    (hot_in, cold_in), (hot_out, cold_out) = (
        [torch.from_numpy(a).cuda() for a in pl.split(t)] for t in full)
    run = ops._VocabShardedRun("cuda_tiled", static, pl, exchange="exact")
    route = run.route(step)
    split = (hot_in, hot_out, run.gather(route, cold_in),
             run.gather(route, cold_out))
    args4 = (step.tokens, step.negs, step.lengths, step.lr, static.w_f,
             static.tile, step.plan_uniq, step.plan_scatter,
             step.plan_ucount, step.plan_strict)
    want = [t.clone() for t in split]
    ref.batch_sgns_tiled_fused_ref(*want, *args4,
                                   gemm_windows=static.gemm_windows)
    got = [t.clone() for t in split]
    fullw2v.fullw2v_cuda_tiled_fused(*got, *args4,
                                     gemm_windows=static.gemm_windows)
    torch.cuda.synchronize()
    errs["cuda_tiled_fused"] = max(
        _check_close(torch, f"node2vec cuda_tiled_fused {part}", g, x)
        for part, g, x in zip(("hot_in", "hot_out", "got_in", "got_out"),
                              got, want))
    _line("frontends", workload="node2vec", parity=f"first {PARITY_WALKS} "
          f"walks of the first batch", atol=ATOL, rtol=RTOL,
          **{f"{k}_max_abs_err": f"{v:.3e}" for k, v in errs.items()})
    return errs


def frontend_mesh_rank(mesh, corpus, cfg_kw: dict) -> dict:
    """On each of 2 gloo ranks: node2vec vocab-sharded (one shard a rank,
    the exact exchange) at T=8, one epoch, twice; each run must launch K4
    once per batch and the two runs' gathered tables must hash alike."""
    import torch

    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.kernels import _build, fullw2v

    _build.load()
    cfg = W2VConfig(**cfg_kw)
    vocab, runs = None, []
    for _ in range(2):
        pipe = BatchingPipeline(corpus, cfg, vocab=vocab)
        vocab = pipe.vocab
        sess = TrainSession(pipe, cfg, backend="auto", mesh=mesh)
        fullw2v.reset_launch_counts()
        sess.train()
        n = fullw2v.LAUNCHES["cuda_tiled_fused"]
        if n != sess.state.batches_seen or sum(fullw2v.LAUNCHES.values()) != n:
            raise AssertionError(f"rank {mesh.rank}: {dict(fullw2v.LAUNCHES)}"
                                 f" for {sess.state.batches_seen} batches")
        runs.append(dict(digest=_digest(torch, sess.gathered_params()
                                        .values()),
                         launches=n, batches=sess.state.batches_seen,
                         s_per_step=sess.wall_seconds
                         / sess.state.batches_seen,
                         host_batching_s_per_step=pipe.stats.seconds
                         / sess.state.batches_seen))
    launches = _all_ranks(mesh, [r["launches"] for r in runs])
    return dict(runs=runs, launches=launches)


def node2vec_mesh(args, w) -> dict:
    """The 2-rank sharded node2vec run (K4) twice on the one card."""
    from repro_torch.launch.mesh import start_ranks

    cfg = dataclasses.replace(w.cfg, tile_windows=8, vocab_shard=True,
                              tables="shards=2,exchange=exact")
    t0 = time.perf_counter()
    res = start_ranks(frontend_mesh_rank, 2, "cuda", w.corpus,
                      dataclasses.asdict(cfg), timeout=600)
    a, b = res["runs"]
    if a["digest"] != b["digest"]:
        raise AssertionError("node2vec 2-rank sharded run: a rerun's "
                             "digest differs")
    _line("frontends", workload="node2vec", run="N=2 gloo sharded exact T=8",
          kernel="cuda_tiled_fused", launches_by_rank=res["launches"],
          s_per_step=f"{a['s_per_step']:.4f}",
          host_batching_s_per_step=f"{a['host_batching_s_per_step']:.4f}",
          rerun_digest="same", digest=a["digest"][:16],
          seconds=f"{time.perf_counter() - t0:.1f}")
    return {"N=2 sharded T=8 (by rank, by run)": res["launches"]}


def plain_frontend_run(torch, np, args, name: str, knobs: dict, S: int,
                       tile: int) -> dict:
    """One batch of a doc2vec or subword workload through ``TrainSession``
    (``auto``), twice: it must resolve to the plain version, keep its
    tables on the card, launch no CUDA kernel, stay finite and give the
    same digest both times."""
    from repro_torch import frontends
    from repro_torch.core.trainer import TrainSession
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.kernels import fullw2v

    t0 = time.perf_counter()
    cfg = dataclasses.replace(make_config(args, tile), sentences_per_batch=S)
    w = frontends.get(name).build(cfg, **knobs, seed=args.seed)
    build_s = time.perf_counter() - t0
    want = "torch_tiled" if tile > 1 else "torch"
    pipe = BatchingPipeline(w.corpus, w.cfg)
    t0 = time.perf_counter()
    w.attach(pipe)
    prepare_s = time.perf_counter() - t0
    digests, steps = [], []
    for _ in range(2):            # the run, then a rerun on the same batches
        host0 = pipe.stats.seconds
        sess = TrainSession(pipe, w.cfg, backend="auto", device="cuda")
        dev = sess.state.w_in.device
        if sess.backend != want or dev.type != "cuda":
            raise AssertionError(f"{name} T={tile} resolved to "
                                 f"{sess.backend} on {dev}")
        fullw2v.reset_launch_counts()
        sess.train(max_batches=1)
        if any(fullw2v.LAUNCHES.values()):
            raise AssertionError(f"{name}: a CUDA kernel ran "
                                 f"({dict(fullw2v.LAUNCHES)})")
        for part, t in sess.state.params().items():
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} {part} has non-finite values")
        digests.append(_digest(torch, sess.state.params().values()))
        steps.append(dict(s=sess.wall_seconds, words=sess.state.words_seen,
                          host=pipe.stats.seconds - host0))
        del sess
    if digests[0] != digests[1]:
        raise AssertionError(f"{name} T={tile}: a rerun's digest differs")
    windows = steps[0]["words"]
    out = dict(backend=want, device=str(dev), S=S, windows=windows,
               s_per_step=steps[0]["s"], rerun_s_per_step=steps[1]["s"],
               ms_per_window=steps[0]["s"] * 1e3 / windows,
               host_batching_s_per_step=steps[0]["host"],
               vocab=pipe.vocab.size, extra_rows=pipe.extra_rows)
    _line("frontends", workload=name, T=tile, backend=want, device=dev,
          S=S, vocab=pipe.vocab.size, extra_rows=pipe.extra_rows,
          tables_gb=f"{2 * pipe.table_rows * w.cfg.dim * 4 / 1e9:.3f}",
          s_per_step=f"{steps[0]['s']:.3f}",
          rerun_s_per_step=f"{steps[1]['s']:.3f}",
          ms_per_window=f"{out['ms_per_window']:.4f}", windows=windows,
          host_batching_s_per_step=f"{steps[0]['host']:.4f}",
          build_seconds=f"{build_s:.1f}", prepare_seconds=f"{prepare_s:.1f}",
          rerun_digest="same", digest=digests[0][:16])
    return out


def baselines_quality(torch, np, args, f32_8_epochs: float) -> dict:
    """The pWord2Vec-like baseline (``core.baselines.matrix_sgns``, plain
    torch) on the card at bench_quality's shape (d=64, S=128, L=48, 8
    clusters of 16 words, 400 sentences, 4 epochs) beside K2 on the same
    batches from the same tables and learning rates: the reference's
    ``quality/equivalence`` row (separation ratio ≈ 1.0 expected, no
    gate)."""
    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.core.baselines import matrix_sgns
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import init_state
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus
    from repro_torch.kernels import fullw2v, ops, registry

    corpus = synthetic_cluster_corpus(n_clusters=8, words_per_cluster=16,
                                      n_sentences=400, mean_len=14, seed=0)
    cfg = W2VConfig(dim=64, window=5, negatives=5, epochs=4, min_count=1,
                    subsample_t=0.0, sentences_per_batch=128,
                    max_sentence_len=48, seed=args.seed)
    k2 = registry.get("cuda_pipelined")
    out = {}
    for name in ("matrix_sgns", "cuda_pipelined"):
        pipe = BatchingPipeline(corpus, cfg)
        st = init_state(pipe.vocab.size, cfg, cfg.seed, "cuda")
        words, total = 0, pipe.epoch_words * cfg.epochs
        fullw2v.reset_launch_counts()
        t0 = time.perf_counter()
        for ep in range(cfg.epochs):
            for b in pipe.batches(pad_len=48, epoch=ep):
                lr = cfg.lr * max(1 - words / total, cfg.min_lr_frac)
                step = b.step_inputs(lr, torch.device("cuda"))
                if name == "matrix_sgns":
                    matrix_sgns(st.w_in, st.w_out, step.tokens, step.negs,
                                step.lengths, step.lr, cfg.fixed_window)
                else:
                    k2.update(st.w_in, st.w_out, step, ops.static_for(cfg))
                words += b.n_words
        torch.cuda.synchronize()
        launches = dict(fullw2v.LAUNCHES)
        if name == "matrix_sgns" and any(launches.values()):
            raise AssertionError(f"matrix_sgns launched {launches}")
        q = evaluate(st.w_in.cpu().numpy(), _inv_clusters(np, pipe, corpus),
                     seed=1)
        out[name] = dict(separation=q["separation"],
                         seconds=time.perf_counter() - t0,
                         launches=launches["cuda_pipelined"])
    ratio = out["cuda_pipelined"]["separation"] / max(
        out["matrix_sgns"]["separation"], 1e-9)
    out["ratio"] = ratio
    _line("baselines", shape="bench_quality (d=64 S=128 L=48 4 epochs)",
          matrix_sgns_separation=f"{out['matrix_sgns']['separation']:.4f}",
          matrix_sgns_seconds=f"{out['matrix_sgns']['seconds']:.1f}",
          k2_separation=f"{out['cuda_pipelined']['separation']:.4f}",
          k2_launches=out["cuda_pipelined"]["launches"],
          fullw2v_vs_pword2vec_ratio=f"{ratio:.4f}",
          expected="about 1.0 (no gate)",
          phase9_f32_k2_8_epochs_separation=f"{f32_8_epochs:.4f}")
    return out


def phase_frontends(torch, np, args, f32_8_epochs: float) -> dict:
    """Phase 11; returns node2vec's launches by kernel and run."""
    t0 = time.perf_counter()
    w = node2vec_workload(args)
    sessions, launches, digests, vocab = {}, {}, {}, None
    for tile, shard, expect, kernel in NODE2VEC_RUNS:
        sess, n, digests[tile, shard] = node2vec_run(
            torch, np, args, w, tile, shard, expect, kernel, vocab=vocab)
        vocab = sess.pipeline.vocab
        sessions[tile, shard] = sess
        launches.setdefault(kernel, {})[
            f"T={tile}" + (" sharded" if shard else "")] = n
    node2vec_parity(torch, np, args, sessions)
    _, n, digest = node2vec_run(torch, np, args, w, 8, False, "cuda_tiled",
                                "cuda_tiled", vocab=vocab, workers=2)
    if digest != digests[8, False]:
        raise AssertionError("node2vec T=8 with 2 thread workers: the "
                             "digest differs from the synchronous run's")
    launches["cuda_tiled"]["T=8 2 thread workers"] = n
    del sessions
    launches["cuda_tiled_fused"].update(node2vec_mesh(args, w))
    del w
    plain = {}
    for name, knobs, S in (("doc2vec", DOC2VEC, DOC2VEC_S),
                           ("subword", SUBWORD, SUBWORD_S)):
        for tile in (1, 8):
            plain[name, tile] = plain_frontend_run(torch, np, args, name,
                                                   knobs, S, tile)
    torch.cuda.empty_cache()
    base = baselines_quality(torch, np, args, f32_8_epochs)
    _line("frontends", seconds=f"{time.perf_counter() - t0:.1f}")
    return dict(launches=launches, plain=plain, baselines=base)


# ---------------------------------------------------------------------------
# phase 12: serving the trained tables (repro_torch.serve)
# ---------------------------------------------------------------------------

SERVE_K = 10
SERVE_QUERIES = 256
# (b): a seeded 2,000,000 x 128 f32 table (phase 11's subword row count),
# split at a 10% head, behind EmbeddingServer from 8 client threads
SERVE_ROWS, SERVE_HOT_FRAC = 2_000_000, 0.1
SERVE_BATCHES = (32, 256)
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_WINDOW = 8, 2000, 64


def _serve_queries(np, seed: int, v: int, hot: int):
    """256 random nn ids plus the boundary ids, and 256 analogy rows."""
    rng = np.random.default_rng(seed)
    ids = np.concatenate([rng.integers(v, size=SERVE_QUERIES),
                          [0, hot - 1, hot, hot + 1, v - 1]])
    tri = rng.integers(v, size=(SERVE_QUERIES, 3))
    return ids.astype(np.int32), tri.astype(np.int32)


def _f64_check(np, emb, q, mode: str, got_ids, got_sc) -> int:
    """The card's top-k against a float64 recompute on the host from the
    same normalized table: every score within 1e-5 of the f64 score of its
    id, every id equal to the f64 ranking's except where the two f64
    scores differ by less than 1e-6 (a near tie); returns those places."""
    e = emb.astype(np.float64)
    if mode == "nn":
        qv, excl = e[q], q[:, None]
    else:
        qv = e[q[:, 0]] - e[q[:, 1]] + e[q[:, 2]]
        qv /= np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-12)
        excl = q
    sc = qv @ e.T
    sc[np.arange(len(q))[:, None], excl] = -np.inf
    want = np.argsort(-sc, axis=1, kind="stable")[:, :got_ids.shape[1]]
    got64 = np.take_along_axis(sc, got_ids.astype(np.int64), 1)
    err = float(np.abs(got_sc - got64).max())
    if err > 1e-5:
        raise AssertionError(f"{mode}: a score is {err:.3e} from its f64 "
                             f"recompute (limit 1e-5)")
    diff = got_ids != want
    far = diff & (np.abs(got64 - np.take_along_axis(sc, want, 1)) >= 1e-6)
    if far.any():
        raise AssertionError(f"{mode}: {int(far.sum())} ids differ from the "
                             f"f64 ranking by more than a near tie")
    return int(diff.sum())


def _same_answers(np, name, got, want, tol=1e-6) -> None:
    gi, gs = (np.asarray(x) for x in got)
    wi, ws = (np.asarray(x) for x in want)
    if not np.array_equal(gi, wi):
        bad = np.argwhere(gi != wi)[:4].tolist()
        raise AssertionError(f"{name}: ids differ at {bad}")
    err = float(np.abs(gs - ws).max())
    if err > tol:
        raise AssertionError(f"{name}: scores {err:.3e} apart (limit "
                             f"{tol})")


def serve_trained(torch, np, args, sessions, tmp) -> dict:
    """(a) Checkpoints of the trained sessions served through
    ``EmbeddingIndex.load`` on the card, and ``from_session`` on the live
    sessions; returns the split checkpoint's directory and step."""
    from repro_torch.serve import EmbeddingIndex, dense_topk, make_topk_fn
    from repro_torch.kernels import quant
    from repro_torch.train import checkpoint as ckpt

    dirs = {}
    for name, sess in sessions:
        d = dirs[name] = os.path.join(tmp, name.split()[0])
        sess.ckpt_dir = d
        t0 = time.perf_counter()
        sess.save_checkpoint()
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        idx = EmbeddingIndex.load(d, device="cuda:0")
        load_ms = (time.perf_counter() - t0) * 1e3
        live = EmbeddingIndex.from_session(sess)
        emb = idx.dense_embeddings()
        dense_dev = torch.from_numpy(emb).to(idx.device)
        hot = idx.placement.hot
        ids, tri = _serve_queries(np, args.seed, idx.vocab_size, hot)
        near, ms = {}, {}
        for mode, q in (("nn", ids), ("analogy", tri)):
            fn = make_topk_fn(idx.placement, None, mode=mode, k=SERVE_K)
            got = tuple(t.cpu().numpy() for t in fn(idx.hot, idx.cold, q))
            _same_answers(np, f"{name} {mode} vs dense_topk on the card",
                          got, dense_topk(dense_dev, q, SERVE_K, mode))
            lfn = make_topk_fn(live.placement, None, mode=mode, k=SERVE_K)
            _same_answers(np, f"{name} {mode} from_session vs load", got,
                          tuple(t.cpu().numpy() for t in lfn(
                              live.hot, live.cold, q)))
            near[mode] = _f64_check(np, emb, q, mode, *got)
            qd = torch.from_numpy(q).to(idx.device)
            ms[mode] = _time_ms(torch, lambda: fn(idx.hot, idx.cold, qd), 5)
        extra = {}
        leaves, _ = ckpt.peek(d)
        if "scale_in" in leaves:
            # the int8 tail decoded on the card against the CPU, bit for
            # bit, and the two staged indexes within 1e-6
            spec = {k: ckpt.ArraySpec(tuple(leaves[k]["shape"]),
                                      leaves[k]["dtype"])
                    for k in ("cold_in", "scale_in")}
            dec = [quant.int8_decode(t["cold_in"], t["scale_in"]).cpu()
                   for t in (ckpt.restore(d, spec, device=dv)[0]
                             for dv in ("cuda:0", "cpu"))]
            if not torch.equal(dec[0], dec[1]):
                raise AssertionError(f"{name}: int8 decode on the card "
                                     f"differs from the CPU's")
            cpu = EmbeddingIndex.load(d, device="cpu")
            extra = dict(int8_decode="card==cpu bit for bit",
                         index_card_vs_cpu=float(np.abs(
                             cpu.dense_embeddings() - emb).max()))
            if extra["index_card_vs_cpu"] > 1e-6:
                raise AssertionError(f"{name}: staged index card vs CPU "
                                     f"{extra['index_card_vs_cpu']:.3e}")
        _line("serve", table=json.dumps(name), step=idx.step,
              vocab=idx.vocab_size, hot=hot, dim=idx.dim,
              leaves=",".join(sorted(leaves)), save_ms=f"{save_ms:.1f}",
              load_ms=f"{load_ms:.1f}",
              nn_ms=f"{ms['nn']:.3f}", analogy_ms=f"{ms['analogy']:.3f}",
              batch=len(ids), k=SERVE_K,
              parity="ids==dense_topk(card) scores<=1e-6; "
                     "from_session==load",
              f64_near_ties=f"nn:{near['nn']},analogy:{near['analogy']}",
              **extra)
    return dirs


class _TopkSpy:
    """Times, with CUDA events, every top-k the server dispatches
    (``repro_torch.serve.server._topk``, which ends in the answers' copy
    to the host)."""

    def __init__(self, torch):
        from repro_torch.serve import server
        self.torch, self.mod, self.real = torch, server, server._topk
        self.ms, self.rows = [], []

    def __enter__(self):
        torch = self.torch

        def timed(fns, index, kind, k, ids):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.real(fns, index, kind, k, ids)
            b.record()
            b.synchronize()
            self.ms.append(a.elapsed_time(b))
            self.rows.append(len(ids))
            return out
        self.mod._topk = timed
        return self

    def __exit__(self, *exc):
        self.mod._topk = self.real


def _drive(np, server, seed: int, t_log=None):
    """8 client threads, each keeping SERVE_WINDOW one-id nn requests in
    flight until it has asked SERVE_PER_CLIENT; returns the wall seconds
    and a sample of (ids, result) to check. ``t_log`` collects (submit
    time, latency µs) of every request."""
    import threading

    sample, errors = [], []

    def client(c):
        try:
            rng = np.random.default_rng(seed * 100 + c)
            ids = rng.integers(SERVE_ROWS, size=SERVE_PER_CLIENT)
            for at in range(0, SERVE_PER_CLIENT, SERVE_WINDOW):
                chunk = ids[at:at + SERVE_WINDOW].astype(np.int32)
                reqs = [(time.perf_counter(), server.submit("nn", [i]))
                        for i in chunk]
                res = [(t, r.wait(120.0)) for t, r in reqs]
                if t_log is not None:
                    t_log.extend((t, x.latency_us) for t, x in res)
                if at == 0:
                    sample.append((chunk[:1], res[0][1]))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving clients failed: {errors[:2]}")
    return wall, sample


def serve_parts(torch, np, idx) -> dict:
    """Device ms of each part of one batch's top-k over the big index, at
    each batch size (CUDA events, 5 runs): the product, the int64 ranking
    key, ``torch.topk`` over the keys, and the whole function."""
    from repro_torch.serve import make_topk_fn
    from repro_torch.serve.query import _joined, _order_key, _scores

    table = _joined(idx.hot, idx.cold)
    gids = torch.arange(table.shape[0], dtype=torch.int32,
                        device=table.device)
    out = {}
    for b in SERVE_BATCHES:
        ids = torch.from_numpy(np.random.default_rng(b).integers(
            idx.vocab_size, size=b).astype(np.int32)).to(table.device)
        q = table[ids.long()]
        sc = _scores(q, table)
        key = _order_key(sc, gids)
        fn = make_topk_fn(idx.placement, None, mode="nn", k=SERVE_K)
        out[b] = parts = dict(
            product=_time_ms(torch, lambda: _scores(q, table), 5),
            key=_time_ms(torch, lambda: _order_key(sc, gids), 5),
            topk=_time_ms(torch, lambda: torch.topk(
                key, SERVE_K, dim=-1, largest=False), 5),
            whole=_time_ms(torch, lambda: fn(idx.hot, idx.cold, ids), 5))
        del sc, key
        _line("serve", parts=f"B={b} V={idx.vocab_size}", **{
            f"{k}_ms": f"{v:.3f}" for k, v in parts.items()})
    return out


def serve_load(torch, np, args, tmp) -> dict:
    """(b) A 2,000,000-row table behind EmbeddingServer at batch 32 and
    256, then a second publish hot-swapped while queries flow."""
    from repro_torch.distributed.vocab_placement import VocabPlacement
    from repro_torch.serve import EmbeddingServer, SnapshotWatcher
    from repro_torch.serve.index import EmbeddingIndex
    from repro_torch.train import checkpoint as ckpt

    d = os.path.join(tmp, "big")
    dim = 128
    pl = VocabPlacement(vocab_size=SERVE_ROWS,
                        hot=int(SERVE_HOT_FRAC * SERVE_ROWS), n_shards=1)
    tables = {1: np.random.default_rng(args.seed + 12).standard_normal(
        (SERVE_ROWS, dim), dtype=np.float32)}

    def publish(step):
        h, c = pl.split(tables[step])
        t0 = time.perf_counter()
        ckpt.save(d, step, {"hot_in": h, "cold_in": c},
                  extra={"vocab_shard": pl.to_extra(), "batches_seen": step})
        return time.perf_counter() - t0

    stage_ms, flips = [], {}

    def loader(*a, **kw):
        t0 = time.perf_counter()
        idx = EmbeddingIndex.load(*a, **kw)
        stage_ms.append((time.perf_counter() - t0) * 1e3)
        return idx

    publish_s = publish(1)
    nbytes = SERVE_ROWS * dim * 4
    watcher = SnapshotWatcher(d, poll_s=0.05, loader=loader, device="cuda:0",
                              on_swap=lambda old, new: flips.setdefault(
                                  new.step, time.perf_counter()))
    watcher.start()
    try:
        watcher.wait_ready(timeout=300)
        out = {}
        for b in SERVE_BATCHES:
            server = EmbeddingServer(watcher, batch_size=b, deadline_ms=2.0,
                                     k=SERVE_K)
            with _TopkSpy(torch) as spy:
                wall, sample = _drive(np, server, b)
            server.close()
            lat = np.asarray(server.latencies_us, np.float64)
            rows = float(np.mean(spy.rows))
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           2 * rows * SERVE_ROWS * dim / F32_FLOPS_PER_S) * 1e3
            out[b] = dict(qps=server.served / wall,
                          p50_us=float(np.percentile(lat, 50)),
                          p99_us=float(np.percentile(lat, 99)),
                          batches=server.batches, rows_per_batch=rows,
                          device_ms=float(np.mean(spy.ms)),
                          bound_ms=bound_ms)
            _line("serve", load=f"V={SERVE_ROWS} d={dim}", batch_size=b,
                  deadline_ms=2.0, k=SERVE_K, clients=SERVE_CLIENTS,
                  queries=server.served, qps=f"{out[b]['qps']:.1f}",
                  p50_us=f"{out[b]['p50_us']:.1f}",
                  p99_us=f"{out[b]['p99_us']:.1f}", batches=server.batches,
                  rows_per_batch=f"{rows:.2f}",
                  device_ms_per_batch=f"{out[b]['device_ms']:.3f}",
                  bound_ms=f"{bound_ms:.3f}",
                  bound_by=("bytes" if nbytes / HBM_BYTES_PER_S >= 2 * rows
                            * SERVE_ROWS * dim / F32_FLOPS_PER_S
                            else "operations"))
            checks = sample[:8]
        out["parts"] = serve_parts(torch, np, watcher.current())
        # a second publish while queries flow at batch 32
        tables[2] = np.roll(tables[1], 1, axis=0)
        server = EmbeddingServer(watcher, batch_size=SERVE_BATCHES[0],
                                 deadline_ms=2.0, k=SERVE_K)
        log = []
        swap = {}

        def publisher():
            time.sleep(0.5)
            swap["start"] = time.perf_counter()
            swap["publish_s"] = publish(2)
            swap["published"] = time.perf_counter()

        import threading
        pub = threading.Thread(target=publisher)
        pub.start()
        deadline = time.monotonic() + 300
        while 2 not in flips and time.monotonic() < deadline:
            _drive(np, server, 7, t_log=log)       # load until the flip
        pub.join(300)
        server.close()
        if 2 not in flips:
            raise AssertionError("the second publish was never swapped in")
        # requests submitted from the publish's start to the flip, and
        # apart: while the publisher writes, while the watcher stages
        during = [us for t, us in log if swap["start"] <= t <= flips[2]]
        writing = [us for t, us in log
                   if swap["start"] <= t < swap["published"]]
        staging = [us for t, us in log
                   if swap["published"] <= t <= flips[2]]
        swap_ms = (flips[2] - swap["published"]) * 1e3
        # 16 answers against the host oracle: 8 from step 1, 8 from step 2
        after = EmbeddingServer(watcher, batch_size=8, deadline_ms=2.0,
                                k=SERVE_K)
        q2 = np.random.default_rng(args.seed + 13).integers(
            SERVE_ROWS, size=8).astype(np.int32)
        r2 = after.neighbors(q2, timeout=60)
        after.close()
        near = 0
        for step, q, ids, sc in (
                [(1, np.concatenate([c[0] for c in checks]),
                  np.concatenate([c[1].ids for c in checks]),
                  np.concatenate([c[1].scores for c in checks]))]
                + [(r2.snapshot_step, q2, r2.ids, r2.scores)]):
            emb = tables[step] / np.maximum(np.linalg.norm(
                tables[step], axis=1, keepdims=True), 1e-12)
            near += _f64_check(np, emb, q, "nn", ids, sc)
        if r2.snapshot_step != 2 or any(c[1].snapshot_step != 1
                                        for c in checks):
            raise AssertionError("answers from an unexpected snapshot")
        def p99(x):
            return float(np.percentile(x, 99)) if x else float("nan")

        out["swap"] = dict(publish_s=swap["publish_s"],
                           stage_ms=stage_ms[-1], swap_ms=swap_ms,
                           p99_during_us=p99(during),
                           queries_during=len(during))
        _line("serve", swap=f"step 1 -> 2 under load (batch "
                            f"{SERVE_BATCHES[0]})",
              publish_s=f"{swap['publish_s']:.2f}",
              first_publish_s=f"{publish_s:.2f}",
              stage_ms=f"{stage_ms[-1]:.1f}",
              first_stage_ms=f"{stage_ms[0]:.1f}",
              swap_ms=f"{swap_ms:.1f}",
              p99_during_us=f"{out['swap']['p99_during_us']:.1f}",
              queries_during=len(during),
              p99_while_writing_us=f"{p99(writing):.1f}",
              p99_while_staging_us=f"{p99(staging):.1f}", oracle_checked=16,
              f64_near_ties=near)
        return out
    finally:
        watcher.stop()


def serve_chaos(torch, args) -> dict:
    """(c) The ``ci`` serve chaos schedule on the card, then the same at
    d=128, V=65,532, hot 6,553, written at 2 shards."""
    from repro_torch.serve.chaos import SCHEDULES, run_serve_chaos

    out = {}
    ci = SCHEDULES["ci"]
    for name, sched in (("ci", ci), ("ci d=128 V=65532", dataclasses.replace(
            ci, vocab_size=65_532, hot=6_553, dim=128, train_shards=2))):
        rep = run_serve_chaos(sched, timeout=120.0, device="cuda:0")
        want_final = 10 * len(sched.publish_at)
        if (rep["dropped"] or rep["torn"] or rep["errors"]
                or rep["crashes"] != len(sched.crash_at)
                or rep["crashes_fired"] != len(sched.crash_at)
                or rep["final_step_served"] != want_final):
            raise AssertionError(f"serve chaos {name}: {rep}")
        out[name] = rep
        _line("serve", chaos=json.dumps(name), **{
            k: rep[k] for k in ("queries", "dropped", "torn", "errors",
                                "swaps", "crashes", "load_failures",
                                "steps_served", "final_step_served",
                                "batches", "wall_seconds")})
    return out


def serve_mesh_rank(mesh, swap_dir: str, first: int, seed: int) -> dict:
    """(d) One rank of the serving mesh on the card: rank 0 serves (a)'s
    split checkpoint re-striped to N ranks behind a watcher, the others
    follow; a publish every rank loads, then one only rank 1 fails to
    load. Returns rank 0's answers and every rank's step, swaps, load
    failures, top-k and collective ms per batch."""
    import numpy as np
    import torch

    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.vocab_placement import VocabPlacement
    from repro_torch.serve import EmbeddingIndex, EmbeddingServer
    from repro_torch.serve import server as server_mod
    from repro_torch.serve.chaos import _publish
    from repro_torch.serve.snapshot import SnapshotWatcher

    timing = {"topk": [], "coll": []}
    real_topk = server_mod._topk

    def timed_topk(*a):
        t0 = time.perf_counter()
        out = real_topk(*a)
        timing["topk"].append((time.perf_counter() - t0) * 1e3)
        return out

    def timed(op):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = op(*a, **kw)
            torch.cuda.synchronize()
            timing["coll"].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    server_mod._topk = timed_topk
    for name in ("psum", "all_gather", "broadcast"):
        setattr(coll, name, timed(getattr(coll, name)))

    def loader(d, step=None, mesh=None, device=None):
        if mesh.rank == 1 and step == first + 20:
            raise OSError("injected load fault on rank 1")
        return EmbeddingIndex.load(d, step=step, mesh=mesh, device=device)

    w = SnapshotWatcher(swap_dir, mesh=mesh, poll_s=0.05, loader=loader)
    out = {}
    if mesh.rank == 0:
        w.start()
        idx = w.wait_ready(timeout=120)
        v, hot = idx.vocab_size, idx.placement.hot
        server = EmbeddingServer(w, batch_size=16, deadline_ms=2.0,
                                 k=SERVE_K)

        def ask(tag):
            # requests of 16 rows at batch_size 16: one request a batch,
            # so the batches are the same in every run
            ids, tri = _serve_queries(np, seed + len(out), v, hot)
            reqs = ([("nn", ids[i:i + 16]) for i in range(0, 64, 16)]
                    + [("analogy", tri[i:i + 16]) for i in range(0, 32, 16)])
            handles = [(k, q, server.submit(k, q)) for k, q in reqs]
            out[tag] = [(k, q, r.wait(120)) for k, q, r in handles]

        ask("first")
        table = np.random.default_rng(seed + 20).standard_normal(
            (v, idx.dim)).astype(np.float32)
        pl = VocabPlacement(vocab_size=v, hot=hot, n_shards=2)
        _publish(swap_dir, first + 10, table, pl)
        deadline = time.monotonic() + 120
        while w.current().step != first + 10:
            if time.monotonic() > deadline:
                raise TimeoutError("swap to the second publish")
            time.sleep(0.01)
        ask("swapped")
        fails = w.load_failures
        _publish(swap_dir, first + 20, table[::-1].copy(), pl)
        while w.load_failures < fails + 2:
            if time.monotonic() > deadline:
                raise TimeoutError("the refused publish")
            time.sleep(0.01)
        ask("refused")
        w.stop()
        server.close()
        stats = {"swaps": w.swaps, "load_failures": w.load_failures,
                 "batches": server.batches}
    else:
        stats = server_mod.serve_follower(w, mesh)
    server_mod._topk = real_topk
    ranks = _all_ranks(mesh, dict(
        step=w.current().step, swaps=stats["swaps"],
        load_failures=stats["load_failures"], batches=stats["batches"],
        topk_ms=float(np.mean(timing["topk"])),
        coll_ms_per_batch=float(np.sum(timing["coll"])) / stats["batches"]))
    out = {tag: [(k, q, r.ids, r.scores, r.snapshot_step)
                 for k, q, r in res] for tag, res in out.items()}
    return dict(answers=out, ranks=ranks, backend=mesh.backend)


def serve_mesh(torch, np, args, split_dir: str, tmp: str) -> dict:
    """(d) N=2 and N=4 gloo ranks on the one card serve (a)'s split
    checkpoint; every answer equals the one-rank run's."""
    from repro_torch.launch.mesh import start_ranks
    from repro_torch.serve import EmbeddingIndex, make_topk_fn
    from repro_torch.train import checkpoint as ckpt

    out = {}
    for n in (2, 4):
        d = os.path.join(tmp, f"mesh{n}")
        shutil.copytree(split_dir, d)
        t0 = time.perf_counter()
        first = ckpt.latest_step(d)
        res = start_ranks(serve_mesh_rank, n, "cuda", d, first, args.seed,
                          timeout=600)
        seconds = time.perf_counter() - t0
        steps = {"first": first, "swapped": first + 10,
                 "refused": first + 10}
        one = {}
        for tag, answers in res["answers"].items():
            step = steps[tag]
            if step not in one:
                one[step] = EmbeddingIndex.load(d, step=step,
                                                device="cuda:0")
            idx = one[step]
            for kind, q, ids, sc, got_step in answers:
                if got_step != step:
                    raise AssertionError(f"N={n} {tag}: answered from step "
                                         f"{got_step}, want {step}")
                fn = make_topk_fn(idx.placement, None, mode=kind, k=SERVE_K)
                want = tuple(t.cpu().numpy()
                             for t in fn(idx.hot, idx.cold, q))
                _same_answers(np, f"N={n} {tag} {kind} vs one rank",
                              (ids, sc), want)
        ranks = res["ranks"]
        if {r["step"] for r in ranks} != {first + 10} or \
                {r["swaps"] for r in ranks} != {2} or \
                len({r["load_failures"] for r in ranks}) != 1 or \
                ranks[0]["load_failures"] < 2:
            raise AssertionError(f"N={n}: the swaps were not all-or-none: "
                                 f"{ranks}")
        out[n] = ranks
        _line("serve", ranks=n, backend=res["backend"],
              seconds=f"{seconds:.1f}",
              answers=sum(len(a) for a in res["answers"].values()),
              parity="ids==one rank, scores<=1e-6",
              swap="all ranks flipped; rank-1-only failure: none flipped",
              steps=[r["step"] for r in ranks],
              load_failures=[r["load_failures"] for r in ranks],
              batches=[r["batches"] for r in ranks],
              topk_ms=[f"{r['topk_ms']:.3f}" for r in ranks],
              coll_ms_per_batch=[f"{r['coll_ms_per_batch']:.3f}"
                                 for r in ranks],
              note="ranks share one card over gloo: no scaling is shown")
    return out


def serve_cli(split_dir: str) -> None:
    """(e) The serving CLI on the card against (a)'s split checkpoint."""
    env = dict(os.environ,
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--ckpt-dir",
         split_dir, "--queries", "256", "--mode", "both", "--check-oracle"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith(("serving:", "oracle_parity=", "serve_stats:"))]
    if r.returncode != 0 or not any(ln.startswith("oracle_parity=ok")
                                    for ln in lines):
        raise AssertionError(f"serve CLI exited {r.returncode}:\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    _line("serve", cli=json.dumps(" | ".join(lines)),
          seconds=f"{time.perf_counter() - t0:.1f}")


def phase_serve(torch, np, args, sessions) -> dict:
    """Phase 12: serve the trained tables, load at a users' vocabulary,
    chaos, ranks, the CLI."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        dirs = serve_trained(torch, np, args, sessions, tmp)
        load = serve_load(torch, np, args, tmp)
        torch.cuda.empty_cache()
        chaos = serve_chaos(torch, args)
        split = dirs[sessions[1][0]]
        mesh = serve_mesh(torch, np, args, split, tmp)
        serve_cli(split)
    _line("serve", seconds=f"{time.perf_counter() - t0:.1f}")
    return dict(load=load, chaos=chaos, mesh=mesh)


# ---------------------------------------------------------------------------
# phase 13: supervised recovery and chaos under a mesh (2 gloo ranks)
# ---------------------------------------------------------------------------

MESH_CHAOS_S = 2000            # phase 10's N=4 size (depth cut, not width)
# (name, T, kernel, sharding): data-parallel T=1 (auto: K2) and
# vocab-sharded exact T=8 (auto: K4)
MESH_CHAOS_RUNS = (("dp T=1", 1, "cuda_pipelined", {}),
                   ("sharded exact T=8", 8, "cuda_tiled_fused",
                    dict(vocab_shard=True, tables="shards=2,exchange=exact")))


@contextlib.contextmanager
def vote_spy():
    """Times each vote of the supervisors on this rank (host clock around
    ``TrainSupervisor._gather``), by kind: a batch's vote (a row of 5) or
    a restore's (a row of 2)."""
    from repro_torch.train.supervisor import TrainSupervisor

    real = TrainSupervisor._gather
    times = {"batch": [], "restore": []}

    def timed(self, row, own=None):
        t0 = time.perf_counter()
        try:
            return real(self, row, own)
        finally:
            times["batch" if len(row) == 5 else "restore"].append(
                time.perf_counter() - t0)

    TrainSupervisor._gather = timed
    try:
        yield times
    finally:
        TrainSupervisor._gather = real


def mesh_chaos_rank(mesh, args, frac: float, tmp: str) -> dict:
    """Phase 13 on one rank: ``run_chaos`` on the mesh with the ``ci``
    schedule (its rank-local faults on rank 1), once per run of
    ``MESH_CHAOS_RUNS``, launch counts zeroed before each and read after;
    every gate raises. Returns each run's launches by rank."""
    import numpy as np

    from repro_torch.kernels import _build, fullw2v
    from repro_torch.train.chaos import SCHEDULES, run_chaos

    _build.load()
    sched = SCHEDULES["ci"]
    # ~5 batches an epoch, so the 10-batch schedule crosses the boundary
    corpus = make_corpus(args, args.S * 9 // 2)
    launches = {}
    for name, tile, kernel, shard in MESH_CHAOS_RUNS:
        cfg = make_config(args, tile, **(dict(shard, hot_vocab_frac=frac)
                                         if shard else {}))
        fullw2v.reset_launch_counts()
        with vote_spy() as votes:
            r = run_chaos(sched, backend="auto", cfg=cfg, corpus=corpus,
                          mesh=mesh,
                          ckpt_dir=os.path.join(tmp, name.replace(" ", "_")))
        # the baseline's batches, then every batch the faulted run trained
        mine = _launched(kernel, sched.max_batches + r["batches_trained"])
        every = _all_ranks(mesh, mine)
        spied = _all_ranks(mesh, {
            "batch_vote_ms_median": 1e3 * float(np.median(votes["batch"])),
            "batch_vote_ms_max": 1e3 * max(votes["batch"]),
            "restore_vote_ms_mean": 1e3 * float(np.mean(votes["restore"]))})
        bad = []
        if r["digest_match"] != 1:
            bad.append("the faulted run's gathered tables differ from the "
                       "fault-free 2-rank run's")
        if r["faults_fired"] != r["faults_scheduled"]:
            bad.append(f"{r['faults_fired']}/{r['faults_scheduled']} faults")
        if r["reports_equal"] != 1:
            bad.append("the ranks' reports differ")
        if r["ckpt_quarantined"] < 1 or r["workers_killed"] < 1:
            bad.append(f"quarantined={r['ckpt_quarantined']} "
                       f"workers_killed={r['workers_killed']}")
        if bad:
            raise AssertionError(f"mesh chaos {name}: {'; '.join(bad)} "
                                 f"({r})")
        if mesh.rank == 0:
            for rank, (p, n, v) in enumerate(zip(r["per_rank"], every,
                                                 spied)):
                _line("mesh_chaos", run=name, rank=rank, kernel=kernel,
                      launches=n, votes=p["votes"],
                      vote_ms=f"{1e3 * p['vote_seconds'] / p['votes']:.3f}",
                      **{k: f"{x:.3f}" for k, x in v.items()},
                      probes=p["probes"],
                      probe_ms=f"{1e3 * p['probe_seconds'] / p['probes']:.3f}",
                      recovery_s=f"{p['recovery_seconds']:.3f}",
                      wall_s=f"{p['wall_seconds']:.3f}")
            _line("mesh_chaos", run=name, schedule="ci", fault_rank=1,
                  ranks=mesh.size, backend=f"{mesh.backend}@{mesh.device}",
                  S=cfg.sentences_per_batch, d=cfg.dim, T=tile,
                  workers="2xprocess", **{k: r[k] for k in (
                      "digest_match", "reports_equal", "faults_fired",
                      "faults_scheduled", "restarts", "rollbacks",
                      "health_failures", "ckpt_quarantined", "heals",
                      "workers_killed", "batches", "batches_trained")},
                  bitwise="==fault-free 2-rank run")
        launches.setdefault(kernel, {})[f"N=2 ci {name}"] = every
    return launches


def mesh_chaos_cli(tmp: str) -> None:
    """The train CLI on 2 ranks (``--vocab-shard 2``): with the resilience
    flags and checkpoints it prints the plain run's ``final_digest``."""
    env = dict(os.environ,
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    flags = ["--vocab", "8192", "--clusters", "64", "--sentences", "4000",
             "--sentences-per-batch", "1000", "--epochs", "1",
             "--max-batches", "4", "--vocab-shard", "2"]
    supervised = ["--max-restarts", "3", "--health-every", "1",
                  "--ckpt-dir", os.path.join(tmp, "cli"), "--ckpt-every", "2"]
    out = []
    t0 = time.perf_counter()
    for extra in ([], supervised):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "w2v",
             *flags, *extra], env=env, cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"train CLI exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
        out.append({ln.split(":")[0].split("=")[0]: ln
                    for ln in r.stdout.splitlines()
                    if ln.startswith(("final_digest=", "resilience:",
                                      "backend="))})
    plain, sup = out
    if (plain["final_digest"] != sup["final_digest"]
            or "resilience" not in sup or "resilience" in plain):
        raise AssertionError(f"resilience flags changed the run: {out}")
    _line("mesh_chaos", cli=json.dumps(" ".join(flags + supervised)),
          backend=json.dumps(sup["backend"]),
          resilience=json.dumps(sup["resilience"]),
          final_digest=sup["final_digest"].split("=")[1][:16],
          same="==plain CLI run", seconds=f"{time.perf_counter() - t0:.1f}")


def phase_mesh_chaos(args, frac: float) -> dict:
    """Phase 13: 2 gloo ranks on the one card, each run of
    ``MESH_CHAOS_RUNS`` under the ``ci`` schedule, then the CLI check;
    returns the launches by kernel and run."""
    from repro_torch.launch.mesh import start_ranks

    t0 = time.perf_counter()
    small = argparse.Namespace(**{**vars(args), "S": MESH_CHAOS_S})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_chaos_") as tmp:
        launches = start_ranks(mesh_chaos_rank, 2, "cuda", small, frac, tmp,
                               timeout=600)
        mesh_chaos_cli(tmp)
    _line("mesh_chaos", seconds=f"{time.perf_counter() - t0:.1f}")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the LM substrate (repro_torch.models) at published widths
# ---------------------------------------------------------------------------

# three of the repo's architectures at their full configs' widths, depth cut
# to LM_LAYERS layers (the one reduction): dense with qk_norm and GQA 32/8,
# MoE 64 experts top-6, Mamba2 SSD with tied embeddings
LM_ARCHS = ("qwen3-8b", "moonshot-v1-16b-a3b", "mamba2-1.3b")
LM_LAYERS = 2
LM_S = 512               # B=1 tokens per forward, backward and prefill
LM_DECODE = 16           # decode steps after the prefill
LM_CPU_S = 32            # tokens of the card-against-CPU check
LM_REL = 1e-4            # max |diff| / max |ref| of every logits gate
COMPRESS_ELEMS = 4 * 2 ** 20


@contextlib.contextmanager
def route_spy():
    """The routing indices of every ``moe_block`` call while inside (the
    spy wraps ``repro_torch.models.moe._route``), on the host."""
    from repro_torch.models import moe

    real, seen = moe._route, []

    def spy(p, xf, k):
        gvals, gidx = real(p, xf, k)
        seen.append(gidx.cpu())
        return gvals, gidx

    moe._route = spy
    try:
        yield seen
    finally:
        moe._route = real


def _rel(torch, got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _pad_kv(torch, cache, n):
    """The attention caches ``n`` positions longer (the decode slots)."""
    return tuple({k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
                      if k in ("k", "v") else v) for k, v in blk.items()}
                 for blk in cache)


def lm_arch(torch, np, args, name: str) -> dict:
    """One architecture on the card (f32, TF32 off, B=1): forward,
    ``lm_loss`` with its backward, a prefill of ``LM_S`` tokens and
    ``LM_DECODE`` decode steps, each timed (CUDA events) beside its bound;
    gates: every gradient finite, prefill + decode at an f32 cache equal to
    the forward's logits at those positions, and the CPU's logits (and,
    for MoE, its routing indices) on the same parameters at ``LM_CPU_S``
    tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_leaves, tree_map
    from repro_torch.models import lm

    full_cfg = get_arch(name)
    cfg = dataclasses.replace(
        full_cfg, n_layers=LM_LAYERS * len(lm.block_pattern(full_cfg)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=args.seed, device="cuda")
    n_params = sum(x.numel() for x in tree_leaves(params))
    if n_params != cfg.param_count():
        raise AssertionError(f"lm {name}: {n_params} parameters, "
                             f"param_count {cfg.param_count()}")
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LM_S + LM_DECODE))).cuda()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_S))).cuda()
    x = toks[:, :LM_S]
    out = {}

    with torch.no_grad():
        out["forward_ms"] = _time_ms(torch, lambda: lm.forward(cfg, params,
                                                              x), 3)
        logits = lm.forward(cfg, params, x)
    if logits.shape != (1, LM_S, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"lm {name}: forward gave {tuple(logits.shape)}"
                             f" or non-finite logits")

    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)

    def train_step():
        for t in leaves:
            t.grad = None
        lm.lm_loss(cfg, params, x, labels).backward()

    out["fwd_bwd_ms"] = _time_ms(torch, train_step, 3)
    bad = [i for i, t in enumerate(leaves)
           if t.grad is None or not bool(torch.isfinite(t.grad).all())]
    if bad:
        raise AssertionError(f"lm {name}: {len(bad)} gradient leaves "
                             f"missing or non-finite")
    for t in leaves:
        t.grad = None
        t.requires_grad_(False)

    # the decode gate holds no token dropped, so the MoE's capacity takes
    # every token (the reference's smoke configs do the same): with drops a
    # token's output depends on how many tokens share its batch
    gate_cfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    with torch.no_grad():
        out["prefill_ms"] = _time_ms(torch, lambda: lm.prefill(
            cfg, params, x, cache_dtype=torch.float32), 3)
        want = lm.forward(gate_cfg, params, toks)
        last, cache, clen = lm.prefill(gate_cfg, params, x,
                                       cache_dtype=torch.float32)
        cache = _pad_kv(torch, cache, LM_DECODE)
        errs = [_rel(torch, last, want[:, LM_S - 1])]
        c = cache
        for i in range(LM_DECODE):
            dec, c = lm.decode_step(gate_cfg, params, c, clen + i,
                                    toks[:, LM_S + i:LM_S + i + 1])
            errs.append(_rel(torch, dec, want[:, LM_S + i]))
        out["decode_rel_err"] = max(errs)
        if out["decode_rel_err"] >= LM_REL:
            raise AssertionError(f"lm {name}: prefill+decode differ from "
                                 f"forward by {errs} (relative)")

        def decode_all():
            c = cache
            for i in range(LM_DECODE):
                _, c = lm.decode_step(gate_cfg, params, c, clen + i,
                                      toks[:, LM_S + i:LM_S + i + 1])

        out["decode_ms"] = _time_ms(torch, decode_all, 2) / LM_DECODE
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # the card against the CPU on the same parameters and tokens
    with torch.no_grad():
        short = x[:, :LM_CPU_S]
        with route_spy() as card_routes:
            card = lm.forward(cfg, params, short)
        cpu_params = tree_map(lambda t: t.cpu(), params)
        with route_spy() as cpu_routes:
            cpu = lm.forward(cfg, cpu_params, short.cpu())
        out["cpu_rel_err"] = _rel(torch, card.cpu(), cpu)
    del cpu_params
    if out["cpu_rel_err"] >= LM_REL:
        raise AssertionError(f"lm {name}: the card's logits differ from the "
                             f"CPU's by {out['cpu_rel_err']:.3e} (relative)")
    if cfg.moe is not None:
        if len(card_routes) != LM_LAYERS or len(card_routes) != \
                len(cpu_routes) or not all(
                    torch.equal(a, b) for a, b in zip(card_routes,
                                                      cpu_routes)):
            raise AssertionError(f"lm {name}: the card's routing indices "
                                 f"differ from the CPU's")
        out["routes_equal"] = len(card_routes)

    # bounds: 2 FLOPs per product parameter and token at the f32 peak
    # (the input embedding is a lookup, not a product), and the product
    # parameters' bytes a decode token reads at the memory rate
    mm = cfg.active_param_count() - (
        0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
    fwd_bound = 2 * mm * LM_S / F32_FLOPS_PER_S * 1e3
    out.update(params=n_params, product_params=mm,
               forward_bound_ms=fwd_bound, fwd_bwd_bound_ms=3 * fwd_bound,
               prefill_bound_ms=fwd_bound,
               decode_bound_ms=4 * mm / HBM_BYTES_PER_S * 1e3)
    _line("lm", arch=name, layers=cfg.n_layers, d=cfg.d_model,
          vocab=cfg.vocab, params=n_params, B=1, S=LM_S,
          forward_ms=f"{out['forward_ms']:.3f}",
          forward_bound_ms=f"{fwd_bound:.3f}",
          forward_tok_per_s=f"{LM_S / out['forward_ms'] * 1e3:.0f}",
          fwd_bwd_ms=f"{out['fwd_bwd_ms']:.3f}",
          fwd_bwd_bound_ms=f"{3 * fwd_bound:.3f}",
          fwd_bwd_tok_per_s=f"{LM_S / out['fwd_bwd_ms'] * 1e3:.0f}",
          prefill_ms=f"{out['prefill_ms']:.3f}",
          prefill_bound_ms=f"{fwd_bound:.3f}",
          decode_ms_per_token=f"{out['decode_ms']:.3f}",
          decode_bound_ms=f"{out['decode_bound_ms']:.3f}",
          decode_tok_per_s=f"{1e3 / out['decode_ms']:.1f}",
          peak_gib=f"{out['peak_gib']:.2f}",
          decode_rel_err=f"{out['decode_rel_err']:.2e}",
          cpu_rel_err=f"{out['cpu_rel_err']:.2e}",
          **({"routes_equal": out["routes_equal"]} if cfg.moe else {}),
          note="2-layer cut at published width, random weights; not a "
               "training throughput")
    return out


def lm_compression(torch, np, seed: int) -> dict:
    """``compress_tree`` (int8 error feedback) of a seeded
    ``COMPRESS_ELEMS``-element f32 tree on the card, two rounds: the CPU's
    int8 bytes and scales, bit for bit."""
    from repro_torch.distributed import compression as comp
    from repro_torch.tree import tree_leaves, tree_map

    rng = np.random.default_rng(seed)
    n = COMPRESS_ELEMS
    rounds = [{"w": rng.normal(0, 2, (n // 2 // 1024, 1024)).astype(
                   np.float32),
               "b": (rng.standard_cauchy(n // 4).astype(np.float32),
                     [(rng.normal(0, 1e-3, n // 4)).astype(np.float32)])}
              for _ in range(2)]
    got = {}
    for device in ("cuda", "cpu"):
        tree0 = tree_map(lambda a: torch.from_numpy(a).to(device),
                         rounds[0])
        ef = comp.ef_init(tree0)
        outs = []
        for r in rounds:
            tree = tree_map(lambda a: torch.from_numpy(a).to(device), r)
            q, sc, ef = comp.compress_tree(tree, ef)
            outs.append(([t.cpu() for t in tree_leaves(q)],
                         [t.cpu() for t in tree_leaves(sc)]))
        got[device] = outs
    elems = sum(t.numel() for t in got["cpu"][0][0])
    for (cq, cs), (hq, hs) in zip(got["cuda"], got["cpu"]):
        if not (all(torch.equal(a, b) for a, b in zip(cq, hq))
                and all(torch.equal(a, b) for a, b in zip(cs, hs))):
            raise AssertionError("compress_tree on the card gave other int8 "
                                 "bytes or scales than the CPU")
    _line("lm", compression="compress_tree int8 error feedback", rounds=2,
          elements=elems, bitwise="card==CPU (int8 bytes and scales)")
    return {"elements": elems}


def phase_lm(torch, np, args) -> dict:
    """Phase 14 (see the module docstring); TF32 is off inside and the
    flags are put back after."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    t0 = time.perf_counter()
    try:
        out = {name: lm_arch(torch, np, args, name) for name in LM_ARCHS}
        out["compression"] = lm_compression(torch, np, args.seed)
    finally:
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    _line("lm", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 15: LM training (repro_torch.train.loop) on the card
# ---------------------------------------------------------------------------

LM_TRAIN_STEPS = 4          # Trainer steps a full-width cut; 2-4 timed
LM_TRAIN_B = 1              # the timed steps' batch (phase 14's B and S)
LM_MB_B = 2                 # the microbatch gate's batch (B=1 cannot split)
LM_MB_REL = 1e-5            # microbatches=2 loss vs microbatches=1 (relative)
LM_SMOKE_REL = 1e-5         # the card's first smoke step vs the CPU's: loss
OPT_BYTES_PER_PARAM = 28    # AdamW: p r/w, g r, m r/w, v r/w, 4 bytes each
LM_CLI = ["lm", "--arch", "starcoder2-3b", "--smoke", "--steps", "12",
          "--batch", "2", "--seq", "16"]


@contextlib.contextmanager
def adamw_spy(torch):
    """CUDA events around every ``adamw_update`` of the train step (the
    spy wraps ``repro_torch.launch.steps.adamw_update``); yields the list
    of (start, end) event pairs."""
    from repro_torch.launch import steps

    real, spans = steps.adamw_update, []

    def spy(*a, **kw):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*a, **kw)
        e.record()
        spans.append((s, e))
        return out

    steps.adamw_update = spy
    try:
        yield spans
    finally:
        steps.adamw_update = real


def _timed_steps(torch, tr) -> list:
    """Wrap a Trainer's step function in CUDA events; returns the list of
    (start, end) pairs it fills, one a step."""
    real, spans = tr.step_fn, []

    def step(*a):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        out = real(*a)
        e.record()
        spans.append((s, e))
        return out

    tr.step_fn = step
    return spans


def _param_gap(got, want, lr_sum: float, wd: float) -> dict:
    """The largest |got - want| over every parameter against the sign-flip
    bound 2·Σlr_t·(1 + wd·max|p|) (Adam's update is about lr·sign(g), so
    a gradient entry near float noise may flip), and the least share, over
    the leaves, of a leaf's entries within 1e-6 + 1e-5·|p| with that
    leaf's path (held at 0.999 leaf by leaf, so a small leaf left without
    its update fails). Computed on ``want``'s device."""
    from repro_torch.tree import tree_leaves, tree_map_with_path
    paths = []
    tree_map_with_path(lambda path, _: paths.append(path), want)
    ours, theirs = tree_leaves(got), tree_leaves(want)
    if len(ours) != len(theirs):
        raise AssertionError(f"{len(ours)} leaves against {len(theirs)}")
    pmax = max(float(w.abs().max()) for w in theirs)
    worst, share, leaf = 0.0, 1.0, None
    for path, g, w in zip(paths, ours, theirs):
        w = w.float()
        d = (g.to(w.device).float() - w).abs()
        worst = max(worst, float(d.max()))
        tight = int((d <= 1e-6 + 1e-5 * w.abs()).sum()) / d.numel()
        if leaf is None or tight < share:
            share, leaf = tight, path
    return {"max_abs": worst, "bound": 2 * lr_sum * (1 + wd * pmax),
            "tight_share": share, "tight_leaf": leaf}


def lm_train_cli_start():
    """Start ``python -m repro_torch.launch.train lm`` at smoke size on the
    card (no ``--device``: the GPU); :func:`lm_train_cli_finish` reads it.
    The phase runs its untimed parts while the process starts."""
    env = dict(os.environ,
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *LM_CLI],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def lm_train_cli_finish(t0: float, proc) -> dict:
    """Wait for the CLI: exit 0, 12 steps, finite losses."""
    import math
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("lm CLI still running after 300 s")
    if proc.returncode != 0:
        raise AssertionError(f"lm CLI exit {proc.returncode}: {err[-2000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("final step ")]
    parts = line[-1].replace(";", "").split() if line else []
    if len(parts) != 7 or parts[2] != "12":
        raise AssertionError(f"lm CLI printed {out[-500:]!r}")
    first, last = float(parts[4]), float(parts[6])
    if not (math.isfinite(first) and math.isfinite(last)):
        raise AssertionError(f"lm CLI losses {first} -> {last}")
    _line("lm-train", cli=" ".join(LM_CLI), line=json.dumps(line[-1]),
          loss_fell=last < first,
          wall_s=f"{time.perf_counter() - t0:.1f}",
          note="beside the loop and smoke parts")
    return {"first": first, "last": last}


def lm_train_loop(torch, tmp: str) -> dict:
    """``tests/test_train_loop.py``'s Trainer (smoke starcoder2-3b, B=2,
    S=16, lr 1e-3, warmup 2) on the card: 12 steps on one fixed batch
    lose more than 0.5 nats (the property the stream's first-against-last
    mean shows only for some draws: both are printed), a checkpointed run
    of 6 steps resumes at 6 and ends at 10, failures at steps 5 and 9
    recover from checkpoints to step 12 with finite losses, and a failure
    without checkpoints still ends at 6."""
    import math

    from repro_torch.configs import get_smoke
    from repro_torch.train.loop import (LoopConfig, Trainer,
                                        synthetic_lm_batches)
    from repro_torch.train.optim import AdamWConfig
    from repro_torch.train.resilience import FailureInjector

    cfg = get_smoke("starcoder2-3b")
    t0 = time.perf_counter()

    def trainer(ckpt_dir=None, steps=12, injector=None, **kw):
        loop = LoopConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=4,
                          log_every=100)
        opt = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2)
        return Trainer(cfg, opt, loop, batch=2, seq=16,
                       failure_injector=injector, device="cuda", **kw)

    fixed = next(synthetic_lm_batches(cfg, 2, 16, device="cuda"))
    fixed_losses = trainer(batch_fn=lambda step: fixed).train()["losses"]
    stream = trainer(steps=15).train()["losses"]
    if not fixed_losses[0] - fixed_losses[-1] > 0.5:
        raise AssertionError(f"lm-train: a fixed batch's loss went "
                             f"{fixed_losses[0]} -> {fixed_losses[-1]}")
    d1 = os.path.join(tmp, "resume")
    trainer(d1, steps=6).train()
    tr2 = trainer(d1, steps=10)
    if tr2.start_step != 6 or tr2.train()["final_step"] != 10:
        raise AssertionError("lm-train: the resumed Trainer did not run "
                             "from step 6 to 10")
    inj = FailureInjector([5, 9])
    out = trainer(os.path.join(tmp, "faults"), injector=inj).train()
    if out["final_step"] != 12 or inj.fail_steps or not all(
            math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"lm-train: failures at 5 and 9 ended at "
                             f"{out['final_step']} ({inj.fail_steps} left)")
    plain = trainer(None, steps=6, injector=FailureInjector([3])).train()
    if plain["final_step"] != 6:
        raise AssertionError("lm-train: a failure without checkpoints did "
                             "not finish")
    _line("lm-train", loop="smoke starcoder2-3b B=2 S=16",
          fixed_batch_loss=f"{fixed_losses[0]:.4f}->{fixed_losses[-1]:.4f}",
          stream_mean3=f"{sum(stream[:3]) / 3:.4f}->"
                       f"{sum(stream[-3:]) / 3:.4f}",
          resume="6->10", faults="[5,9] -> 12",
          replayed_steps=len(out["losses"]) - 12, no_ckpt_fault="[3] -> 6",
          wall_s=f"{time.perf_counter() - t0:.1f}")
    return {"fixed": fixed_losses, "stream": stream}


def lm_train_smoke_vs_cpu(name: str) -> dict:
    """The first Trainer step of ``name``'s smoke config (B=2, S=16, lr
    1e-3) on the card from the CPU Trainer's initial parameters: the loss
    within ``LM_SMOKE_REL`` relative of the CPU's step, every parameter
    within the sign-flip bound, 99.9% of each leaf's entries within 1e-6 +
    1e-5·|p|."""
    from repro_torch.configs import get_smoke
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optim import AdamWConfig, adamw_init, lr_schedule
    from repro_torch.tree import tree_map

    cfg = get_smoke(name)
    opt = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=0)

    def trainer(device):
        return Trainer(cfg, opt, LoopConfig(steps=1, log_every=100),
                       batch=2, seq=16, device=device)

    cpu = trainer("cpu")
    card = trainer("cuda")
    card.params = tree_map(lambda t: t.clone().cuda(), cpu.params)
    card.opt_state = adamw_init(card.params)
    cpu_loss = cpu.train()["losses"][0]
    card_loss = card.train()["losses"][0]
    cpu_p, card_p = cpu.params, card.params
    rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    gap = _param_gap(card_p, cpu_p, float(lr_schedule(opt, 1)),
                     opt.weight_decay)
    if rel > LM_SMOKE_REL or gap["max_abs"] > gap["bound"] or \
            gap["tight_share"] < 0.999:
        raise AssertionError(f"lm-train {name} smoke: the card's first step "
                             f"differs from the CPU's: loss {rel:.3e} "
                             f"relative, {gap}")
    return {"loss_rel": rel, **gap}


def lm_train_arch(torch, name: str) -> dict:
    """One architecture's 2-layer cut at published width (phase 14's): the
    microbatch gate at B=``LM_MB_B`` (two Trainers from the same seeded
    parameters, microbatches 1 and 2, one step each: the loss, and the
    updated parameters held as :func:`lm_train_smoke_vs_cpu` holds them,
    so the f32 accumulation, the division by m and the update that
    follows are checked; the MoE at a capacity
    that drops no token, as phase 14's decode gate: with drops a token's
    output depends on how many tokens share its dispatch, so splitting the
    batch changes which tokens drop), then a Trainer at
    B=1, S=``LM_S`` for ``LM_TRAIN_STEPS`` steps with steps 2-4 timed
    (CUDA events) and the AdamW update timed apart, beside the bound."""
    import math

    from repro_torch.configs import get_arch
    from repro_torch.models import lm
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optim import AdamWConfig, lr_schedule

    full_cfg = get_arch(name)
    cfg = dataclasses.replace(
        full_cfg, n_layers=LM_LAYERS * len(lm.block_pattern(full_cfg)))
    opt = AdamWConfig(lr=1e-4, total_steps=LM_TRAIN_STEPS, warmup_steps=1)
    gate_cfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    mb_loss = {}
    for mb in (1, 2):
        torch.cuda.empty_cache()
        tr = Trainer(gate_cfg, opt, LoopConfig(steps=1, microbatches=mb,
                                          log_every=100),
                     batch=LM_MB_B, seq=LM_S, device="cuda")
        mb_loss[mb] = tr.train()["losses"][0]
        if mb == 1:
            one_p = tr.params      # the moments go with the Trainer
        else:
            mb_gap = _param_gap(tr.params, one_p,
                                float(lr_schedule(opt, 1)), opt.weight_decay)
        del tr
    del one_p
    mb_rel = abs(mb_loss[2] - mb_loss[1]) / abs(mb_loss[1])
    if mb_rel > LM_MB_REL or mb_gap["max_abs"] > mb_gap["bound"] or \
            mb_gap["tight_share"] < 0.999:
        raise AssertionError(f"lm-train {name}: microbatches=2 against 1: "
                             f"loss {mb_loss[2]} vs {mb_loss[1]} "
                             f"({mb_rel:.2e}), parameters {mb_gap}")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, opt, LoopConfig(steps=LM_TRAIN_STEPS, log_every=100),
                 batch=LM_TRAIN_B, seq=LM_S, device="cuda")
    spans = _timed_steps(torch, tr)
    t0 = time.perf_counter()
    with adamw_spy(torch) as opt_spans:
        losses = tr.train()["losses"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(losses) != LM_TRAIN_STEPS or not all(math.isfinite(x)
                                                for x in losses):
        raise AssertionError(f"lm-train {name}: losses {losses}")
    step_ms = [s.elapsed_time(e) for s, e in spans[1:]]
    opt_ms = [s.elapsed_time(e) for s, e in opt_spans[1:]]
    n_params = cfg.param_count()
    mm = cfg.active_param_count() - (
        0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
    fwd_bwd_bound = 3 * 2 * mm * LM_TRAIN_B * LM_S / F32_FLOPS_PER_S * 1e3
    opt_bound = OPT_BYTES_PER_PARAM * n_params / HBM_BYTES_PER_S * 1e3
    out = {"params": n_params, "step_ms": sum(step_ms) / len(step_ms),
           "opt_ms": sum(opt_ms) / len(opt_ms),
           "bound_ms": fwd_bwd_bound + opt_bound, "opt_bound_ms": opt_bound,
           "peak_gib": peak, "losses": losses, "mb_rel": mb_rel,
           "mb_gap": mb_gap, "product_flops": 3 * 2 * mm * LM_TRAIN_B * LM_S}
    # one more step, untimed, under the roofline's count (phase 16 reads it)
    from repro_torch.launch.roofline import counting
    with counting() as count:
        tr.step_fn(tr.params, tr.opt_state, tr.batch_fn(LM_TRAIN_STEPS))
    torch.cuda.synchronize()
    out["counted_flops"] = count.flops
    out["counted_collectives"] = len(count.collectives)
    _line("lm-train", arch=name, layers=cfg.n_layers, params=n_params,
          B=LM_TRAIN_B, S=LM_S, steps=LM_TRAIN_STEPS,
          step_ms=f"{out['step_ms']:.3f}",
          step_ms_each=",".join(f"{x:.3f}" for x in step_ms),
          bound_ms=f"{out['bound_ms']:.3f}",
          fwd_bwd_bound_ms=f"{fwd_bwd_bound:.3f}",
          adamw_ms=f"{out['opt_ms']:.3f}",
          adamw_bound_ms=f"{opt_bound:.3f}",
          tok_per_s=f"{LM_TRAIN_B * LM_S / out['step_ms'] * 1e3:.0f}",
          peak_gib=f"{peak:.2f}", wall_s=f"{wall:.2f}",
          losses=",".join(f"{x:.4f}" for x in losses),
          mb2_vs_mb1_rel=f"{mb_rel:.2e}",
          mb2_vs_mb1_param_max_abs=f"{mb_gap['max_abs']:.3e}",
          mb2_vs_mb1_bound=f"{mb_gap['bound']:.3e}",
          mb2_vs_mb1_tight_share=f"{mb_gap['tight_share']:.6f}",
          mb2_vs_mb1_tight_leaf=mb_gap["tight_leaf"], mb_B=LM_MB_B,
          note="2-layer cut at published width, random weights")
    del tr
    torch.cuda.empty_cache()
    return out


def phase_lm_train(torch) -> dict:
    """Phase 15 (see the module docstring); TF32 off inside, the flags put
    back after."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    for f in flags:
        f.allow_tf32 = False
    t0 = time.perf_counter()
    cli = lm_train_cli_start()
    try:
        out = {}
        with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
            out["loop"] = lm_train_loop(torch, tmp)
        out["smoke"] = {}
        for name in LM_ARCHS:
            t1 = time.perf_counter()
            g = out["smoke"][name] = lm_train_smoke_vs_cpu(name)
            _line("lm-train", smoke=name, B=2, S=16,
                  card_vs_cpu_loss_rel=f"{g['loss_rel']:.2e}",
                  param_max_abs=f"{g['max_abs']:.3e}",
                  sign_flip_bound=f"{g['bound']:.3e}",
                  tight_share=f"{g['tight_share']:.6f}",
                  tight_leaf=g["tight_leaf"],
                  wall_s=f"{time.perf_counter() - t1:.1f}")
        # the timed steps run alone, after the CLI's process has ended
        out["cli"] = lm_train_cli_finish(*cli)
        for name in LM_ARCHS:
            out[name] = lm_train_arch(torch, name)
    finally:
        if cli[1].poll() is None:
            cli[1].kill()
            cli[1].communicate()
        for f, v in zip(flags, saved):
            f.allow_tf32 = v
    _line("lm-train", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the MoE's expert parallelism at published width, the roofline's
# count of phase 15's steps, and the dry-run CLI
# ---------------------------------------------------------------------------

EP_ARCH = "moonshot-v1-16b-a3b"   # d=2048, 64 experts top-6, ff=1408
EP_CF = 1.25                      # the published capacity factor: drops
EP_S = 512                        # B=1 tokens through the block
EP_RANKS = 2                      # model ranks sharing the card (gloo)
EP_REPS = 3                       # timed forward+backward passes a rank
EP_BITWISE = 0.999                # output entries equal to the CPU's bits
EP_MOVED_TOKENS = 4               # tokens the CPU may route or keep otherwise
EP_TIE_GAP = 1e-6                 # ... each flip a near tie of the gates
EP_F32_REL = 1e-5                 # card vs CPU f32 partials, of the largest
BF16_EPS = 2.0 ** -8              # a bf16 rounding's relative error bound
DRYRUN_CELLS = (("qwen3-8b", "train_4k"), ("qwen3-8b", "decode_32k"))
EP_KEYS = ("x", "w_router", "we_gate", "we_up", "we_down")


def ep_config():
    """moonshot-v1-16b-a3b's published MoE block (its config's widths) at
    the published capacity factor."""
    from repro_torch.configs import get_arch
    cfg = get_arch(EP_ARCH)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_CF))


def ep_draw(torch, cfg, seed: int) -> dict:
    """The block's inputs on the host from a seeded CPU generator (every
    rank draws the same): router, experts, the input (1, EP_S, d) and the
    cotangent ``w`` of the loss sum(out·w)."""
    g = torch.Generator().manual_seed(seed)
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

    def draw(shape, scale):
        return torch.randn(shape, generator=g) * scale

    return {"w_router": draw((d, e), d ** -0.5),
            "we_gate": draw((e, d, ff), d ** -0.5),
            "we_up": draw((e, d, ff), d ** -0.5),
            "we_down": draw((e, ff, d), ff ** -0.5),
            "x": draw((1, EP_S, d), 1.0), "w": draw((1, EP_S, d), 1.0)}


def ep_pass(torch, cfg, inp: dict, device, mesh=None) -> dict:
    """``moe_block``'s output and the gradients of sum(out·w) on
    ``device``: under the rules of ``mesh`` (expert parallelism over its
    ``model`` dim, ``inp`` holding this rank's experts), or without rules
    (the local path, ``inp`` holding every expert)."""
    from repro_torch.distributed.sharding import axis_rules, local_shards
    from repro_torch.models import moe

    leaf = {k: inp[k].detach().to(device, copy=True).requires_grad_(True)
            for k in EP_KEYS}
    p = {k: v for k, v in leaf.items() if k != "x"}
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(axis_rules(mesh))
            stack.enter_context(local_shards())
        out = moe.moe_block(cfg, p, leaf["x"])
    (out * inp["w"].to(device)).sum().backward()
    res = {"out": out.detach()}
    res.update({k: v.grad for k, v in leaf.items()})
    return res


def _bf16_ulp(torch, ref):
    """One bf16 ulp at each entry of ``ref``: 2^(e-7) for |ref| in
    [2^e, 2^(e+1))."""
    mag = ref.float().abs().clamp_min(2.0 ** -126)
    return torch.pow(2.0, torch.floor(torch.log2(mag)) - 7)


def ep_rank(mesh, seed: int) -> list:
    """Phase 16 (a) on one rank of a (model=N) mesh: the expert-parallel
    block at published width on the card, then through the same code on
    the CPU (a gloo group over the same ranks), and the card's one-process
    local path with every expert. Returns every rank's report."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    from repro_torch.distributed import collectives
    from repro_torch.models import moe

    for f in (torch.backends.cuda.matmul, torch.backends.cudnn):
        f.allow_tf32 = False
    # the host's cores shared with the other ranks and the dry-run
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    dev = mesh.device
    n = dist.get_world_size()
    cfg = ep_config()
    card = init_device_mesh(dev.type, (n,), mesh_dim_names=("model",))
    host = DeviceMesh.from_group(dist.new_group(backend="gloo"), "cpu",
                                 mesh_dim_names=("model",))
    r = card.get_local_rank("model")
    inp = ep_draw(torch, cfg, seed)
    e_loc = cfg.moe.num_experts // n
    mine = {k: (v[r * e_loc:(r + 1) * e_loc].clone() if k.startswith("we_")
                else v) for k, v in inp.items()}

    sums, operands, routes = [], [], []
    real_sum, real_route = collectives._rank_order_sum, moe._route

    def route_spy(p, xf, k):
        gvals, gidx = real_route(p, xf, k)
        logits = xf.float() @ p["w_router"]
        top = torch.topk(torch.softmax(logits, -1), k + 1, dim=-1).values
        routes.append((gidx.cpu(), (top[..., k - 1] - top[..., k]).cpu()))
        return gvals, gidx

    def sum_spy(x, group):
        if x.is_cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        got = real_sum(x, group)
        if x.is_cuda:
            torch.cuda.synchronize()
        sums.append((time.perf_counter() - t) * 1e3)
        if not operands:            # the checked card pass's partials
            operands.append(torch.stack(collectives._gather_list(
                x, group)).float().cpu())
        return got

    # the warm-up pass is the one checked: spied on for its routes and
    # operands (gathered apart, untimed); the timed passes only time the
    # sum
    collectives._rank_order_sum, moe._route = sum_spy, route_spy
    try:
        got = ep_pass(torch, cfg, mine, dev, card)
        moe._route = real_route
        ms = []
        for _ in range(EP_REPS):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            ep_pass(torch, cfg, mine, dev, card)
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e))
        sum_ms = sums[1:EP_REPS + 1]
        moe._route = route_spy
        cpu = ep_pass(torch, cfg, mine, "cpu", host)
    finally:
        collectives._rank_order_sum, moe._route = real_sum, real_route
    local = ep_pass(torch, cfg, inp, dev)                 # every expert

    # the local path's dropped (token, expert) assignments
    _, gidx = moe._route({"w_router": inp["w_router"]},
                         inp["x"].reshape(-1, cfg.d_model), cfg.moe.top_k)
    cap = min(max(1, int(cfg.moe.top_k * EP_S * EP_CF
                         / cfg.moe.num_experts)), EP_S)
    counts = torch.bincount(gidx.reshape(-1),
                            minlength=cfg.moe.num_experts)
    dropped = int((counts - cap).clamp_min(0).sum())

    rep = {"rank": dist.get_rank(), "device": str(dev),
           "backend": str(dist.get_backend()), "ms": ms, "sum_ms": sum_ms,
           "dropped": dropped, "cap": cap, "e_loc": e_loc}
    # card EP against the card's local path (held in ep_check: the bf16
    # roundings of the N partials and of their sum, (N + 1)·2^-8 of the
    # largest partial or output entry)
    rep["vs_local_out_abs"] = float((got["out"] - local["out"]).abs().max())
    rep["part_max"] = float(operands[0].abs().max())
    rep["out_max"] = float(local["out"].abs().max())
    worst = 0.0
    for k in EP_KEYS:
        want = local[k]
        if k.startswith("we_"):
            want = want[r * e_loc:(r + 1) * e_loc]
        worst = max(worst, float((got[k] - want).abs().max()
                                 / (BF16_EPS * want.abs().max())))
    rep["vs_local_grad"] = worst
    # card EP against the CPU's: output bits, then in ulps of the entry's
    # largest rounded operand (a partial, or the sum) plus the f32
    # partials' own difference (EP_F32_REL of the largest partial: a
    # partial that cancels to near 0 is held at f32 accuracy, not at its
    # own tiny ulp). The hosts' f32 partials can round to neighbours, a
    # partial's ulp each, and the sum's rounding can add one more (a tie
    # rounds to even on both sides of it): at most N + 1. A token routed
    # otherwise (its k-th and (k+1)-th gates a near tie the two hosts'
    # f32 logits order differently) or whose kept slots differ with it is
    # counted apart
    (g_card, _), (g_cpu, gap_cpu) = routes[0], routes[-1]
    keep_card = _ep_kept(torch, cfg, g_card, cap)
    keep_cpu = _ep_kept(torch, cfg, g_cpu, cap)
    same_set = (g_card.sort(-1).values == g_cpu.sort(-1).values).all(-1)
    flips = ~same_set
    moved = flips | (keep_card != keep_cpu).any(-1)
    out_c = cpu["out"]
    diff = (got["out"].cpu() - out_c).abs()
    rep["cpu_bitwise"] = float((diff == 0).float().mean())
    largest = torch.maximum(operands[0].abs().amax(0).reshape(out_c.shape),
                            out_c.abs())
    allowed = (_bf16_ulp(torch, largest)
               + EP_F32_REL * float(operands[0].abs().max()))
    ulps = (diff / allowed).reshape(-1, cfg.d_model)
    rep["cpu_ulps"] = float(ulps[~moved.reshape(-1)].max())
    rep["cpu_max_abs"] = float(diff.max())
    rep["route_flips"] = int(flips.sum())
    rep["moved_tokens"] = int(moved.sum())
    rep["flip_gap_max"] = (float(gap_cpu.reshape(-1)[flips.reshape(-1)]
                                 .max()) if bool(flips.any()) else 0.0)
    rep["cpu_grad"] = max(float((got[k].cpu() - cpu[k]).abs().max()
                                / (BF16_EPS * cpu[k].abs().max()))
                          for k in EP_KEYS)
    rep["finite"] = all(bool(torch.isfinite(v).all()) for v in got.values())
    every = [None] * n
    dist.all_gather_object(every, rep)
    return every


def _ep_kept(torch, cfg, gidx, cap: int):
    """Which of each token's routed (token, expert) slots the dispatch
    keeps (position in its expert below ``cap``), in the token's sorted
    expert order."""
    e = cfg.moe.num_experts
    flat = gidx.reshape(-1)
    onehot = torch.nn.functional.one_hot(flat, e)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = (pos < cap).reshape(gidx.shape[:-1] + (-1,))
    order = gidx.argsort(-1)
    return torch.gather(keep, -1, order)


def ep_check(reports: list, n: int) -> None:
    """Phase 16 (a)'s gates on every rank's report (module docstring)."""
    scale = max(max(r["part_max"] for r in reports),
                max(r["out_max"] for r in reports))
    for r in reports:
        r["vs_local_out"] = r["vs_local_out_abs"] / (BF16_EPS * scale)
        _line("lm-ep", rank=r["rank"], device=r["device"],
              backend=r["backend"], arch=EP_ARCH, S=EP_S, cf=EP_CF,
              model_ranks=n, experts_per_rank=r["e_loc"], cap=r["cap"],
              dropped=r["dropped"],
              fwd_bwd_ms_each=",".join(f"{x:.3f}" for x in r["ms"]),
              sum_ms_each=",".join(f"{x:.3f}" for x in r["sum_ms"]),
              vs_local_out_eps=f"{r['vs_local_out']:.3f}",
              vs_local_grad_eps=f"{r['vs_local_grad']:.3f}",
              cpu_bitwise=f"{r['cpu_bitwise']:.6f}",
              cpu_max_ulps=f"{r['cpu_ulps']:.3f}",
              cpu_max_abs=f"{r['cpu_max_abs']:.3e}",
              route_flips=r["route_flips"], moved_tokens=r["moved_tokens"],
              flip_gate_gap_max=f"{r['flip_gap_max']:.3e}",
              cpu_grad_eps=f"{r['cpu_grad']:.4f}",
              note="ranks time-slice one card over gloo: not a scaling "
                   "number" if r["backend"] == "gloo" else "a card a rank")
        if not (r["finite"] and r["dropped"] > 0
                and r["vs_local_out"] <= n + 1
                and r["vs_local_grad"] <= n + 1
                and r["cpu_bitwise"] >= EP_BITWISE
                and r["cpu_ulps"] <= n + 1
                and r["cpu_grad"] <= 1.0
                and r["moved_tokens"] <= EP_MOVED_TOKENS
                and r["flip_gap_max"] <= EP_TIE_GAP):
            raise AssertionError(f"lm-ep rank {r['rank']}: {r}")


def lm_roofline_lines(lm_train: dict) -> dict:
    """Phase 16 (b): the roofline's count of phase 15's untimed extra step
    of each 2-layer cut beside phase 14's analytic product FLOPs, and its
    compute term at the f32 rate beside the measured step."""
    out = {}
    for name in LM_ARCHS:
        a = lm_train[name]
        t_comp = a["counted_flops"] / F32_FLOPS_PER_S * 1e3
        out[name] = {"counted": a["counted_flops"],
                     "product": a["product_flops"], "t_compute_ms": t_comp,
                     "share": t_comp / a["step_ms"]}
        if not (a["counted_flops"] > 0 and a["counted_collectives"] == 0):
            raise AssertionError(f"lm-ep {name}: count {a}")
        _line("lm-ep", roofline=name, B=LM_TRAIN_B, S=LM_S,
              counted_flops=f"{a['counted_flops']:.6e}",
              product_flops=f"{a['product_flops']:.6e}",
              counted_over_product=(
                  f"{a['counted_flops'] / a['product_flops']:.4f}"),
              t_compute_f32_ms=f"{t_comp:.3f}",
              step_ms=f"{a['step_ms']:.3f}",
              t_compute_share=f"{t_comp / a['step_ms']:.4f}",
              note="FlopCounterMode counts matmul-class ops only")
    return out


def dryrun_cli_start(tmp: str) -> list:
    """Start ``python -m repro_torch.launch.dryrun`` on each of
    ``DRYRUN_CELLS`` (the single-pod fake mesh; the host's CPU, no card),
    one process each, all at once."""
    env = dict(os.environ,
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               CUDA_VISIBLE_DEVICES="")
    procs = []
    for arch, shape in DRYRUN_CELLS:
        out = os.path.join(tmp, f"{arch}_{shape}.jsonl")
        procs.append((arch, shape, out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    return procs


def dryrun_cli_finish(t0: float, procs: list) -> dict:
    """Wait for the dry-run processes: exit 0, one ``status: "ok"`` record
    each with finite roofline terms."""
    import math
    out = {}
    for arch, shape, path, proc in procs:
        try:
            _, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"dry-run {arch} {shape} still running "
                                 f"after 300 s")
        if proc.returncode != 0:
            raise AssertionError(f"dry-run {arch} {shape} exit "
                                 f"{proc.returncode}: {err[-2000:]}")
        with open(path) as f:
            recs = [json.loads(ln) for ln in f]
        t = recs[-1].get("roofline", {})
        terms = [t.get(k) for k in ("flops", "t_compute", "t_memory",
                                    "t_collective", "roofline_frac")]
        if len(recs) != 1 or recs[0]["status"] != "ok" or not all(
                isinstance(v, (int, float)) and math.isfinite(v)
                for v in terms):
            raise AssertionError(f"dry-run {arch} {shape}: {recs}")
        out[arch, shape] = recs[0]
        _line("lm-ep", dryrun=f"{arch}/{shape}", mesh=recs[0]["mesh"],
              status="ok", t_compute_ms=f"{t['t_compute'] * 1e3:.2f}",
              t_memory_ms=f"{t['t_memory'] * 1e3:.2f}",
              t_collective_ms=f"{t['t_collective'] * 1e3:.2f}",
              bound=t["bottleneck"],
              useful_flops_frac=f"{t['useful_flops_frac']:.4f}",
              step_host_s=recs[0]["extrap_compile_s"],
              wall_s=f"{time.perf_counter() - t0:.1f}",
              note="a model on H100 constants, not a measurement")
    return out


def phase_lm_ep(torch, args, lm_train: dict) -> dict:
    """Phase 16 (see the module docstring)."""
    from repro_torch.launch.mesh import start_ranks

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        procs = dryrun_cli_start(tmp)
        try:
            out = {"ep": start_ranks(ep_rank, EP_RANKS, "cuda", args.seed,
                                     timeout=300)}
            ep_check(out["ep"], EP_RANKS)
            out["roofline"] = lm_roofline_lines(lm_train)
            out["dryrun"] = dryrun_cli_finish(t0, procs)
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    _line("lm-ep", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    return out


# ---------------------------------------------------------------------------
# the LM mesh path (tools/torch_lm_phase.py --mesh): Trainer(mesh=...) and a
# decode cell on a (data=2, model=2) DeviceMesh of 4 ranks
# ---------------------------------------------------------------------------

LM_MESH_OPT = dict(lr=1e-3, total_steps=3, warmup_steps=1)


def lm_mesh_rank(mesh) -> list:
    """One rank of the LM mesh check (4 ranks, a card each under NCCL):
    the mesh ``Trainer`` (smoke starcoder2-3b, global batch 4, seq 32, 3
    steps) against a one-rank ``Trainer`` on this rank's card, the local
    shards' shapes against their specs, and a decode cell of ``build_cell``
    (qwen3 smoke with 4 heads, 2 KV heads, batch 8, cache 64) against one
    process's serve step. Returns every rank's report (on rank 0)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import SHAPES, InputShape
    from repro_torch.distributed.sharding import Rules, param_shardings
    from repro_torch.launch.steps import build_cell, gather, make_serve_step
    from repro_torch.models import lm
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optim import AdamWConfig, lr_schedule
    from repro_torch.tree import tree_leaves

    dev = mesh.device
    dm = init_device_mesh(dev.type, (2, 2), mesh_dim_names=("data", "model"))
    sizes = {"data": 2, "model": 2}
    opt = AdamWConfig(**LM_MESH_OPT)
    cfg = get_smoke("starcoder2-3b")

    def trainer(m):
        return Trainer(cfg, opt, LoopConfig(steps=3, log_every=100), mesh=m,
                       batch=4, seq=32, device=dev)

    one = trainer(None)
    one_out = one.train()
    tr = trainer(dm)
    t0 = time.perf_counter()
    out = tr.train()
    wall = time.perf_counter() - t0
    gap = _param_gap(gather(tr.params), one.params,
                     sum(float(lr_schedule(opt, t)) for t in (1, 2, 3)),
                     opt.weight_decay)
    loss_rel = max(abs(a - b) / abs(b) for a, b in
                   zip(out["losses"], one_out["losses"]))

    def shards_ok(tree, shardings):
        for x, sh in zip(tree_leaves(tree), tree_leaves(shardings)):
            want = []
            for dim, axes in zip(x.shape, sh.spec):
                n = 1
                for a in (() if axes is None else
                          (axes,) if isinstance(axes, str) else axes):
                    n *= sizes[a]
                want.append(dim // n)
            if tuple(x.to_local().shape) != tuple(want) or \
                    tuple(x.placements) != sh.placements:
                return False
        return True

    rules = Rules(dm)
    shards = (shards_ok(tr.params, param_shardings(tr.params, rules))
              and shards_ok(tr.opt_state.m, param_shardings(
                  tr.params, rules, role="opt")))

    # the MoE on the same mesh: smoke moonshot takes expert parallelism
    # (2 experts a model rank), no token dropped (its capacity factor 4)
    from repro_torch.models import moe
    mcfg = get_smoke(EP_ARCH)

    def moe_trainer(m):
        return Trainer(mcfg, opt, LoopConfig(steps=3, log_every=100),
                       mesh=m, batch=4, seq=32, device=dev)

    moe_one = moe_trainer(None)
    moe_one_out = moe_one.train()
    calls, real_ep = [], moe._moe_ep
    moe._moe_ep = lambda *a: calls.append(1) or real_ep(*a)
    try:
        moe_tr = moe_trainer(dm)
        moe_out = moe_tr.train()
    finally:
        moe._moe_ep = real_ep
    moe_gap = _param_gap(gather(moe_tr.params), moe_one.params,
                         sum(float(lr_schedule(opt, t)) for t in (1, 2, 3)),
                         opt.weight_decay)
    moe_rel = max(abs(a - b) / abs(b) for a, b in
                  zip(moe_out["losses"], moe_one_out["losses"]))

    dcfg = dataclasses.replace(get_smoke("qwen3-8b"), n_heads=4,
                               n_kv_heads=2)
    SHAPES["tiny_decode"] = InputShape("tiny_decode", 64, 8, "decode")
    cell, _, _ = build_cell(dcfg, "tiny_decode", dm,
                            param_dtype=torch.float32)
    params = lm.init_params(dcfg, seed=2, device=dev)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, dcfg.vocab, (8, 1))
                            .astype(np.int32)).to(dev)

    def batch():
        return {"tokens": toks, "cache": lm.zero_cache(dcfg, 8, 64,
                                                       device=dev),
                "cache_len": torch.tensor(5, dtype=torch.int32, device=dev)}

    want = make_serve_step(dcfg)(params, batch())["logits"]
    got = gather(cell(params, batch())["logits"])
    decode_rel = float((got - want).abs().max() / want.abs().max())
    mine = {"rank": dist.get_rank(), "device": str(dev),
            "backend": str(dist.get_backend()),
            "loss_rel": loss_rel, "losses": out["losses"], **gap,
            "shards": shards, "decode_rel": decode_rel,
            "decode_bitwise": bool(torch.equal(got, want)),
            "wall_s": wall, "step": int(tr.opt_state.step),
            "moe_loss_rel": moe_rel, "moe_max_abs": moe_gap["max_abs"],
            "moe_bound": moe_gap["bound"], "moe_ep_calls": len(calls)}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def lm_mesh_check(reports: list) -> None:
    """Gates on every rank's report of :func:`lm_mesh_rank`: losses within
    1e-5 relative of the one-rank Trainer's, parameters within the
    sign-flip bound with 99.9% of each leaf's entries within 1e-6 +
    1e-5·|p|, shards
    of their specs' shapes, 3 steps, decode logits within 1e-5 relative;
    the MoE Trainer through expert parallelism, its losses within 2^-8
    relative of one rank's (its outputs' bf16 sum) and its parameters
    within the sign-flip bound."""
    for r in reports:
        _line("lm-mesh", rank=r["rank"], device=r["device"],
              backend=r["backend"], loss_rel=f"{r['loss_rel']:.2e}",
              param_max_abs=f"{r['max_abs']:.3e}",
              sign_flip_bound=f"{r['bound']:.3e}",
              tight_share=f"{r['tight_share']:.6f}",
              tight_leaf=r["tight_leaf"], shards=r["shards"],
              decode_rel=f"{r['decode_rel']:.2e}",
              decode_bitwise=r["decode_bitwise"],
              train_wall_s=f"{r['wall_s']:.2f}",
              moe_ep_calls=r["moe_ep_calls"],
              moe_loss_rel=f"{r['moe_loss_rel']:.2e}",
              moe_param_max_abs=f"{r['moe_max_abs']:.3e}",
              moe_sign_flip_bound=f"{r['moe_bound']:.3e}")
        if not (r["loss_rel"] <= 1e-5 and r["max_abs"] <= r["bound"]
                and r["tight_share"] >= 0.999 and r["shards"]
                and r["step"] == 3 and r["decode_rel"] <= 1e-5
                and r["moe_ep_calls"] > 0 and r["moe_loss_rel"] <= BF16_EPS
                and r["moe_max_abs"] <= r["moe_bound"]):
            raise AssertionError(f"lm-mesh rank {r['rank']}: {r}")


# ---------------------------------------------------------------------------
# phase 17: tensor-parallel compute (products on local shards over ``model``)
# of the 2-layer cuts on gloo ranks sharing the card; tools/torch_lm_phase.py
# --mesh 4 runs starcoder2-3b's at model=4 on four cards with NCCL
# ---------------------------------------------------------------------------

TP_ARCHS = ("qwen3-8b", "mamba2-1.3b")
TP_MESH = (1, 2)                  # (data, model): gloo ranks on one card
TP_FOUR = (("starcoder2-3b",), (1, 4))   # four cards: the kv_seq_model decode
TP_PAD = 16                       # decode slots past the prefill
TP_REL = 1e-4                     # logits and f32 caches, of the largest entry
# decode logits where the cache's positions are split over ``model``
# (``kv_seq_model``), of the largest entry: each rank's partial softmax
# weights are rounded to the cache's dtype (bf16) before the PV product,
# as the reference's are, and they differ from one process's weights by
# the combine's rescaling, so a weight can round to its other bf16
# neighbour. Four-card readings of starcoder2-3b's cut (NVIDIA H100 80GB
# HBM3, 700 W): 3.91e-4 to 4.80e-4; the same decode on an f32 copy of the
# cache is held to TP_REL (``decode_rel_f32``). The limit leaves twice
# the largest reading.
TP_SPLIT_DECODE_REL = 1e-3


class _CommSpy:
    """Host ms (synchronized) of every c10d collective the ranks' code
    issues, and a count of DTensor's functional collectives (a
    ``TorchDispatchMode`` over the ``_c10d_functional`` ops), while
    entered."""

    NAMES = ("all_gather", "all_to_all_single", "all_reduce")

    def __init__(self, torch):
        from torch.utils._python_dispatch import TorchDispatchMode
        self.torch, self.ms, self.calls, self.funcol = torch, 0.0, 0, 0
        spy = self

        class Count(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func.namespace == "_c10d_functional":
                    spy.funcol += 1
                return func(*args, **(kwargs or {}))

        self.mode = Count()

    def _wrap(self, real):
        torch = self.torch

        def call(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            self.ms += (time.perf_counter() - t) * 1e3
            self.calls += 1
            return out
        return call

    def __enter__(self):
        import torch.distributed as dist

        from repro_torch.distributed import collectives
        self.saved = [(dist, n, getattr(dist, n)) for n in self.NAMES]
        self.saved.append((collectives, "_ALL_GATHER",
                           collectives._ALL_GATHER))
        for mod, name, real in self.saved:
            setattr(mod, name, self._wrap(real))
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        self.mode.__exit__(*exc)
        for mod, name, real in self.saved:
            setattr(mod, name, real)


def _tp_timed(torch, fn):
    """``fn()`` between CUDA events: (its result, ms)."""
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def _tp_slice(full, like, mesh):
    """One process's tensor ``full`` sliced to this rank's block by the
    placements of ``like`` (a DTensor, or anything with placements): a
    local narrow on ``full``'s device, no collective."""
    x = full
    for i, p in enumerate(like.placements):
        if p.is_shard():
            k = x.shape[p.dim] // mesh.size(i)
            x = x.narrow(p.dim, mesh.get_local_rank(
                mesh.mesh_dim_names[i]) * k, k)
    return x


def _tp_cache_excess(torch, got, want, mesh) -> float:
    """The worst of a cache's local blocks against one process's cache
    sliced, in units of its allowance: one bf16 step of the entry for a
    bf16 leaf, plus ``TP_REL`` of the leaf's largest entry."""
    from repro_torch.tree import tree_leaves
    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = _tp_slice(w, g, mesh).cpu().float()
        d = (g.to_local().float() - w).abs()
        if g.dtype == torch.bfloat16:
            d = d - BF16_EPS * 2 * (1 + BF16_EPS * 2) * w.abs()
        worst = max(worst, float(d.max()) / (TP_REL * float(w.abs().max())
                                             + 1e-30))
    return worst


def tp_arch(torch, np, dm, dev, name: str, seed: int) -> dict:
    """One 2-layer cut at published width on the mesh ``dm``: a train
    step, a prefill and a decode token through ``build_cell``'s cells,
    each timed (CUDA events) and then run once more under
    :class:`_CommSpy`; one process's steps on the same card (rank by
    rank, the others waiting with their memory freed) from the same
    seeded parameters and tokens, against which every rank holds its
    blocks; the decode cell starts from one process's prefill cache with
    ``TP_PAD`` free slots."""
    import torch.distributed as dist

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import SHAPES, InputShape
    from repro_torch.launch.steps import (build_cell, make_prefill_step,
                                          make_serve_step, make_train_step)
    from repro_torch.models import lm
    from repro_torch.train.optim import AdamWConfig, adamw_init, lr_schedule
    from repro_torch.tree import tree_leaves, tree_map

    full_cfg = get_arch(name)
    cfg = dataclasses.replace(
        full_cfg, n_layers=LM_LAYERS * len(lm.block_pattern(full_cfg)))
    opt = AdamWConfig(lr=1e-4, total_steps=2, warmup_steps=1)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, LM_S + 1))
                            .astype(np.int32)).to(dev)
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    dtok = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 1))
                            .astype(np.int32)).to(dev)
    SHAPES["tp_train"] = InputShape("tp_train", LM_S, 1, "train")
    SHAPES["tp_prefill"] = InputShape("tp_prefill", LM_S, 1, "prefill")
    SHAPES["tp_decode"] = InputShape("tp_decode", LM_S + TP_PAD, 1,
                                     "decode")
    out = {"arch": name, "mesh": tuple(dm.shape)}

    def fresh():
        torch.cuda.empty_cache()
        return lm.init_params(cfg, seed=seed, device=dev)

    def host(tree):         # a copy, also where the tensors are the host's
        return tree_map(lambda x: x.to_local().to("cpu", copy=True), tree)

    # the mesh's train step and prefill
    torch.cuda.reset_peak_memory_stats()
    cell, _, _ = build_cell(cfg, "tp_train", dm, opt=opt,
                            param_dtype=torch.float32)
    # each rank's blocks placed before the timed call: no whole copy of
    # the leaves or the moments stays alive beside them through the step
    params = fresh()
    params, state = cell.place(params, adamw_init(params))
    (params, state, m), out["train_ms"] = _tp_timed(
        torch, lambda: cell(params, state, batch))
    out["loss"] = float(m["loss"])
    mine = host(params)
    places = [x.placements for x in tree_leaves(params)]
    with _CommSpy(torch) as spy:
        cell(params, state, batch)
    out["train_comm_ms"], out["train_comms"] = spy.ms, spy.calls
    funcol = spy.funcol
    del params, state
    cell, _, _ = build_cell(cfg, "tp_prefill", dm,
                            param_dtype=torch.float32)
    params, = cell.place(fresh())
    pre, out["prefill_ms"] = _tp_timed(
        torch, lambda: cell(params, {"tokens": batch["tokens"]}))
    with _CommSpy(torch) as spy:
        cell(params, {"tokens": batch["tokens"]})
    out["prefill_comm_ms"], out["prefill_comms"] = spy.ms, spy.calls
    funcol += spy.funcol
    pre_logits = pre["logits"].to_local().cpu()
    pre_place = _Placed(pre["logits"].placements)
    pre_cache = tree_map(lambda x: _Local(x.to_local().cpu(), x),
                         pre["cache"])
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    del params, pre

    # one process on the same card, rank by rank
    r = dist.get_rank()
    for turn in range(dist.get_world_size()):
        dist.barrier()
        if turn != r:
            continue
        one = fresh()
        st = adamw_init(one)
        one, st, one_m = make_train_step(cfg, opt)(one, st, batch)
        out["one_loss"] = float(one_m["loss"])
        want = [_tp_slice(w, _Placed(p), dm)
                for w, p in zip(tree_leaves(one), places)]
        out.update(_param_gap(tree_leaves(mine), want,
                              float(lr_schedule(opt, 1)),
                              opt.weight_decay))
        del one, st, want, mine
        one = fresh()
        wp = make_prefill_step(cfg)(one, {"tokens": batch["tokens"]})
        out["prefill_rel"] = _rel(torch, pre_logits, _tp_slice(
            wp["logits"], pre_place, dm).cpu())
        out["prefill_cache"] = _tp_cache_excess(torch, pre_cache,
                                                wp["cache"], dm)
        cache = _pad_kv(torch, wp["cache"], TP_PAD)
        wd = make_serve_step(cfg)(one, {
            "tokens": dtok, "cache": cache,
            "cache_len": torch.tensor(LM_S, dtype=torch.int32)})
        one_dec = {"logits": wd["logits"].cpu(),
                   "cache": tree_map(lambda x: x.cpu(), wd["cache"])}
        cache_host = tree_map(lambda x: x.cpu(), cache)
        cache32 = tree_map(lambda x: x.float(), cache)
        one_dec["logits_f32"] = make_serve_step(cfg)(one, {
            "tokens": dtok, "cache": cache32,
            "cache_len": torch.tensor(LM_S, dtype=torch.int32)})[
                "logits"].cpu()
        del one, wp, wd, cache, cache32
        torch.cuda.empty_cache()
    dist.barrier()

    # the mesh's decode token from one process's cache
    cell, _, _ = build_cell(cfg, "tp_decode", dm, param_dtype=torch.float32)
    params, = cell.place(fresh())

    def dec_batch(dtype=None):
        return {"tokens": dtok,
                "cache": tree_map(lambda x: x.to(dev, dtype), cache_host),
                "cache_len": torch.tensor(LM_S, dtype=torch.int32,
                                          device=dev)}

    b = dec_batch()
    dec, out["decode_ms"] = _tp_timed(torch, lambda: cell(params, b))
    b = dec_batch()
    with _CommSpy(torch) as spy:
        cell(params, b)
    out["decode_comm_ms"], out["decode_comms"] = spy.ms, spy.calls
    out["funcol"] = funcol + spy.funcol
    out["decode_rel"] = _rel(torch, dec["logits"].to_local().cpu(),
                             _tp_slice(one_dec["logits"], dec["logits"], dm))
    out["decode_cache"] = _tp_cache_excess(
        torch, tree_map(lambda x: _Local(x.to_local().cpu(), x),
                        dec["cache"]), one_dec["cache"], dm)
    out["finite"] = bool(torch.isfinite(dec["logits"].to_local()).all())
    out["split_positions"] = any(                    # a KV cache's dim 2
        p.is_shard(2) for blk in dec["cache"] if "k" in blk
        for p in blk["k"].placements)
    # the same token on an f32 copy of the cache: no weight is rounded
    del dec, b
    dec = cell(params, dec_batch(torch.float32))
    out["decode_rel_f32"] = _rel(
        torch, dec["logits"].to_local().cpu(),
        _tp_slice(one_dec["logits_f32"], dec["logits"], dm))
    del params, dec
    torch.cuda.empty_cache()
    return out


class _Placed:
    """Stands for a DTensor in :func:`_tp_slice`: its placements only."""

    def __init__(self, placements):
        self.placements = placements


class _Local(_Placed):
    """A host copy of a DTensor's local block, with its placements."""

    def __init__(self, local, like):
        super().__init__(like.placements)
        self.local, self.dtype = local, local.dtype

    def to_local(self):
        return self.local


def tp_rank(mesh, seed: int, shape=TP_MESH, archs=TP_ARCHS) -> list:
    """Phase 17 on one rank of a (data, model) ``shape`` mesh (module
    docstring): :func:`tp_arch` of each arch. Returns every rank's
    reports."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    for f in (torch.backends.cuda.matmul, torch.backends.cudnn):
        f.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    dm = init_device_mesh(mesh.device.type, shape,
                          mesh_dim_names=("data", "model"))
    reps = []
    for name in archs:
        t0 = time.perf_counter()
        rep = tp_arch(torch, np, dm, mesh.device, name, seed)
        rep.update(rank=dist.get_rank(), device=str(mesh.device),
                   backend=str(dist.get_backend()),
                   wall_s=time.perf_counter() - t0)
        reps.append(rep)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, reps)
    return every


def tp_check(reports: list) -> None:
    """Phase 17's gates on every rank's reports: the loss within
    ``LM_SMOKE_REL`` of one process's, every parameter block within the
    sign-flip bound and 99.9% of each leaf within 1e-6 + 1e-5·|p|, the
    prefill logits within ``TP_REL`` and the decode logits within
    ``TP_REL`` of one process's largest (``TP_SPLIT_DECODE_REL`` where the
    cache's positions are split; on an f32 copy of the cache ``TP_REL``
    always), the caches within their allowance (``_tp_cache_excess`` at
    most 1), finite logits, and no DTensor functional collective."""
    for reps in reports:
        for r in reps:
            loss_rel = abs(r["loss"] - r["one_loss"]) / abs(r["one_loss"])
            _line("lm-tp", rank=r["rank"], device=r["device"],
                  backend=r["backend"], arch=r["arch"],
                  mesh="data=%d,model=%d" % r["mesh"], B=1, S=LM_S,
                  train_ms=f"{r['train_ms']:.3f}",
                  train_comm_ms=f"{r['train_comm_ms']:.3f}",
                  train_comms=r["train_comms"],
                  prefill_ms=f"{r['prefill_ms']:.3f}",
                  prefill_comm_ms=f"{r['prefill_comm_ms']:.3f}",
                  prefill_comms=r["prefill_comms"],
                  decode_ms=f"{r['decode_ms']:.3f}",
                  decode_comm_ms=f"{r['decode_comm_ms']:.3f}",
                  decode_comms=r["decode_comms"],
                  peak_gib=f"{r['peak_gib']:.2f}",
                  loss_rel=f"{loss_rel:.2e}",
                  param_max_abs=f"{r['max_abs']:.3e}",
                  sign_flip_bound=f"{r['bound']:.3e}",
                  tight_share=f"{r['tight_share']:.6f}",
                  prefill_rel=f"{r['prefill_rel']:.2e}",
                  prefill_cache=f"{r['prefill_cache']:.3f}",
                  decode_rel=f"{r['decode_rel']:.2e}",
                  split_positions=r["split_positions"],
                  decode_rel_f32=f"{r['decode_rel_f32']:.2e}",
                  decode_cache=f"{r['decode_cache']:.3f}",
                  funcol=r["funcol"], wall_s=f"{r['wall_s']:.1f}",
                  note=("comm ms: a second run under a synchronizing spy; "
                        "ranks time-slice one card over gloo: not a "
                        "scaling number") if r["backend"] == "gloo"
                  else "comm ms: a second run under a synchronizing spy")
            if not (loss_rel <= LM_SMOKE_REL and r["max_abs"] <= r["bound"]
                    and r["tight_share"] >= 0.999
                    and r["prefill_rel"] <= TP_REL
                    and r["decode_rel"] <= (TP_SPLIT_DECODE_REL
                                            if r["split_positions"]
                                            else TP_REL)
                    and r["decode_rel_f32"] <= TP_REL
                    and r["prefill_cache"] <= 1.0
                    and r["decode_cache"] <= 1.0
                    and r["finite"] and r["funcol"] == 0):
                raise AssertionError(f"lm-tp rank {r['rank']}: {r}")


def phase_lm_tp(args) -> list:
    """Phase 17 (see the module docstring). This process's cached blocks
    are freed first: the ranks share the card with it."""
    import gc

    import torch

    from repro_torch.launch.mesh import start_ranks
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() / 2 ** 30
    reports = start_ranks(tp_rank, TP_MESH[0] * TP_MESH[1], "cuda",
                          args.seed, timeout=300)
    tp_check(reports)
    _line("lm-tp", phase_seconds=f"{time.perf_counter() - t0:.1f}",
          parent_reserved_gib=f"{held:.2f}")
    return reports


# ---------------------------------------------------------------------------
# phase 18: the examples (examples/torch_*.py) on the card
# ---------------------------------------------------------------------------

EXAMPLE_100M_BATCHES = "60"    # past the 100M run's batch-50 checkpoint
# (label, script, arguments beyond its defaults, the kernel it must launch
# (None: none), patterns of the lines it must print)
EXAMPLE_RUNS = (
    ("quickstart", "torch_quickstart.py", (), "cuda_pipelined",
     ("^throughput: ", "^quality: ")),
    ("serve", "torch_serve_w2v.py", (), "cuda",
     ("^swap: ", "^answers_changed=True", "^serve_w2v: ok$")),
    ("lm", "torch_lm_train_smoke.py", (), None,
     (r"^\S+: step 20, loss [\d.]+ -> [\d.]+ ",)),
    ("distributed", "torch_distributed_w2v.py", (), "cuda_tiled",
     ("^throughput: ", "^quality: ")),
    ("100m", "torch_train_100m_w2v.py",
     ("--batches", EXAMPLE_100M_BATCHES), "cuda_pipelined",
     ("^  batch 50: ", "^trained ", "^embedding norms: ")),
    ("100m resume", "torch_train_100m_w2v.py",
     ("--batches", EXAMPLE_100M_BATCHES), None,
     (f"^resumed from checkpoint batch {EXAMPLE_100M_BATCHES}$",
      "^trained ")),
)
# the lines phase 18 prints for each example (its numbers)
EXAMPLE_KEEP = (r"^(backend=|throughput: |quality: |serving: |swap: "
                r"|answers_changed=|vocab=|resumed |trained "
                r"|embedding norms: |\S+: step \d+, loss )")


def _dump_launches(out: str, tag: str) -> None:
    """This process's kernel launch counts, as ``out/<tag>-<pid>.json``."""
    from repro_torch.kernels import fullw2v
    with open(os.path.join(out, f"{tag}-{os.getpid()}.json"), "w") as f:
        json.dump({"launches": fullw2v.LAUNCHES,
                   "seq": fullw2v.SEQ_LAUNCHES,
                   "tiled": fullw2v.TILED_LAUNCHES}, f)


def example_rank(mesh, fn, out: str, *args, **kwargs):
    """A rank of an example's ``start_ranks``: its own function, then its
    launch counts."""
    try:
        return fn(mesh, *args, **kwargs)
    finally:
        _dump_launches(out, f"rank{mesh.rank}")


def example_child(path: str, argv: list, out: str) -> None:
    """Run ``path`` as ``__main__`` with ``argv`` in this process (started by
    :func:`run_example`) and write its launch counts, and each rank's when
    it starts ranks, under ``out``. The example itself is unchanged: its
    ``start_ranks`` is wrapped so that each rank reports too."""
    import runpy

    from repro_torch.launch import mesh
    start = mesh.start_ranks

    def counted(fn, n, device=None, *args, **kwargs):
        return start(example_rank, n, device, fn, out, *args, **kwargs)

    mesh.start_ranks = counted
    sys.argv = [path, *argv]
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        _dump_launches(out, "main")


def run_example(script: str, argv, tmp: str) -> tuple:
    """One example as a subprocess on the default device (the GPU): exit 0
    or raise. Returns its standard output, its seconds and the launch
    counts summed over its processes."""
    out = tempfile.mkdtemp(prefix="launches_", dir=tmp)
    path = os.path.join(ROOT, "examples", script)
    code = (f"import sys; sys.path[:0] = [{ROOT!r}, "
            f"{os.path.join(ROOT, 'src')!r}]; import chip_smoke; "
            f"chip_smoke.example_child({path!r}, {list(argv)!r}, {out!r})")
    env = dict(os.environ, TMPDIR=tmp,
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                           capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as e:
        raise AssertionError(f"{script} still running after 300 s") from e
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"{script} {' '.join(argv)} exited "
                             f"{r.returncode}:\n{r.stdout[-2000:]}\n"
                             f"{r.stderr[-3000:]}")
    counts: dict = {"launches": {}, "seq": {}, "tiled": {}, "ranks": 0}
    for name in os.listdir(out):
        with open(os.path.join(out, name)) as f:
            got = json.load(f)
        counts["ranks"] += name.startswith("rank")
        for key in ("launches", "seq", "tiled"):
            for k, v in got[key].items():
                if v:
                    counts[key][k] = counts[key].get(k, 0) + v
    return r.stdout, seconds, counts


def _example_report(label: str, argv, kernel, want, result) -> dict:
    """Check one example's run (closing lines, the kernel of its path and
    no other, four rank reports for the distributed one), print its line
    and return its launches."""
    import re
    text, seconds, counts = result
    missing = [w for w in want if not re.search(w, text, re.M)]
    if missing:
        raise AssertionError(f"{label}: no line {missing} in "
                             f"{text[-2000:]!r}")
    launched = counts["launches"]
    if kernel is None:
        if launched:
            raise AssertionError(f"{label}: launched {launched}, wanted no "
                                 f"kernel")
    elif not launched.get(kernel) or set(launched) != {kernel}:
        raise AssertionError(f"{label}: launched {launched}, wanted "
                             f"{kernel} only")
    if label == "distributed" and counts["ranks"] != 4:
        raise AssertionError(f"distributed: {counts['ranks']} rank reports, "
                             f"wanted 4")
    lines = [ln.strip() for ln in text.splitlines()
             if re.match(EXAMPLE_KEEP, ln)]
    _line("examples", example=json.dumps(label),
          args=json.dumps(" ".join(argv[:2])), seconds=f"{seconds:.1f}",
          launches=json.dumps(launched),
          bodies=json.dumps({"seq": counts["seq"], "tiled": counts["tiled"]}),
          lines=json.dumps(lines))
    return launched


def phase_examples(torch) -> dict:
    """Phase 18 (see the module docstring): each example at its defaults
    (the 100M run to batch 60, then again on its checkpoint directory),
    as a user runs it, one after another. Returns each kernel's launches
    by example."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    by_kernel: dict = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        ckpt = os.path.join(tmp, "w2v_100m_ckpt")
        for label, script, argv, kernel, want in EXAMPLE_RUNS:
            if script == "torch_train_100m_w2v.py":
                argv = (*argv, "--ckpt-dir", ckpt)
            result = run_example(script, argv, tmp)
            for k, v in _example_report(label, argv, kernel, want,
                                        result).items():
                by_kernel.setdefault(k, {})[label] = v
    _line("examples", phase_seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_kernel


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sentences-per-batch", dest="S", type=int,
                    default=10_000)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.batches < 2:
        ap.error("--batches must be at least 2: phase 7 resumes mid-run")

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device; chip_smoke.py runs on the GPU only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in f32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _line("device", name=json.dumps(kind), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.load()
    ptxas = [ln.strip() for ln in lib.log.splitlines()
             if "registers" in ln or "spill" in ln]
    _line("build", seconds=f"{time.perf_counter() - t0:.1f}",
          nvcc_seconds=f"{lib.seconds:.1f}", built=lib.built,
          library=os.path.relpath(lib.path, ROOT))
    for ln in ptxas:
        print(f"[build] ptxas: {ln}", flush=True)

    # 3. kernels vs plain versions on the card
    errs, small = phase_parity(torch, np, args.seed)

    # 4. the main path: TrainSession, auto backend, then cuda by name, then
    # the vocab-sharded session (K4)
    sess1, n_pipe, s_pipe, inst_pipe, h_pipe = phase_trainer(
        torch, np, args, 1, "auto", "cuda_pipelined")
    while s_pipe > 60 and args.S >= 2:      # keep the run inside its limit
        args.S //= 2
        _line("trainer", note="ordered step over 60 s", S_halved_to=args.S)
        sess1, n_pipe, s_pipe, inst_pipe, h_pipe = phase_trainer(
            torch, np, args, 1, "auto", "cuda_pipelined")
    sess8, n_tiled, s_tiled, inst_tiled, h_tiled = phase_trainer(
        torch, np, args, 8, "auto", "cuda_tiled")
    _, n_seq, s_seq, inst_seq, h_seq = phase_trainer(torch, np, args, 1,
                                                     "cuda", "cuda")
    frac = sharded_hot_frac(np, sess8.pipeline)
    sess_vs, n_fused, s_fused, inst_fused, h_fused = phase_trainer(
        torch, np, args, 8, "auto", "cuda_tiled", vocab_shard=True,
        hot_vocab_frac=frac)
    if not np.array_equal(sess_vs.embeddings(), sess8.embeddings()):
        raise AssertionError("the one-shard vocab-sharded session's "
                             "embeddings differ from the replicated "
                             "cuda_tiled session's")
    _line("trainer", bitwise="vocab_shard(1 shard)==replicated cuda_tiled")
    launches = {"cuda": n_seq, "cuda_pipelined": n_pipe,
                "cuda_tiled": n_tiled, "cuda_tiled_fused": n_fused}
    step_s = {"cuda": s_seq, "cuda_pipelined": s_pipe, "cuda_tiled": s_tiled,
              "cuda_tiled_fused": s_fused}
    host = {"cuda": h_seq, "cuda_pipelined": h_pipe, "cuda_tiled": h_tiled,
            "cuda_tiled_fused": h_fused}

    # 5. each kernel at the trainer's batch shape: parity, then time
    # (each on a prefix: K3(T=1) equals K1 and K2 bit for bit on the whole
    # batch, and K4 equals K3 at phase 4)
    timing = phase_main_shape(torch, np, sess1.pipeline, sess1.cfg,
                              ["cuda", "cuda_pipelined"], PARITY_SENTENCES)
    timing.update(phase_main_shape(torch, np, sess8.pipeline, sess8.cfg,
                                   ["cuda_tiled"], PARITY_SENTENCES))
    timing["cuda_tiled_fused"] = phase_sharded_shape(torch, np, sess_vs,
                                                     s_fused)
    plan_costs_line(timing, smi)

    # 6. prefetch workers on the main path, bit for bit against phase 4
    for workers, mode in ((2, "thread"), (4, "thread"), (2, "process")):
        phase_prefetch(torch, np, args, sess1, workers, mode)
    for workers, mode in ((2, "thread"), (2, "process")):
        phase_prefetch(torch, np, args, sess8, workers, mode)

    # 7. checkpoints: resume mid-epoch, and across table layouts
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        phase_resume(torch, np, args, sess1, tmp, "T=1 auto", 2)
        _, d_vs = phase_resume(torch, np, args, sess_vs, tmp,
                               "T=8 sharded", 2)
        phase_cross_restore(torch, args, sess8, d_vs)

    # 8. supervised recovery through the reference's fault kinds
    phase_chaos(torch, args)

    # 9. mixed-precision tables: the codec on the card, the main path's
    # kernels under bf16 and int8 storage, a resume, the quality gate
    phase_codec(torch, np, args, sess1.pipeline.table_rows, sess1.cfg.dim)
    mixed = {}
    for tables, tile, kernel in MIXED_RUNS:
        sess_mx, mixed[tables, tile] = phase_mixed_run(
            torch, np, args, tables, tile, kernel, frac)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mixed_") as tmp:
        phase_resume(torch, np, args, sess_mx, tmp, "T=8 mixed int8 master",
                     2)
    quality = phase_mixed_quality(torch, np, args)

    # 10. multi-rank on the one card: data parallelism and vocab sharding
    # on gloo ranks that time-slice it (N=2, then N=4 at reduced depth)
    mesh_launches = phase_mesh(args, frac)

    # 11. the workload frontends: node2vec on the kernels, doc2vec and
    # subword on the plain versions; the pWord2Vec-like baseline
    fe = phase_frontends(torch, np, args, quality["f32"]["separation"])

    # 12. serving: phase 4's and phase 9's trained tables behind the port's
    # serving stack, a 2,000,000-row table under load, chaos, ranks, the CLI
    phase_serve(torch, np, args, [
        ("replicated T=1 auto (K2)", sess1),
        ("split T=8 one shard (K4)", sess_vs),
        (f"int8 {MIXED_RUNS[-1][0]} T=8 (K4)", sess_mx)])

    # 13. supervised recovery under a mesh: the ci schedule on 2 gloo
    # ranks, its rank-local faults on rank 1, and the CLI's resilience
    # flags on 2 ranks
    chaos_launches = phase_mesh_chaos(args, frac)

    # 14. the LM substrate at published widths (2 layers): forward, loss
    # and backward, prefill and decode, against the CPU; int8 compression
    phase_lm(torch, np, args)

    # 15. LM training: the lm CLI and the Trainer's loop properties at
    # smoke size, the card's step against the CPU's, and four Trainer steps
    # of each full-width cut (AdamW timed apart)
    lm_train = phase_lm_train(torch)

    # 16. the MoE's expert parallelism at published width on gloo ranks
    # sharing the card (against the local path and the CPU), the
    # roofline's count of phase 15's steps, and the dry-run CLI
    phase_lm_ep(torch, args, lm_train)

    # 17. tensor-parallel compute: qwen3-8b's and mamba2-1.3b's cuts on a
    # (data=1, model=2) mesh of gloo ranks sharing the card, a train step,
    # a prefill and a decode token against one process on the card
    phase_lm_tp(args)

    # 18. the five examples (examples/torch_*.py) as a user runs them, each
    # in its own process on the card; their launches of K1-K4
    example_launches = phase_examples(torch)
    mixed_launches = {"cuda": {QUALITY_MIXED: quality["mixed"]["launches"]}}
    for (tables, tile), m in mixed.items():
        mixed_launches.setdefault(m["kernel"], {})[tables] = m["launches"]
    files = {"cuda": "src/repro_torch/kernels/csrc/seq.cuh",
             "cuda_pipelined": "src/repro_torch/kernels/csrc/seq.cuh",
             "cuda_tiled": "src/repro_torch/kernels/csrc/tiled.cuh",
             "cuda_tiled_fused": "src/repro_torch/kernels/csrc/tiled.cuh"}
    trained_with = {"cuda": inst_seq, "cuda_pipelined": inst_pipe,
                    "cuda_tiled": inst_tiled, "cuda_tiled_fused": inst_fused}
    sources = {"cuda": ("_kernel", "src/repro/kernels/fullw2v.py:284"),
               "cuda_pipelined": ("_kernel_pipelined",
                                  "src/repro/kernels/fullw2v.py:376"),
               "cuda_tiled": ("_kernel_tiled",
                              "src/repro/kernels/fullw2v.py:537"),
               "cuda_tiled_fused": ("_kernel_tiled (hot_rows>0) via "
                                    "fullw2v_pallas_tiled_fused",
                                    "src/repro/kernels/fullw2v.py:1078")}
    kernels = []
    for name in ("cuda", "cuda_pipelined", "cuda_tiled", "cuda_tiled_fused"):
        row = {
            "name": name, "route": "cuda",
            "source": files[name],
            "replaces": sources[name][1], "replaces_fn": sources[name][0],
            "launches": launches[name],
            "max_abs_err": timing[name]["max_abs_err"],
            "ms": timing[name]["ms"],
            "plain_ms": timing[name]["plain_ms"],
            # max_abs_err and plain_ms: the batch's first sentences
            "parity_sentences": timing[name]["parity_sentences"],
            "bound_ms": timing[name]["bound_ms"],
            "bound_by": timing[name]["bound_by"],
            "library_ms": None,
            "small_max_abs_err": errs[name],
            "small_ms": small[name]["small_ms"],
            "small_plain_ms": small[name]["plain_ms"],
            "step_s": step_s[name],
            **host[name],
            "us_per_window": timing[name]["us_per_window"],
            "windows_per_launch": timing[name]["windows"],
            "sentences_per_batch": timing[name]["S"],
            "small_shape": "S=8 L=96 V=4096 d=128 N=5 W_f=3",
        }
        if name in trained_with:
            row["instantiation"] = timing[name]["instantiation"]
            row["trainer_instantiation"] = trained_with[name]
        if name == "cuda_tiled_fused":
            row.update({k: timing[name][k] for k in (
                "exchange_ms", "hot", "R", "cold_rows", "step_share")})
        if name in ("cuda_tiled", "cuda_tiled_fused"):
            row.update({k: timing[name][k] for k in (
                "live_tiles", "strict_share", "mean_unique_rows",
                "host_prefetched", "host_rejected")})
        # launches under bf16/int8 storage (phase 9), by --tables spec
        row["mixed_launches"] = mixed_launches[name]
        # launches on each rank of phase 10's runs, by run
        row["multi_rank_launches"] = mesh_launches.get(name, {})
        # launches in phase 11's node2vec runs (rank 0 of the mesh run)
        row["node2vec_launches"] = fe["launches"].get(name, {})
        # launches on each rank of phase 13's chaos runs (baseline and
        # faulted run, replays included), by run
        row["mesh_chaos_launches"] = chaos_launches.get(name, {})
        # launches in phase 18's examples (all their processes), by example
        row["example_launches"] = example_launches.get(name, {})
        kernels.append(row)
    _line("total", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi, flush=True)     # the card and its limit, beside the numbers
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
