#!/usr/bin/env python3
"""Smoke test of the torch port on one NVIDIA GPU: builds the CUDA kernels,
holds each against its plain PyTorch version, trains through the port's
main path and times the kernels.

    python3 chip_smoke.py [--seed 0] [--sentences-per-batch 10000]

Phases (each prints one line; any failure raises and the script exits
non-zero):

1. device   — the card's name and power limit (nvidia-smi).
2. build    — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``.
3. parity   — ``cuda``, ``cuda_pipelined`` and ``cuda_tiled`` (T=8, G=4,
              some strict tiles) against their plain versions on the card
              (atol 2e-5, rtol 1e-4, the JAX package's kernel tolerance);
              K2 == K1 and K3(T=1) == K1 bit for bit.
4. trainer  — ``TrainSession`` with ``backend="auto"`` on the card at the
              paper's width (d=128, W=5, N=5, S=10,000 sentences per batch,
              65,536-word cluster corpus, 3 batches): T=1 must resolve to
              ``cuda_pipelined``, T=8 to ``cuda_tiled``; a third run asks
              for ``cuda`` by name. Launch counts are zeroed before each run
              and read after it.
5. timing   — each kernel on the trainer's first batch (the main path's
              shapes) against its plain version on the same inputs, then
              timed (CUDA events) beside its bound and the plain version's
              time; one JSON line lists them.

The last line is ``{"ok": true, "device": {...}}``. Without a GPU, or
without the repository's ``src/`` beside it, the script fails before
printing any result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 peak outside the tensor cores
ATOL, RTOL = 2e-5, 1e-4


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
    for name, got in (("cuda_pipelined", k2), ("cuda_tiled(T=1)", k3_t1)):
        same = torch.equal(got[0], k1[0]) and torch.equal(got[1], k1[1])
        if not same:
            raise AssertionError(f"{name} is not bit-identical to cuda")
        _line("parity", bitwise=f"{name}==cuda")
    moved = float((k1[0] - tens(inp["w_in"])).abs().max())
    if moved < 1e-4:
        raise AssertionError(f"cuda left w_in unchanged (max delta {moved})")

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
    return errs, timing


def make_pipeline(args, tile: int):
    from repro_torch.configs.w2v import W2VConfig
    from repro_torch.data.batching import BatchingPipeline
    from repro_torch.data.corpus import synthetic_cluster_corpus

    cfg = W2VConfig(dim=128, window=5, negatives=5, epochs=1, min_count=1,
                    subsample_t=0.0, sentences_per_batch=args.S,
                    max_sentence_len=64, tile_windows=tile,
                    tile_gemm_windows=4, seed=args.seed)
    corpus = synthetic_cluster_corpus(
        n_clusters=64, words_per_cluster=65536 // 64,
        n_sentences=args.S * args.batches, mean_len=24, seed=args.seed)
    return BatchingPipeline(corpus, cfg), cfg, corpus


def phase_trainer(torch, np, args, tile: int, backend: str, expect: str):
    """One main-path run; returns (pipeline, cfg, launches, seconds/step)."""
    from repro_torch.core.quality import evaluate
    from repro_torch.core.trainer import TrainSession
    from repro_torch.kernels import fullw2v

    pipe, cfg, corpus = make_pipeline(args, tile)
    sess = TrainSession(pipe, cfg, backend=backend, device="cuda")
    if sess.backend != expect:
        raise AssertionError(f"backend={backend!r} at T={tile} resolved to "
                             f"{sess.backend!r}, expected {expect!r}")
    w0 = sess.state.w_in.clone()
    fullw2v.reset_launch_counts()
    sess.train(max_batches=args.batches)
    launches = dict(fullw2v.LAUNCHES)
    batches = sess.state.batches_seen
    if launches[expect] != batches or batches != args.batches:
        raise AssertionError(f"{expect}: {launches[expect]} launches for "
                             f"{batches} batches ({launches})")
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
    _line("trainer", T=tile, backend=sess.backend, S=cfg.sentences_per_batch,
          batches=batches, words_per_s=f"{sess.words_per_sec:.0f}",
          s_per_step=f"{step_s:.4f}", launches=launches[expect],
          separation=f"{q['separation']:.4f}",
          nn_purity=f"{q['nn_purity']:.4f}")
    return pipe, cfg, launches[expect], step_s


def phase_main_shape(torch, np, pipe, cfg, names):
    """Each named kernel on the pipeline's first batch, at the shapes the
    main path gives it: held against its plain version on the same inputs
    (same tolerance as phase 3), then timed (CUDA events) beside its bound
    and the plain version's time."""
    from repro_torch.kernels import ops, registry

    batch = next(pipe.batches(pad_len=cfg.resolved_pad_len, epoch=0))
    step = batch.step_inputs(cfg.lr, torch.device("cuda"))
    static = ops.static_for(cfg, step.tile)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = (pipe.table_rows, cfg.dim)
    w_in = (torch.rand(shape, generator=gen, device="cuda") - 0.5) / cfg.dim
    w_out = (torch.rand(shape, generator=gen, device="cuda") - 0.5) / cfg.dim

    def tables():
        return w_in.clone(), w_out.clone()

    plain = registry.get("torch_tiled" if step.has_plan else "torch")
    want = tables()
    plain_ms = _host_ms(torch, lambda: plain.update(*want, step, static))
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
        be.update(*got, step, static)
        torch.cuda.synchronize()
        results[name] = (got[0].clone(), got[1].clone())
        err = max(_check_close(torch, f"{name} w_in (main shape)", got[0],
                               want[0]),
                  _check_close(torch, f"{name} w_out (main shape)", got[1],
                               want[1]))
        ms = _time_ms(torch, lambda: be.update(*got, step, static), 2)
        out[name] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         bound_ms=b_ms, bound_by=b_by,
                         windows=int(batch.lengths.sum()),
                         S=int(batch.tokens.shape[0]))
        _line("main-shape", kernel=name, S=out[name]["S"],
              L=int(batch.tokens.shape[1]), max_abs_err=f"{err:.3e}",
              plain_ms=f"{plain_ms:.1f}")
        _line("timing", kernel=name, ms_per_launch=f"{ms:.3f}",
              launches_per_step=1, bound_ms=f"{b_ms:.4f}", bound_by=b_by,
              windows=out[name]["windows"])
        if not bool(torch.isfinite(got[0]).all()):
            raise AssertionError(f"{name}: timing runs produced non-finite "
                                 f"tables")
    if "cuda" in results and "cuda_pipelined" in results:
        k1, k2 = results["cuda"], results["cuda_pipelined"]
        if not (torch.equal(k1[0], k2[0]) and torch.equal(k1[1], k2[1])):
            raise AssertionError("cuda_pipelined is not bit-identical to "
                                 "cuda at the main path's shape")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sentences-per-batch", dest="S", type=int,
                    default=10_000)
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args(argv)

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

    # 4. the main path: TrainSession, auto backend, then cuda by name
    pipe1, cfg1, n_pipe, s_pipe = phase_trainer(
        torch, np, args, 1, "auto", "cuda_pipelined")
    while s_pipe > 60 and args.S >= 2:      # keep the run inside its limit
        args.S //= 2
        _line("trainer", note="ordered step over 60 s", S_halved_to=args.S)
        pipe1, cfg1, n_pipe, s_pipe = phase_trainer(
            torch, np, args, 1, "auto", "cuda_pipelined")
    pipe8, cfg8, n_tiled, s_tiled = phase_trainer(
        torch, np, args, 8, "auto", "cuda_tiled")
    _, _, n_seq, s_seq = phase_trainer(torch, np, args, 1, "cuda", "cuda")
    launches = {"cuda": n_seq, "cuda_pipelined": n_pipe,
                "cuda_tiled": n_tiled}
    step_s = {"cuda": s_seq, "cuda_pipelined": s_pipe, "cuda_tiled": s_tiled}

    # 5. each kernel at the trainer's batch shape: parity, then time
    timing = phase_main_shape(torch, np, pipe1, cfg1,
                              ["cuda", "cuda_pipelined"])
    timing.update(phase_main_shape(torch, np, pipe8, cfg8, ["cuda_tiled"]))
    sources = {"cuda": ("_kernel", "src/repro/kernels/fullw2v.py:284"),
               "cuda_pipelined": ("_kernel_pipelined",
                                  "src/repro/kernels/fullw2v.py:376"),
               "cuda_tiled": ("_kernel_tiled",
                              "src/repro/kernels/fullw2v.py:537")}
    kernels = []
    for name in ("cuda", "cuda_pipelined", "cuda_tiled"):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fullw2v.cu",
            "replaces": sources[name][1], "replaces_fn": sources[name][0],
            "launches": launches[name],
            "max_abs_err": timing[name]["max_abs_err"],
            "ms": timing[name]["ms"],
            "plain_ms": timing[name]["plain_ms"],
            "bound_ms": timing[name]["bound_ms"],
            "bound_by": timing[name]["bound_by"],
            "library_ms": None,
            "small_max_abs_err": errs[name],
            "small_ms": small[name]["small_ms"],
            "small_plain_ms": small[name]["plain_ms"],
            "step_s": step_s[name],
            "windows_per_launch": timing[name]["windows"],
            "sentences_per_batch": timing[name]["S"],
            "small_shape": "S=8 L=96 V=4096 d=128 N=5 W_f=3",
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
