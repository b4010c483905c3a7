"""Embedding query server CLI of the torch port (DESIGN.md §10).

The port's counterpart of ``repro.launch.serve``, with the same flags and
grep-able lines (``serving:``, ``oracle_parity=``, ``serve_stats:``,
``follow_done:``), on the GPU unless ``--device cpu`` is given. Loads the
newest checkpoint under ``--ckpt-dir`` (either package's format) into an
:class:`~repro_torch.serve.index.EmbeddingIndex`, stands up the batching
:class:`~repro_torch.serve.server.EmbeddingServer` behind a
:class:`~repro_torch.serve.snapshot.SnapshotWatcher`, answers a scripted
query load, and prints stats.

``--shards N>1`` serves over N ranks, one process each
(``repro_torch.launch.mesh.start_ranks``: NCCL with a card per rank, else
gloo): rank 0 runs the watcher and the server and prints; the other ranks
follow its command stream (``serve_follower``).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir /tmp/ckpt \\
      --queries 64 --check-oracle
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir /tmp/ckpt \\
      --device cpu --shards 2 --follow 10

The module imports no torch at top level: the ranks import the ``python
-m`` module as their ``__mp_main__``.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt-dir", required=True,
                    help="checkpoint directory to serve from (and follow)")
    ap.add_argument("--shards", type=int, default=0,
                    help="serve over N ranks, one process each; 0/1 = one "
                         "process — still the sharded code path on a "
                         "1-shard layout")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the GPU; 'cpu' "
                         "runs on the CPU)")
    ap.add_argument("--batch-size", type=int, default=32,
                    help="most query rows the request coalescer puts in "
                         "one device call")
    ap.add_argument("--deadline-ms", type=float, default=2.0,
                    help="max wait for co-riders before a batch is cut "
                         "short")
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--queries", type=int, default=64,
                    help="scripted random queries to answer before exit")
    ap.add_argument("--mode", default="both",
                    choices=("nn", "analogy", "both"))
    ap.add_argument("--check-oracle", action="store_true",
                    help="recompute every response against the dense "
                         "single-process oracle for its snapshot step; "
                         "exit 1 on any mismatch")
    ap.add_argument("--follow", type=float, default=0.0,
                    help="after the scripted load, keep serving this many "
                         "seconds and report hot-swaps as they happen")
    ap.add_argument("--poll-s", type=float, default=0.25,
                    help="snapshot watcher poll cadence")
    ap.add_argument("--hot-frac", type=float, default=0.1,
                    help="serving hot-head fraction for replicated "
                         "(non-split) checkpoints")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def serve_rank(mesh, args) -> int:
    """One rank of the server (``mesh`` is ``None`` for one process):
    rank 0 serves and prints, the others follow its commands."""
    from repro_torch.serve.server import serve_follower
    from repro_torch.serve.snapshot import SnapshotWatcher

    if mesh is not None and mesh.rank != 0:
        serve_follower(SnapshotWatcher(args.ckpt_dir, mesh=mesh,
                                       poll_s=args.poll_s), mesh)
        return 0

    def on_swap(old, new):
        print(f"swap: step {old.step if old else None} -> {new.step}",
              flush=True)

    device = None if mesh is not None else args.device
    watcher = SnapshotWatcher(args.ckpt_dir, mesh=mesh, poll_s=args.poll_s,
                              on_swap=on_swap, device=device)
    watcher.start()
    try:
        idx = watcher.wait_ready(timeout=60.0)
    except (TimeoutError, FileNotFoundError) as e:
        print(f"error: {e}", file=sys.stderr)
        watcher.stop()
        if watcher.commands is not None:
            watcher.commands.close()
        return 2
    return _serve(args, watcher, idx)


def _serve(args, watcher, idx) -> int:
    import numpy as np

    from repro_torch.serve import EmbeddingIndex, EmbeddingServer
    from repro_torch.serve.query import dense_topk

    print(f"serving: step={idx.step} vocab={idx.vocab_size} dim={idx.dim} "
          f"shards={idx.n_shards} hot={idx.placement.hot} "
          f"device={idx.device}", flush=True)
    rng = np.random.default_rng(args.seed)
    server = EmbeddingServer(watcher, batch_size=args.batch_size,
                             deadline_ms=args.deadline_ms, k=args.k)
    try:
        kinds = {"nn": ("nn",), "analogy": ("analogy",),
                 "both": ("nn", "analogy")}[args.mode]
        pending = []
        t0 = time.perf_counter()
        for i in range(args.queries):
            kind = kinds[i % len(kinds)]
            n = 1 + int(rng.integers(min(4, args.batch_size)))
            shape = (n,) if kind == "nn" else (n, 3)
            ids = rng.integers(idx.vocab_size, size=shape).astype(np.int32)
            pending.append((kind, ids, server.submit(kind, ids)))
        results = [(kind, ids, req.wait(60.0)) for kind, ids, req in pending]
        wall = time.perf_counter() - t0

        mismatches = 0
        if args.check_oracle:
            # the oracle is rank 0's own one-rank load of the same step
            oracles = {}
            for kind, ids, res in results:
                step = res.snapshot_step
                if step not in oracles:
                    oracles[step] = EmbeddingIndex.load(
                        args.ckpt_dir, step=step, hot_frac=args.hot_frac,
                        device=idx.device).dense_embeddings()
                want_ids, want_sc = dense_topk(oracles[step], ids, k=args.k,
                                               mode=kind)
                if not (np.array_equal(res.ids, want_ids)
                        and np.allclose(res.scores, want_sc, atol=1e-5)):
                    mismatches += 1
            print(f"oracle_parity={'ok' if mismatches == 0 else 'FAIL'} "
                  f"checked={len(results)} mismatches={mismatches}")

        lat = np.asarray(server.latencies_us, np.float64)
        rows = sum(r.ids.shape[0] for _, _, r in results)
        print(f"serve_stats: queries={rows} batches={server.batches} "
              f"qps={rows / max(wall, 1e-9):,.0f} "
              f"p50_us={np.percentile(lat, 50):,.0f} "
              f"p99_us={np.percentile(lat, 99):,.0f}")

        if args.follow > 0:
            swaps0 = watcher.swaps
            print(f"following {args.ckpt_dir} for {args.follow:.0f}s "
                  f"(poll every {args.poll_s}s)...", flush=True)
            deadline = time.monotonic() + args.follow
            while time.monotonic() < deadline:
                time.sleep(min(0.2, args.poll_s))
            print(f"follow_done: swaps={watcher.swaps - swaps0} "
                  f"now_serving_step={watcher.current().step}")
    finally:
        watcher.stop()        # no swap command after the followers leave
        server.close()
    sys.stdout.flush()
    return 1 if mismatches else 0


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    from repro_torch.core.trainer import resolve_device
    args.device = str(resolve_device(args.device))   # raises without a GPU
    if args.shards <= 1:
        return serve_rank(None, args)
    from repro_torch.launch.mesh import start_ranks
    return start_ranks(serve_rank, args.shards, args.device, args)


if __name__ == "__main__":
    sys.exit(main())
