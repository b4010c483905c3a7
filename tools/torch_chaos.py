#!/usr/bin/env python
"""Deterministic chaos harness CLI of the torch port (DESIGN.md §9).

The port's ``tools/chaos.py``: runs a scripted fault schedule against a
supervised W2V run and verifies that recovery is **bit-exact**: the
faulted run's final table digest must equal the fault-free baseline's.
Exit status is the contract (0 = recovered bit-exact and every scheduled
fault actually fired; 1 = anything less), so CI can gate on it directly.

    PYTHONPATH=src python tools/torch_chaos.py --schedule ci
    PYTHONPATH=src python tools/torch_chaos.py --device cpu --ranks 2
    PYTHONPATH=src python tools/torch_chaos.py --device cpu --ranks 2 \\
        --tables shards=2

Schedules live in ``repro_torch.train.chaos.SCHEDULES``. It runs on the
GPU unless ``--device cpu`` is given. ``--ranks N`` runs both runs on N
ranks (``run_chaos_ranks``: NCCL with a card a rank, else gloo), with the
rank-local faults on rank 1; then the reports must also agree on every
rank. ``--tables`` takes a storage spec for both runs (``shards=N``
shards the vocabulary over the N ranks).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys


def main(argv=None) -> int:
    from repro_torch.kernels.tables import parse
    from repro_torch.train.chaos import (SCHEDULES, run_chaos,
                                         run_chaos_ranks, workload)

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--schedule", default="ci", choices=sorted(SCHEDULES),
                    help="fault script to run (default: ci)")
    ap.add_argument("--backend", default="auto",
                    help="kernel backend for both runs (default: auto)")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the GPU; fails "
                         "without one)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of both runs, one process each")
    ap.add_argument("--tables", default="",
                    help="table storage spec of both runs (e.g. hot=bf16, "
                         "shards=2)")
    ap.add_argument("--json", action="store_true",
                    help="print the full result dict as JSON")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="suppress per-fault warning logs (of this "
                         "process: spawned ranks log their own)")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.ERROR if args.quiet else logging.WARNING,
        format="%(name)s %(message)s")

    sched = SCHEDULES[args.schedule]
    cfg, corpus = workload(sched)
    cfg = dataclasses.replace(cfg, tables=args.tables)
    ranks = max(args.ranks, parse(args.tables).shards)
    if ranks > 1:
        result = run_chaos_ranks(sched, ranks, args.device,
                                 backend=args.backend, cfg=cfg,
                                 corpus=corpus)
    else:
        result = run_chaos(sched, backend=args.backend, device=args.device,
                           cfg=cfg, corpus=corpus)
    if args.json:
        print(json.dumps(result, indent=1, sort_keys=True))
    else:
        print(f"schedule={args.schedule} batches={result['batches_seen']} "
              f"restarts={result['restarts']} "
              f"rollbacks={result['rollbacks']} heals={result['heals']} "
              f"quarantined={result['ckpt_quarantined']} "
              f"recovery_seconds={result['recovery_seconds']}")
        print(f"baseline_digest={result['baseline_digest']}")
        print(f"final_digest={result['final_digest']}")
        if ranks > 1:
            print(f"ranks={ranks} reports_equal={result['reports_equal']} "
                  f"backend={result['backend']} device={result['device']}")

    failures = []
    if not result["digest_match"]:
        failures.append("final_digest differs from fault-free baseline")
    if result["faults_fired"] < result["faults_scheduled"]:
        failures.append(
            f"only {result['faults_fired']}/{result['faults_scheduled']} "
            f"scheduled faults fired")
    if sched.kill_worker_at and result["workers_killed"] < 1:
        failures.append("no prefetch worker was actually killed")
    # heals is reported but not gated: a kill can be absorbed either by
    # the pool's own heal path or by a supervisor rollback rebuilding the
    # pipeline first — which one wins is a benign race. The heal path
    # itself is pinned deterministically in tests/test_torch_prefetch.py.
    if sched.truncate_ckpt_at and result["ckpts_truncated"] < 1:
        failures.append("no checkpoint was actually truncated")
    if sched.truncate_ckpt_at and result["ckpt_quarantined"] < 1:
        failures.append("truncated checkpoint was never quarantined")
    if not result["reports_equal"]:
        failures.append("the ranks' supervisor reports differ")
    if failures:
        print("chaos: FAILED", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("chaos: recovery is bit-exact — all scheduled faults survived")
    return 0


if __name__ == "__main__":
    sys.exit(main())
