#!/usr/bin/env python3
"""How often the LM ``Trainer``'s loss falls on the synthetic token stream,
over draws of the initial parameters, on the CPU.

    PYTHONPATH=src python tools/lm_loss_draws.py [--seeds 8] [--reference]
        [--lr 3e-4] [--steps 12] [--warmup 1]

The defaults are the ``lm`` CLI's run (smoke starcoder2-3b, batch 2, seq
16; ``--lr 1e-3 --steps 15 --warmup 2`` are ``tests/test_train_loop.py``'s
settings). For each draw k < ``--seeds`` the port's ``Trainer`` starts
from ``repro_torch.models.lm.init_params(seed=k)`` on the CPU; one line a
draw gives the first and last loss and the first and last three-step
means, and whether each fell; the last line counts the falls. With
``--reference`` the reference's ``Trainer`` runs the same from
``jax.random.PRNGKey(k)`` (the only part that imports jax). The tokens
are random, so the loss has no systematic fall in a few steps: whether
it falls is a property of the draw.
"""
from __future__ import annotations

import argparse
import sys


def _report(tag: str, k: int, losses: list, falls: list) -> None:
    first = losses[0] > losses[-1]
    means = sum(losses[:3]) / 3 > sum(losses[-3:]) / 3
    falls.append((first, means))
    print(f"{tag} draw={k} loss={losses[0]:.4f}->{losses[-1]:.4f} "
          f"fell={first} mean3={sum(losses[:3]) / 3:.4f}->"
          f"{sum(losses[-3:]) / 3:.4f} mean3_fell={means}", flush=True)


def port_draws(args) -> list:
    from repro_torch.configs import get_smoke
    from repro_torch.models import lm
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optim import AdamWConfig, adamw_init

    cfg = get_smoke("starcoder2-3b")
    falls: list = []
    for k in range(args.seeds):
        tr = Trainer(cfg, AdamWConfig(lr=args.lr, total_steps=args.steps,
                                      warmup_steps=args.warmup),
                     LoopConfig(steps=args.steps, log_every=10 ** 9),
                     batch=2, seq=16, device="cpu")
        tr.params = lm.init_params(cfg, seed=k, device="cpu")
        tr.opt_state = adamw_init(tr.params)
        _report("port", k, tr.train()["losses"], falls)
    return falls


def reference_draws(args) -> list:
    import jax

    from repro.configs import get_smoke
    from repro.models import lm
    from repro.train.loop import LoopConfig, Trainer
    from repro.train.optim import AdamWConfig, adamw_init

    cfg = get_smoke("starcoder2-3b")
    falls: list = []
    step_fn = None
    for k in range(args.seeds):
        tr = Trainer(cfg, AdamWConfig(lr=args.lr, total_steps=args.steps,
                                      warmup_steps=args.warmup),
                     LoopConfig(steps=args.steps, log_every=10 ** 9),
                     batch=2, seq=16)
        step_fn = step_fn or tr.step_fn      # one compile for every draw
        tr.step_fn = step_fn
        tr.params = lm.init_params(cfg, jax.random.PRNGKey(k))
        tr.opt_state = adamw_init(tr.params)
        _report("reference", k, tr.train()["losses"], falls)
    return falls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--reference", action="store_true",
                    help="also the reference's Trainer (imports jax)")
    args = ap.parse_args(argv)
    runs = [("port", port_draws(args))]
    if args.reference:
        runs.append(("reference", reference_draws(args)))
    for tag, falls in runs:
        print(f"{tag}: last below first in {sum(f for f, _ in falls)} of "
              f"{len(falls)} draws, last-three mean below first-three in "
              f"{sum(m for _, m in falls)} of {len(falls)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
