"""Train a reduced assigned-architecture LM (any of the 10 configs) on
synthetic tokens with checkpointing + failure recovery on the PyTorch
port: the LM half of the framework end to end. The port's counterpart of
``examples/lm_train_smoke.py``.

    PYTHONPATH=src python examples/torch_lm_train_smoke.py \\
        --arch jamba-1.5-large-398b [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and raises without
one. The LM substrate has no hand-written kernel: its products are plain
torch on the chosen device. Deliberate differences from the reference:

* ``--device``;
* one more line, ``backend=torch device=<name>``;
* the initial parameters come from a ``torch.Generator`` (the reference
  draws with ``jax.random``): :func:`run` takes ``init_params`` (a port
  parameter tree, e.g. ``repro_torch.convert.lm_params_from_reference``
  of the reference's) to start from given parameters and fresh AdamW
  moments instead, as the tests do, and returns the Trainer's result.
"""
import argparse
import tempfile

import torch

from repro_torch.configs import get_smoke, list_archs
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import AdamWConfig, adamw_init
from repro_torch.train.resilience import FailureInjector


def run(arch: str = "qwen3-8b", steps: int = 20,
        inject_failure: bool = False, device=None,
        init_params=None) -> dict:
    """Train and print the reference's line; returns ``Trainer.train()``'s
    dict (``final_step``, ``losses``, ``stragglers``)."""
    cfg = get_smoke(arch)
    ckpt_dir = tempfile.mkdtemp(prefix="lm_smoke_")
    loop = LoopConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5,
                      log_every=5)
    opt = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2)
    injector = (FailureInjector([steps // 2]) if inject_failure else None)
    trainer = Trainer(cfg, opt, loop, batch=4, seq=64,
                      failure_injector=injector, device=device)
    if init_params is not None:
        trainer.params = init_params
        trainer.opt_state = adamw_init(init_params)
    name = (torch.cuda.get_device_name(trainer.device)
            if trainer.device.type == "cuda" else "cpu")
    print(f"backend=torch device={name}")
    out = trainer.train()
    losses = out["losses"]
    print(f"{arch}: step {out['final_step']}, "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(ckpts in {ckpt_dir})")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--inject-failure", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda, cuda:N or cpu (default: the GPU; raises "
                         "without one)")
    args = ap.parse_args(argv)
    run(args.arch, args.steps, args.inject_failure, args.device)


if __name__ == "__main__":
    main()
