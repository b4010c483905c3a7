"""FULL-W2V in PyTorch with hand-written CUDA kernels for Hopper.

A port of the JAX package ``repro`` that stays beside it as the reference.
This package imports ``torch``, numpy and the standard library only — never
``jax`` and never ``repro`` — and mirrors the reference's module names:

configs/w2v.py   — ``W2VConfig`` (copied verbatim)
configs/         — the LM substrate's ``ArchConfig`` system and its 10 arch
                   presets (``base.py``, copies of the reference's)
models/          — the LM substrate: layers, Mamba2 SSD, MoE, the decoder
                   (forward, ``lm_loss``, ``prefill``, ``decode_step``,
                   ``cache_shardings``)
distributed/     — vocabulary placement and exchange plans, collectives,
                   the logical-axis ``sharding`` rules (DTensor
                   placements on a DeviceMesh), ``elastic`` mesh plans
                   (``build`` makes a device mesh) and ``compression``
                   (int8 error feedback)
data/            — host batching (numpy copies: bit-identical batches/plans)
                   and the async prefetch pipeline (``data/prefetch.py``)
core/sgns.py     — the window math in torch
core/trainer.py  — ``TrainSession`` over ``kernels.ops.step``
core/quality.py  — planted-cluster quality metrics (numpy copy)
kernels/         — plain torch versions, CUDA kernels, registry, ``step``
train/           — checkpoints, recovery primitives, the supervisor, chaos;
                   the LM's AdamW (``optim``) and ``Trainer`` (``loop``)
convert.py       — start from the reference's tables (and LM parameters
                   and AdamW state)
tree.py          — map over nested dicts, tuples and lists of tensors
launch/steps.py  — LM train, prefill and serve steps, ``build_cell``
launch/train.py  — ``python -m repro_torch.launch.train w2v|lm``

Entry points run on the GPU unless the caller asks for the CPU.
"""
