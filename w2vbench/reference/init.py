"""The tables a training session starts from, worked out from the seed:
word2vec's initialisation, ``w_in ~ U(-0.5/d, 0.5/d)`` drawn in float32
from a CPU ``torch.Generator`` seeded with the run's seed, and ``w_out =
0``. This is the rule the configuration states for the port's tables;
the reference draws them itself and never reads the program's."""
from __future__ import annotations

import numpy as np
import torch


def tables(vocab_size: int, dim: int, seed: int):
    """``(w_in, w_out)`` as float32 NumPy arrays."""
    gen = torch.Generator().manual_seed(int(seed))
    w_in = (torch.rand((vocab_size, dim), generator=gen,
                       dtype=torch.float32) - 0.5) / dim
    return w_in.numpy(), np.zeros((vocab_size, dim), np.float32)


def lr_at(cfg: dict, words_seen: int, epoch_words: int) -> float:
    """The linear decay of word2vec's learning rate over ``epochs``
    passes of ``epoch_words`` words, floored at ``min_lr_frac``, as the
    float32 the kernel receives."""
    total = max(1, epoch_words * int(cfg["epochs"]))
    frac = 1.0 - words_seen / total
    return float(np.float32(cfg["lr"] * max(frac, cfg["min_lr_frac"])))
