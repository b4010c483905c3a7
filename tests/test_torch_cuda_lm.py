"""The LM models on the card (needs an NVIDIA GPU; skipped elsewhere).
Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda_lm.py

With remat on, a block's recompute runs where the backward runs: on CUDA
the autograd engine's device thread, which does not inherit the caller's
context variables. Every MoE call of smoke moonshot-v1-16b-a3b's loss, the
forward's and the recompute's on that thread, must see the active
sharding rules and the MoE's token shards."""
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.distributed.sharding import axis_rules, current_rules
from repro_torch.models import lm, moe
from repro_torch.tree import tree_leaves

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the autograd engine's device "
                    "thread)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_remat_recompute_on_the_device_thread_keeps_the_context(
        dev, monkeypatch):
    cfg = get_smoke("moonshot-v1-16b-a3b")
    assert cfg.remat
    params = lm.init_params(cfg, seed=0, device=dev)
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9))
                            .astype(np.int64)).to(dev)
    seen = []
    real = moe._local_groups

    def spy(t):
        seen.append((current_rules() is not None, moe._TOKEN_SHARDS.get(),
                     threading.get_ident()))
        return real(t)

    monkeypatch.setattr(moe, "_local_groups", spy)
    with torch.enable_grad():
        with axis_rules({"data": 2, "model": 1}), moe.token_shards(2):
            loss = lm.lm_loss(cfg, params, toks[:, :-1], toks[:, 1:])
        loss.backward()
    torch.cuda.synchronize()
    n = cfg.n_layers
    assert len(seen) == 2 * n
    assert all((r, k) == (True, 2) for r, k, _ in seen), seen
    # the recompute ran on the device thread, not the caller's
    assert {t for *_, t in seen[n:]} != {threading.get_ident()}
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in leaves)
