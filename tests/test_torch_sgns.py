"""The port's window math (``repro_torch.core.sgns``) against the
reference's (``repro.core.sgns``) on the same random blocks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.sgns as ref
from repro_torch.core import sgns


@pytest.mark.parametrize("K,m,d", [(6, 6, 128), (2, 2, 128), (4, 4, 32)])
def test_window_delta_matches_reference(K, m, d):
    rng = np.random.default_rng(K * 100 + d)
    ctx = (rng.normal(size=(K, d)) * 0.3).astype(np.float32)
    out = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    mask = rng.random(K) < 0.7
    a_ctx, a_out = ref.window_delta(jnp.asarray(ctx), jnp.asarray(out),
                                    jnp.asarray(mask), jnp.float32(0.05))
    b_ctx, b_out = sgns.window_delta(torch.from_numpy(ctx),
                                     torch.from_numpy(out),
                                     torch.from_numpy(mask), 0.05)
    np.testing.assert_allclose(b_ctx.numpy(), np.asarray(a_ctx), atol=1e-6)
    np.testing.assert_allclose(b_out.numpy(), np.asarray(a_out), atol=1e-6)
    assert not b_ctx.numpy()[~mask].any()        # masked rows: no gradient


def test_stable_sigmoid_matches_reference():
    x = np.linspace(-90, 90, 2001, dtype=np.float32)
    a = np.asarray(ref.stable_sigmoid(jnp.asarray(x)))
    b = sgns.stable_sigmoid(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-7, rtol=1e-6)
    assert np.isfinite(b).all()


def test_pair_delta_matches_reference(rng):
    u = rng.normal(size=64).astype(np.float32)
    v = rng.normal(size=64).astype(np.float32)
    for label in (0.0, 1.0):
        a = ref.pair_delta(jnp.asarray(u), jnp.asarray(v),
                           jnp.float32(label), jnp.float32(0.1))
        b = sgns.pair_delta(torch.from_numpy(u), torch.from_numpy(v), label,
                            0.1)
        for x, y in zip(b, a):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
