"""The port's baselines (``repro_torch.core.baselines``: the pWord2Vec-like
``matrix_sgns`` and the accSGNS-like ``naive_sgns``) against the
reference's ``repro.core.baselines`` from the same seeded tables and
batches (atol 2e-5 / rtol 1e-4), and the reference's own claims about
them: ``matrix_sgns`` equals the FULL-W2V ring-buffer pass on sentences
without repeated tokens, the two baselines agree to O(lr²), and both
train finite tables. Both are plain torch in the port, as they are plain
jnp in the reference: on the CPU here, on the card in ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.baselines as ref_baselines
from repro_torch.core.baselines import (matrix_sgns, matrix_sgns_sentence,
                                        naive_sgns, naive_sgns_sentence)
from repro_torch.kernels.ref import batch_sgns_ref
from tests.conftest import make_distinct_negs

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(seed, V=40, S=3, L=10, N=3, d=128, distinct_tokens=False,
          lengths=None):
    rng = np.random.default_rng(seed)
    if distinct_tokens:
        tokens = np.stack([rng.permutation(V)[:L]
                           for _ in range(S)]).astype(np.int32)
    else:
        tokens = rng.integers(0, V, size=(S, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    lengths = np.asarray(lengths if lengths is not None else [L] * S,
                         np.int32)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    return w_in, w_out, tokens, negs, lengths


def _t(*a):
    return [torch.from_numpy(np.array(x)) for x in a]


def _j(*a):
    return [jnp.asarray(x) for x in a]


IMPLS = {"matrix": (matrix_sgns, ref_baselines.matrix_sgns),
         "naive": (naive_sgns, ref_baselines.naive_sgns)}


@pytest.mark.parametrize("w_f", [1, 2, 3])
@pytest.mark.parametrize("impl", list(IMPLS))
def test_baselines_match_reference(impl, w_f):
    """Repeated tokens, a one-word and a short sentence included."""
    port, jax_fn = IMPLS[impl]
    batch = _data(w_f, lengths=[10, 1, 6])
    want = jax_fn(*_j(*batch), jnp.float32(0.05), w_f)
    got = port(*_t(*batch), 0.05, w_f)
    for g, w, init in zip(got, want, batch[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        assert np.abs(g.numpy() - init).max() > 1e-4


@pytest.mark.parametrize("impl", ["matrix", "naive"])
def test_sentence_forms_match_reference(impl):
    port = {"matrix": matrix_sgns_sentence, "naive": naive_sgns_sentence}
    ref = {"matrix": ref_baselines.matrix_sgns_sentence,
           "naive": ref_baselines.naive_sgns_sentence}
    w_in, w_out, tokens, negs, _ = _data(7, S=1)
    want = ref[impl](*_j(w_in, w_out, tokens[0], negs[0]), jnp.int32(8),
                     jnp.float32(0.05), 2)
    got = port[impl](*_t(w_in, w_out, tokens[0], negs[0]), 8, 0.05, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("w_f", [2, 3])
def test_matrix_equals_ring_buffer_on_distinct_tokens(w_f):
    """With no short-range token repeats the ring buffer is semantically
    invisible: FULL-W2V == pWord2Vec-style per-window table updates (the
    core correctness claim of lifetime reuse, §3.2)."""
    batch = _data(11, distinct_tokens=True, lengths=[10, 7, 2])
    a = batch_sgns_ref(*_t(*batch), 0.05, w_f)
    b = matrix_sgns(*_t(*batch), 0.05, w_f)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=2e-5)


def test_naive_and_matrix_agree_at_small_lr():
    """Per-pair immediate updates vs per-window batched updates differ
    only at O(lr²): at small lr they take the same step."""
    batch = _data(3, distinct_tokens=True)
    a = matrix_sgns(*_t(*batch), 1e-4, 2)
    b = naive_sgns(*_t(*batch), 1e-4, 2)
    d_in = (a[0] - b[0]).abs().max().item()
    step = np.abs(a[0].numpy() - batch[0]).max()
    assert step > 0
    assert d_in < 0.05 * step + 1e-7


@pytest.mark.parametrize("impl", list(IMPLS))
def test_baselines_update_in_place_and_stay_finite(impl):
    port, _ = IMPLS[impl]
    w_in, w_out, *idx = _t(*_data(5))
    out = port(w_in, w_out, *idx, 0.05, 2)
    assert out[0] is w_in and out[1] is w_out
    assert torch.isfinite(w_in).all() and torch.isfinite(w_out).all()
