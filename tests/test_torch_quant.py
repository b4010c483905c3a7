"""The port's storage codecs (``repro_torch.kernels.quant``) against the
reference's (``repro.kernels.quant``) and ``jax.random``: the threefry
stream (``bits``, ``uniform``, ``fold_in``) bit for bit, every encode and
decode byte for byte for the same f32 input and key, and the codecs'
properties (fixed points, unbiased stochastic rounding)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.quant as ref
from repro_torch.kernels import quant

SHAPES = [(1,), (35,), (7, 5), (65, 128), (3, 11)]     # 33: not even


def _key(seed=0, epoch=1, index=2):
    return quant.round_key(seed, epoch, index)


def _bytes(a) -> np.ndarray:
    """The storage bytes of a jax or torch array (bf16 as uint16)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy().view(np.uint8)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return a.view(np.uint8)


def test_round_key_matches_reference_and_is_counter_pure():
    for counters in [(0, 1, 2), (3, 1, 41), (7, 0, 0)]:
        k = quant.round_key(*counters)
        np.testing.assert_array_equal(k, ref.round_key(*counters))
        assert k.dtype == np.uint32 and k.shape == (2,)
    k = quant.round_key(3, 1, 41)
    for other in [(4, 1, 41), (3, 2, 41), (3, 1, 42)]:
        assert not np.array_equal(k, quant.round_key(*other))
    assert quant.TAG_FULL_OUT == ref.TAG_FULL_OUT and \
        quant._ROUND_TAG == ref._ROUND_TAG
    assert quant.STORAGE_DTYPES == ref.STORAGE_DTYPES


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_threefry_bits_and_uniform_match_jax(shape):
    for counters in [(0, 1, 2), (5, 3, 9)]:
        k = _key(*counters)
        want = np.asarray(jax.random.bits(jnp.asarray(k), shape, jnp.uint32))
        got = quant.bits(k, shape)
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        want_u = np.asarray(jax.random.uniform(jnp.asarray(k), shape,
                                               jnp.float32))
        got_u = quant.uniform(k, shape)
        assert got_u.dtype == torch.float32
        np.testing.assert_array_equal(got_u.numpy().view(np.uint32),
                                      want_u.view(np.uint32))
        assert (got_u.numpy() >= 0).all() and (got_u.numpy() < 1).all()


def test_bits_chunks_agree_with_one_pass(monkeypatch):
    k = _key()
    whole = quant.bits(k, (65, 128))
    monkeypatch.setattr(quant, "_CHUNK", 1000)      # 9 chunks, a ragged end
    assert torch.equal(quant.bits(k, (65, 128)), whole)


@pytest.mark.parametrize("data", [0, 1, 5, 0x5254, 2 ** 31 + 7, 2 ** 32 - 1])
def test_fold_in_matches_jax(data):
    for k in (_key(), _key(9, 9, 9)):
        want = np.asarray(jax.random.fold_in(jnp.asarray(k), data))
        got = quant.fold_in(k, data)
        assert got == tuple(int(w) for w in want)
        # nested folds, as requant_cold keys the cold tail
        want2 = np.asarray(jax.random.fold_in(jax.random.fold_in(
            jnp.asarray(k), data), 0))
        assert quant.fold_in(got, 0) == tuple(int(w) for w in want2)


def _table(seed=0) -> np.ndarray:
    """Rows that hit each corner: all zero, an absmax that encodes to
    exactly ±127, negative values, values exact in bf16 (low 16 bits
    zero), and rows of very different scales."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(12, 40)) * rng.uniform(1e-3, 10, size=(12, 1))
         ).astype(np.float32)
    x[0] = 0.0                                       # all-zero row
    x[1, 3] = np.abs(x[1]).max() * 2                 # +127 absmax
    x[2, 7] = -np.abs(x[2]).max() * 2                # -127 absmax
    x[3] = -np.abs(x[3])                             # all negative
    x[4] = (x[4].view(np.uint32) & 0xFFFF0000).view(np.float32)  # bf16-exact
    x[5, :4] = [0.5, -1.25, 3.0, -0.09375]
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("mode", ["nearest", "stochastic"])
def test_encode_and_decode_match_reference_bytes(dtype, mode):
    x = _table()
    for tag in (quant.TAG_FULL_IN, quant.TAG_COLD_OUT):
        k = _key(2, 0, tag)
        if mode == "nearest":
            want_p, want_s = ref.encode_nearest(jnp.asarray(x), dtype)
            got_p, got_s = quant.encode_nearest(torch.from_numpy(x), dtype)
        else:
            want_p, want_s = ref.encode_stochastic(jnp.asarray(x), dtype,
                                                   jnp.asarray(k), tag)
            got_p, got_s = quant.encode_stochastic(torch.from_numpy(x), dtype,
                                                   k, tag)
        assert got_p.dtype == quant.TORCH_DTYPES[dtype]
        np.testing.assert_array_equal(_bytes(got_p), _bytes(want_p))
        assert (got_s is None) == (want_s is None)
        if want_s is not None:
            np.testing.assert_array_equal(_bytes(got_s), _bytes(want_s))
            assert got_s[0] == 1.0                   # the all-zero row
        want_d = np.asarray(ref.decode(want_p, want_s, dtype), np.float32)
        got_d = quant.decode(got_p, got_s, dtype)
        assert got_d.dtype == torch.float32
        np.testing.assert_array_equal(_bytes(got_d), _bytes(want_d))
        if dtype == "int8":
            assert got_p[1, 3] == 127 and got_p[2, 7] == -127
            assert not got_p[0].any()
        if dtype == "bfloat16":                     # exact values stay
            np.testing.assert_array_equal(got_d[4].numpy(), x[4])
            np.testing.assert_array_equal(got_d[5, :4].numpy(), x[5, :4])


def test_int8_helpers_match_reference():
    x = _table(1)
    k = _key(4, 4, 4)
    np.testing.assert_array_equal(
        quant.int8_scale(torch.from_numpy(x)).numpy(),
        np.asarray(ref.int8_scale(jnp.asarray(x))))
    s = np.abs(x).max(-1) / 100 + 1e-3              # a given scale
    for got, want in ((quant.int8_nearest(torch.from_numpy(x),
                                          torch.from_numpy(s)),
                       ref.int8_nearest(jnp.asarray(x), jnp.asarray(s))),
                      (quant.int8_stochastic(torch.from_numpy(x), k,
                                             torch.from_numpy(s)),
                       ref.int8_stochastic(jnp.asarray(x), jnp.asarray(k),
                                           jnp.asarray(s)))):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # round half to even, as jnp.round
    half = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, _ = quant.int8_nearest(half, torch.ones(1))
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]


def test_int8_untouched_row_is_a_fixed_point():
    """decode → nearest re-encode of an untouched row is the identity
    (scale and payload; the absmax element encodes to exactly ±127). The
    stochastic re-encode keeps the scale exactly and the payload within one
    step (``q·s/s`` can land a hair below ``q``), with the reference's
    bytes."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(256, 64)) * rng.uniform(
        1e-3, 10, size=(256, 1))).astype(np.float32))
    q, s = quant.int8_nearest(x)
    assert (q.abs().amax(-1) == 127).all()
    dec = quant.int8_decode(q, s)
    q2, s2 = quant.int8_nearest(dec)
    assert torch.equal(q2, q) and torch.equal(s2, s)
    k = _key(1, 2, 3)
    q3, s3 = quant.int8_stochastic(dec, k)
    assert torch.equal(s3, s) and (q3.int() - q.int()).abs().max() <= 1
    want_q, _ = ref.int8_stochastic(jnp.asarray(dec.numpy()), jnp.asarray(k))
    np.testing.assert_array_equal(q3.numpy(), np.asarray(want_q))


def test_int8_stochastic_unbiased_over_keyed_draws():
    """The reference's unbiasedness test by intent, on the same row and
    keys (each draw's bytes equal the reference's): the mean of 400 keyed
    draws converges to the f32 value. One stochastic-rounding draw of an
    element with fractional part p is Bernoulli, variance p(1-p)·scale²
    (up to scale²/4, three times the uniform scale²/12), so the bound is
    4 sigma of that."""
    x = np.asarray([[0.111, -0.037, 0.5, 0.93]], np.float32)
    base = quant.round_key(0, 0, 0)
    draws = 400
    acc = np.zeros_like(x, dtype=np.float64)
    for i in range(draws):
        k = quant.fold_in(base, i)
        q, s = quant.int8_stochastic(torch.from_numpy(x), k)
        want_q, _ = ref.int8_stochastic(jnp.asarray(x),
                                        jnp.asarray(k, jnp.uint32))
        np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
        acc += quant.int8_decode(q, s).numpy()
    scale = np.float32(np.abs(x).max() / 127.0)
    y = x / scale
    p = y - np.floor(y)
    sigma = scale * np.sqrt(p * (1 - p) / draws)
    assert (np.abs(acc / draws - x) < 4 * sigma + 1e-7).all()


def test_bf16_stochastic_keeps_representable_values():
    x = torch.tensor([0.5, -1.25, 3.0, 0.0, -0.09375])
    for i in range(8):
        k = quant.fold_in(quant.round_key(1, 2, 3), i)
        assert torch.equal(quant.bf16_stochastic(x, k).float(), x)


def test_bf16_stochastic_wraps_like_the_reference():
    """The f32 pattern plus the noise wraps mod 2**32 (NaN/Inf patterns
    near 0xFFFFFFFF), as the reference's uint32 sum does."""
    x = np.array([np.inf, -np.inf, np.nan, -np.nan, 3.4e38, -3.4e38],
                 np.float32)
    x = np.concatenate([x, np.array([0xFFFFFFFF, 0xFFFF8000, 0x7FFFFFFF],
                                    np.uint32).view(np.float32)])
    k = _key(3, 3, 3)
    want = ref.bf16_stochastic(jnp.asarray(x), jnp.asarray(k))
    got = quant.bf16_stochastic(torch.from_numpy(x), k)
    np.testing.assert_array_equal(_bytes(got), _bytes(want))
