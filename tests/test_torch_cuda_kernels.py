"""CUDA kernels against their plain versions on the card (needs an NVIDIA
GPU and nvcc; skipped elsewhere). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerance: atol 2e-5, rtol 1e-4 (the JAX package's kernel tolerance); the
prefetching kernel and the tiled kernel at T=1 must equal the sequential
kernel bit for bit, and the split-table kernel (K4) the tiled kernel on
``concat(hot, got)``."""
import numpy as np
import pytest
import torch

from repro_torch.data.batching import plan_tiles
from repro_torch.kernels import fullw2v, ref

pytestmark = pytest.mark.requires_cuda
TOL = dict(atol=2e-5, rtol=1e-4)


def make_distinct_negs(rng, tokens, vocab, n_neg):
    """Negatives distinct from each other and the window's target (the
    kernels' precondition). A copy of tests/conftest.py's helper: this file
    also runs on GPU machines whose path holds another ``tests`` package."""
    S, L = tokens.shape
    negs = np.zeros((S, L, n_neg), dtype=np.int32)
    for s in range(S):
        for t in range(L):
            c = rng.choice(vocab - 1, size=n_neg, replace=False)
            negs[s, t] = c + (c >= tokens[s, t])
    return negs


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _batch(dev, seed, V=2048, d=128, S=6, L=48, N=5):
    rng = np.random.default_rng(seed)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, V, size=(S, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    lengths = rng.integers(0, L + 1, size=S).astype(np.int32)
    lengths[0] = L
    put = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731
    tables = lambda: (put(w_in.copy()), put(w_out.copy()))  # noqa: E731
    return tables, [put(tokens), put(negs), put(lengths)], \
        (tokens, negs, lengths), put


def _assert_close(got, want):
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_sequential_kernels_match_plain(dev, seed):
    tables, idx, _, _ = _batch(dev, seed)
    want = ref.batch_sgns_ref(*tables(), *idx, 0.05, 3)
    k1 = fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, 3)
    k2 = fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, 3, pipeline=True)
    torch.cuda.synchronize()
    _assert_close(k1, want)
    assert all(torch.equal(a, b) for a, b in zip(k2, k1))


@pytest.mark.parametrize("tile", [1, 4, 8])
def test_tiled_kernel_matches_plain(dev, tile):
    tables, idx, host, put = _batch(dev, 10 + tile)
    plan = plan_tiles(*host, tile)
    p = [put(a) for a in (plan.uniq, plan.scatter, plan.ucount, plan.strict)]
    want = ref.batch_sgns_tiled_ref(*tables(), *idx, 0.05, 3, tile, *p,
                                    gemm_windows=4)
    got = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, 0.05, 3, tile, *p,
                                     gemm_windows=4)
    torch.cuda.synchronize()
    _assert_close(got, want)
    if tile == 1:
        k1 = fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, 3)
        assert all(torch.equal(a, b) for a, b in zip(got, k1))


def test_strict_tiles_equal_sequential_kernel(dev):
    V, d, L, N, tile = 120, 128, 16, 3, 4
    rng = np.random.default_rng(3)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = np.arange(L, dtype=np.int32)[None, :].copy()
    tokens[0, 5] = tokens[0, 0]
    negs = np.zeros((1, L, N), np.int32)
    for t in range(L):
        t0 = tile * (t // tile)
        negs[0, t, 0] = tokens[0, t + 1] if t == t0 else tokens[0, t0]
        negs[0, t, 1:] = 100 + (np.arange(N - 1) + t) % 20
    lengths = np.array([L], np.int32)
    plan = plan_tiles(tokens, negs, lengths, tile)
    assert plan.strict.all()
    put = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731
    idx = [put(tokens), put(negs), put(lengths)]
    p = [put(a) for a in (plan.uniq, plan.scatter, plan.ucount, plan.strict)]
    k3 = fullw2v.fullw2v_cuda_tiled(put(w_in), put(w_out), *idx, 0.05, 2,
                                    tile, *p)
    k1 = fullw2v.fullw2v_cuda(put(w_in), put(w_out), *idx, 0.05, 2)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k3, k1))


def _split(tables, hot):
    w_in, w_out = tables()
    return (w_in[:hot].clone(), w_out[:hot].clone(), w_in[hot:].clone(),
            w_out[hot:].clone())


@pytest.mark.parametrize("hot", [1, 512, 2047])
def test_fused_kernel_matches_plain_and_tiled_on_concat(dev, hot):
    """K4 on the table split at ``hot`` (one hot row, a quarter, all but one
    row) against its plain version, and bit for bit against K3 on the
    concatenation."""
    tables, idx, host, put = _batch(dev, 20 + hot)
    plan = plan_tiles(*host, 8)
    p = [put(a) for a in (plan.uniq, plan.scatter, plan.ucount, plan.strict)]
    want = ref.batch_sgns_tiled_fused_ref(*_split(tables, hot), *idx, 0.05,
                                          3, 8, *p, gemm_windows=4)
    got = fullw2v.fullw2v_cuda_tiled_fused(*_split(tables, hot), *idx, 0.05,
                                           3, 8, *p, gemm_windows=4)
    k3 = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, 0.05, 3, 8, *p,
                                    gemm_windows=4)
    torch.cuda.synchronize()
    _assert_close(got, want)
    assert torch.equal(torch.cat([got[0], got[2]]), k3[0])
    assert torch.equal(torch.cat([got[1], got[3]]), k3[1])


def test_fused_kernel_all_hot_and_out_of_range_ids(dev):
    """R = 0 (an all-hot batch) runs; an id past hot + R raises on the
    host before any launch."""
    tables, idx, host, put = _batch(dev, 30)
    plan = plan_tiles(*host, 4)
    p = [put(a) for a in (plan.uniq, plan.scatter, plan.ucount, plan.strict)]
    w_in, w_out = tables()
    empty = w_in[:0].clone()
    got = fullw2v.fullw2v_cuda_tiled_fused(w_in, w_out, empty, empty.clone(),
                                           *idx, 0.05, 3, 4, *p)
    k3 = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, 0.05, 3, 4, *p)
    torch.cuda.synchronize()
    assert torch.equal(got[0], k3[0]) and torch.equal(got[1], k3[1])
    fullw2v.reset_launch_counts()
    short = _split(tables, 100)
    with pytest.raises(ValueError, match="working-table ids"):
        fullw2v.fullw2v_cuda_tiled_fused(*short[:2], short[2][:10].clone(),
                                         short[3][:10].clone(), *idx, 0.05,
                                         3, 4, *p)
    assert fullw2v.LAUNCHES["cuda_tiled_fused"] == 0


def test_launch_counts(dev):
    tables, idx, _, _ = _batch(dev, 4)
    fullw2v.reset_launch_counts()
    fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, 3)
    fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, 3, pipeline=True)
    fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, 3, pipeline=True)
    assert fullw2v.LAUNCHES == {"cuda": 1, "cuda_pipelined": 2,
                                "cuda_tiled": 0, "cuda_tiled_fused": 0}


def test_bad_inputs_raise_on_the_card(dev):
    tables, (tokens, negs, lengths), _, _ = _batch(dev, 5)
    w_in, w_out = tables()
    for args in ((w_in, w_out, tokens.long(), negs, lengths),
                 (w_in, w_out, tokens, negs.long(), lengths),
                 (w_in.t().contiguous().t(), w_out, tokens, negs, lengths),
                 (w_in, w_out, tokens[:, ::2], negs[:, ::2], lengths),
                 (w_in, w_out, tokens.cpu(), negs, lengths)):
        with pytest.raises(ValueError):
            fullw2v.fullw2v_cuda(*args, 0.05, 3)
