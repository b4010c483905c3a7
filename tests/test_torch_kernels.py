"""The port's plain kernel versions (``repro_torch.kernels.ref``, what the
CUDA kernels are held against on the card) against the reference: the jnp
oracles at d=128, and on one small case the reference Pallas kernels
themselves in interpret mode. Also the wrappers' refusal of CPU tensors
and their input checks. Tolerance: atol 2e-5, rtol 1e-4 (the reference's own kernel
tolerance)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.batching import plan_tiles
from repro.kernels import ref as jref
from repro.kernels.fullw2v import fullw2v_pallas, fullw2v_pallas_tiled
from repro_torch.kernels import fullw2v, ref
from tests.conftest import make_distinct_negs

TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores and these small-tensor
    tests slow tenfold or more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make(seed, V, d, S, L, N, lengths):
    rng = np.random.default_rng(seed)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = rng.integers(0, V, size=(S, L)).astype(np.int32)
    negs = make_distinct_negs(rng, tokens, V, N)
    return w_in, w_out, tokens, negs, np.asarray(lengths, np.int32)


def _strict_batch(V=120, d=128, L=16, N=3, tile=4):
    """Every tile has a target reused as another window's negative, and a
    token repeats at the sequential store distance (test_kernel_tiled's
    construction, two sentences)."""
    rng = np.random.default_rng(7)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    tokens = np.stack([np.arange(L), np.arange(L) + L]).astype(np.int32)
    tokens[:, 5] = tokens[:, 0]
    negs = np.zeros((2, L, N), np.int32)
    for s in range(2):
        for t in range(L):
            t0 = tile * (t // tile)
            negs[s, t, 0] = tokens[s, t + 1] if t == t0 else tokens[s, t0]
            negs[s, t, 1:] = 100 + (np.arange(N - 1) + t) % 20
    return w_in, w_out, tokens, negs, np.array([L, L - 3], np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_seq(w_in, w_out, tokens, negs, lengths, lr, w_f):
    return ref.batch_sgns_ref(*_torch(w_in, w_out, tokens, negs, lengths),
                              lr, w_f)


def _port_tiled(w_in, w_out, tokens, negs, lengths, lr, w_f, tile, G):
    plan = plan_tiles(tokens, negs, lengths, tile)
    return ref.batch_sgns_tiled_ref(
        *_torch(w_in, w_out, tokens, negs, lengths), lr, w_f, tile,
        *_torch(plan.uniq, plan.scatter, plan.ucount, plan.strict),
        gemm_windows=G)


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(port, want):
    for p, w in zip(port, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("w_f", [1, 3])
def test_plain_sequential_matches_oracle(w_f):
    batch = _make(0, 50, 128, 4, 14, 5, [14, 9, 1, 3])
    want = jref.batch_sgns_ref(*_jax(*batch), jnp.float32(0.05), w_f)
    _close(_port_seq(*batch, 0.05, w_f), want)


@pytest.mark.parametrize("tile,G", [(1, 0), (8, 4), (4, 2)])
def test_plain_tiled_matches_oracle(tile, G):
    batch = _make(1, 50, 128, 4, 19, 5, [19, 12, 1, 6])
    plan = plan_tiles(*batch[2:], tile)
    want = jref.batch_sgns_tiled_ref(
        *_jax(*batch), jnp.float32(0.05), 3, tile,
        *_jax(plan.uniq, plan.scatter, plan.ucount, plan.strict),
        gemm_windows=G)
    _close(_port_tiled(*batch, 0.05, 3, tile, G), want)


def test_plain_tiled_strict_matches_oracle_and_sequential():
    batch = _strict_batch()
    plan = plan_tiles(*batch[2:], 4)
    assert plan.strict[0].all()
    want = jref.batch_sgns_tiled_ref(
        *_jax(*batch), jnp.float32(0.05), 2, 4,
        *_jax(plan.uniq, plan.scatter, plan.ucount, plan.strict))
    got = _port_tiled(*batch, 0.05, 2, 4, 0)
    _close(got, want)
    seq = _port_seq(*batch, 0.05, 2)
    for a, b in zip(got, seq):                   # strict == exact replay
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["sequential", "pipelined", "tiled"])
def test_plain_matches_reference_pallas_interpret(form):
    """One small case (S=2, L=16, V=64) against the reference Pallas kernels
    run as their own tests run them."""
    batch = _make(2, 64, 128, 2, 16, 5, [16, 9])
    w_f, lr = 3, 0.05
    if form == "tiled":
        plan = plan_tiles(*batch[2:], 8)
        want = fullw2v_pallas_tiled(
            *_jax(*batch), jnp.float32(lr), w_f, 8,
            *_jax(plan.uniq, plan.scatter, plan.ucount, plan.strict),
            gemm_windows=4, interpret=True)
        got = _port_tiled(*batch, lr, w_f, 8, 4)
    else:
        want = fullw2v_pallas(*_jax(*batch), jnp.float32(lr), w_f,
                              interpret=True,
                              pipeline=form == "pipelined")
        got = _port_seq(*batch, lr, w_f)
    _close(got, want)


@pytest.mark.parametrize("kernel", ["cuda", "cuda_pipelined", "cuda_tiled",
                                    "cuda_tiled_fused"])
def test_wrappers_raise_on_cpu_tensors(kernel):
    """The kernels have no CPU mode and the wrappers never route CPU
    tensors to the plain versions (the registry runs those on the CPU):
    valid CPU inputs raise, and no launch is counted."""
    batch = _make(3, 40, 128, 3, 12, 3, [12, 5, 2])
    w_in, w_out, *idx = _torch(*batch)
    plan = _torch(*(getattr(plan_tiles(*batch[2:], 4), f)
                    for f in ("uniq", "scatter", "ucount", "strict")))
    fullw2v.reset_launch_counts()
    with pytest.raises(ValueError, match="one CUDA device"):
        if kernel == "cuda_tiled":
            fullw2v.fullw2v_cuda_tiled(w_in, w_out, *idx, 0.05, 2, 4, *plan)
        elif kernel == "cuda_tiled_fused":
            fullw2v.fullw2v_cuda_tiled_fused(
                w_in[:10].clone(), w_out[:10].clone(), w_in[10:].clone(),
                w_out[10:].clone(), *idx, 0.05, 2, 4, *plan)
        else:
            fullw2v.fullw2v_cuda(w_in, w_out, *idx, 0.05, 2,
                                 pipeline=kernel == "cuda_pipelined")
    assert set(fullw2v.LAUNCHES.values()) == {0}       # no kernel ran


def test_wrappers_reject_bad_inputs():
    w_in, w_out, tokens, negs, lengths = _torch(
        *_make(4, 40, 128, 2, 8, 3, [8, 4]))
    good = (w_in, w_out, tokens, negs, lengths)
    bad = [
        (w_in.double(), w_out, tokens, negs, lengths),
        (w_in, w_out, tokens.long(), negs, lengths),
        (w_in, w_out, tokens, negs.long(), lengths),
        (w_in.t().contiguous().t(), w_out, tokens, negs, lengths),
        (w_in, w_out, tokens.t().contiguous().t(), negs, lengths),
        (w_in, w_out[:-1], tokens, negs, lengths),
        (w_in, w_out, tokens, negs[:, :-1], lengths),
    ]
    with pytest.raises(ValueError, match="one CUDA device"):
        fullw2v.fullw2v_cuda(*good, 0.05, 2)     # valid, but on the CPU
    for args in bad:                             # checked before the device
        with pytest.raises(ValueError, match="must|differ"):
            fullw2v.fullw2v_cuda(*args, 0.05, 2)
    plan = plan_tiles(*(a.numpy() for a in (tokens, negs, lengths)), 4)
    p = _torch(plan.uniq, plan.scatter, plan.ucount, plan.strict)
    with pytest.raises(ValueError, match="uniq"):
        fullw2v.fullw2v_cuda_tiled(*good, 0.05, 2, 2, *p)     # wrong tile
    with pytest.raises(ValueError, match="int32"):
        fullw2v.fullw2v_cuda_tiled(*good, 0.05, 2, 4, p[0].long(), *p[1:])
    split = (w_in[:10].clone(), w_out[:10].clone(), w_in[10:].clone(),
             w_out[10:].clone())
    for tabs, match in (((split[0], split[1][:-1], *split[2:]), "hot_out"),
                        ((*split[:2], split[2], split[3][:-1]), "got_out"),
                        ((*split[:2], split[2][:, :-1].contiguous(),
                          split[3][:, :-1].contiguous()), "d="),
                        ((split[0][:0], split[1][:0], *split[2:]), "hot head"),
                        ((split[0].double(), *split[1:]), "hot_in")):
        with pytest.raises(ValueError, match=match):
            fullw2v.fullw2v_cuda_tiled_fused(*tabs, tokens, negs, lengths,
                                             0.05, 2, 4, *p)


def test_tiled_scratch_rows():
    """The tiled kernel's shared-memory rows at T=8, w_f=3, N=5, G=4 (each
    row d floats; g counts floats): a ring of 2G + 2w_f rows, out_uniq in
    two halves of T(N+1) rows, a strict window's rows twice, the runtime
    body's G + 2w_f context columns."""
    b = fullw2v.tiled_smem_bytes(3, 5, 128, 64, 8, 4)
    rows = {k: b[k] // (4 * 128) for k in ("ring", "out_uniq", "out_rows",
                                           "columns")}
    assert rows == {"ring": 14, "out_uniq": 96, "out_rows": 12,
                    "columns": 10}
    assert b["g"] // 4 == 144


@pytest.mark.parametrize("kw", [dict(static_ids=torch.zeros(2)),
                                dict(bags=torch.zeros(2))])
def test_frontend_extensions_raise(kw):
    """The frontend extensions run since the frontends slice (their parity
    is in test_torch_frontends.py); malformed ones — float doc rows, bags
    without the (S, L, B) shape — raise before any table changes, in both
    plain versions."""
    batch = _torch(*_make(5, 20, 128, 2, 4, 2, [4, 4]))
    before = [t.clone() for t in batch[:2]]
    with pytest.raises(ValueError, match="must be an int32 or int64"):
        ref.batch_sgns_ref(*batch, 0.05, 1, **kw)
    plan = plan_tiles(*(t.numpy() for t in batch[2:]), 2)
    with pytest.raises(ValueError, match="must be an int32 or int64"):
        ref.batch_sgns_tiled_ref(*batch, 0.05, 1, 2, *_torch(
            plan.uniq, plan.scatter, plan.ucount, plan.strict), **kw)
    assert all(torch.equal(a, b) for a, b in zip(batch[:2], before))
