"""CUDA kernels against their plain versions on the card (needs an NVIDIA
GPU and nvcc; skipped elsewhere). Run on a GPU machine with

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda_kernels.py

Tolerance: atol 2e-5, rtol 1e-4 (the JAX package's kernel tolerance); the
prefetching kernel and the tiled kernel at T=1 must equal the sequential
kernel bit for bit, and the split-table kernel (K4) the tiled kernel on
``concat(hot, got)``. The sequential kernels are also run on batches built
to hit every hazard of K2's prefetch, at each compiled shape, at a shape
outside the list, on unaligned tables and with indices too large to
stage; the tiled ones at every group size, with the cross-tile prefetch
on and off (bit for bit), on strict tiles and hazard rows, on unaligned
tables and at another width."""
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


def _hazard_batch(seed, V, S, L, N, w_f, lengths):
    """Tokens repeated at distance exactly 2*w_f+1 (the ring row K2
    prefetches while the same token's earlier position is still being
    updated), window t+1's target equal to a negative of window t and a
    negative of window t+1 equal to window t's target, with the given
    sentence lengths (0, 1, <= w_f and L among them)."""
    rng = np.random.default_rng(seed)
    r = 2 * w_f + 1
    tokens = rng.integers(0, V, size=(S, L)).astype(np.int32)
    for t in range(r, L, 3):
        tokens[:, t] = tokens[:, t - r]
    negs = make_distinct_negs(rng, tokens, V, N)
    for s in range(S):
        for t in range(0, L - 1, 4):
            if t + 1 >= r and (t + 1 - r) % 3 == 0:
                continue                  # keep that repeat
            tokens[s, t + 1] = negs[s, t, rng.integers(N)]
            negs[s, t + 1] = make_distinct_negs(
                rng, tokens[s:s + 1, t + 1:t + 2], V, N)[0, 0]
        for t in range(2, L - 1, 4):
            if tokens[s, t] != tokens[s, t + 1] and \
                    tokens[s, t] not in negs[s, t + 1]:
                negs[s, t + 1, rng.integers(N)] = tokens[s, t]
    return tokens, negs, np.asarray(lengths, np.int32)


def _hazards(tokens, negs, lengths, w_f):
    """Counts of each hazard class inside the sentences."""
    r = 2 * w_f + 1
    ring = target = neg = 0
    for s, n in enumerate(lengths):
        for t in range(int(n) - 1):
            prev = {int(tokens[s, t]), *map(int, negs[s, t])}
            target += int(tokens[s, t + 1]) in prev
            neg += any(int(x) in prev for x in negs[s, t + 1])
        ring += sum(int(tokens[s, q] == tokens[s, q - r])
                    for q in range(r, int(n)))
    return ring, target, neg


def _sequential_all_ways(dev, tokens, negs, lengths, w_f, d=128, V=None,
                         unaligned=False):
    """K1, K2 and K3(T=1) on one batch: K1 within tolerance of the plain
    version, K2 and K3(T=1) equal to K1 bit for bit; returns the
    instantiations K1 and K2 took."""
    V = V or int(max(tokens.max(), negs.max())) + 1
    rng = np.random.default_rng(99)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731

    def tables():
        if not unaligned:
            return put(w_in.copy()), put(w_out.copy())
        out = []
        for a in (w_in, w_out):   # a view one float into its storage
            buf = torch.empty(a.size + 1, device=dev)
            buf[1:] = put(a.ravel())
            out.append(buf[1:].view(V, d))
        return tuple(out)

    idx = [put(tokens), put(negs), put(lengths)]
    plan = plan_tiles(tokens, negs, lengths, 1)
    p1 = [put(a) for a in (plan.uniq, plan.scatter, plan.ucount, plan.strict)]
    want = ref.batch_sgns_ref(*tables(), *idx, 0.05, w_f)
    fullw2v.reset_launch_counts()
    k1 = fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, w_f)
    took = {k for k, v in fullw2v.SEQ_LAUNCHES.items() if v}
    k2 = fullw2v.fullw2v_cuda(*tables(), *idx, 0.05, w_f, pipeline=True)
    k3 = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, 0.05, w_f, 1, *p1)
    torch.cuda.synchronize()
    _assert_close(k1, want)
    assert all(torch.equal(a, b) for a, b in zip(k2, k1)), "K2 != K1"
    assert all(torch.equal(a, b) for a, b in zip(k3, k1)), "K3(T=1) != K1"
    assert not torch.equal(k1[0], tables()[0]), "w_in did not move"
    both = {k for k, v in fullw2v.SEQ_LAUNCHES.items() if v}
    assert len(took) == 1 and both == took, fullw2v.SEQ_LAUNCHES
    assert fullw2v.SEQ_LAUNCHES[next(iter(took))] == 2
    return next(iter(took))


@pytest.mark.parametrize("w_f,N,want", [
    (3, 5, "wf3_n5_d128"), (2, 3, "wf2_n3_d128"), (2, 5, "wf2_n5_d128"),
    (5, 5, "wf5_n5_d128"), (4, 7, "runtime")])
def test_sequential_kernels_on_hazard_batches(dev, w_f, N, want):
    L = 40
    lengths = [L, 0, 1, w_f, 2, L - 3, w_f + 2]
    tokens, negs, lengths = _hazard_batch(40 + w_f, 48, len(lengths), L, N,
                                          w_f, lengths)
    assert all(c > 0 for c in _hazards(tokens, negs, lengths, w_f))
    assert _sequential_all_ways(dev, tokens, negs, lengths, w_f) == want
    assert fullw2v.seq_instantiation(w_f, N, 128, L) == want


def test_sequential_kernels_on_unaligned_tables(dev):
    tokens, negs, lengths = _hazard_batch(7, 48, 3, 32, 5, 3, [32, 5, 17])
    assert _sequential_all_ways(dev, tokens, negs, lengths, 3,
                                unaligned=True) == "runtime"


def test_sequential_kernels_at_another_width(dev):
    tokens, negs, lengths = _hazard_batch(8, 48, 3, 32, 5, 3, [32, 9, 30])
    assert _sequential_all_ways(dev, tokens, negs, lengths, 3,
                                d=200) == "runtime"


def test_sequential_kernels_with_indices_read_in_place(dev):
    """L*(N+1) too large to stage two sentences in shared memory."""
    tokens, negs, lengths = _hazard_batch(9, 96, 2, 1024, 30, 3, [1024, 300])
    assert fullw2v.seq_instantiation(3, 30, 128, 1024) == "runtime_unstaged"
    assert _sequential_all_ways(dev, tokens, negs, lengths,
                                3) == "runtime_unstaged"


def test_seq_mirror_matches_the_library(dev):
    """The plain mirror (seq_smem_bytes, seq_instantiation) against the
    library's own layout and choice."""
    from repro_torch.kernels._build import load
    lib = load().lib
    w = torch.empty(4 * 256 + 1, device=dev)
    aligned, shifted = w[:-1].data_ptr(), w[1:].data_ptr()
    for w_f, N, d, L in ((3, 5, 128, 64), (2, 3, 128, 16), (5, 5, 128, 1000),
                         (4, 7, 128, 64), (3, 5, 96, 64), (3, 30, 128, 1024),
                         (3, 5, 128, 6000)):
        for staged in (True, False):
            assert lib.fullw2v_seq_smem_bytes(d, w_f, N, L, int(staged)) == \
                fullw2v.seq_smem_bytes(w_f, N, d, L, staged)["total"]
        for ptr, ok in ((aligned, True), (shifted, False)):
            got = lib.fullw2v_seq_variant(ptr, ptr, d, w_f, N, L)
            assert fullw2v.SEQ_INSTANTIATIONS[got] == \
                fullw2v.seq_instantiation(w_f, N, d, L, aligned=ok)


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


# ---------------------------------------------------------------------------
# the tiled body (csrc/tiled.cuh): every group size, the cross-tile
# prefetch, the runtime-shaped instantiation and the host mirror
# ---------------------------------------------------------------------------

def _tiled_all_ways(dev, tokens, negs, lengths, tile, G, w_f=3, d=128,
                    unaligned=False, seed=0):
    """K3 with and without the prefetch and K4 split at V//3 on one batch;
    returns (K3, the plain version, the instantiation taken, the device
    counters, the plan). K3 with prefetch must equal K3 without it bit for
    bit, K4 K3 on the concatenation bit for bit."""
    V = int(max(tokens.max(), negs.max())) + 1
    rng = np.random.default_rng(seed)
    w_in = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    w_out = (rng.normal(size=(V, d)) * 0.1).astype(np.float32)
    put = lambda a: torch.from_numpy(a).to(dev)          # noqa: E731

    def tables():
        if not unaligned:
            return put(w_in.copy()), put(w_out.copy())
        out = []
        for a in (w_in, w_out):   # a view one float into its storage
            buf = torch.empty(a.size + 1, device=dev)
            buf[1:] = put(a.ravel())
            out.append(buf[1:].view(V, d))
        return tuple(out)

    idx = [put(tokens), put(negs), put(lengths)]
    plan = plan_tiles(tokens, negs, lengths, tile)
    p = [put(a) for a in (plan.uniq, plan.scatter, plan.ucount, plan.strict)]
    want = ref.batch_sgns_tiled_ref(*tables(), *idx, 0.05, w_f, tile, *p,
                                    gemm_windows=G)
    counters = torch.zeros(2, dtype=torch.int64, device=dev)
    fullw2v.reset_launch_counts()
    k3 = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, 0.05, w_f, tile, *p,
                                    gemm_windows=G, counters=counters)
    took = [k for k, v in fullw2v.TILED_LAUNCHES.items() if v]
    off = fullw2v.fullw2v_cuda_tiled(*tables(), *idx, 0.05, w_f, tile, *p,
                                     gemm_windows=G, prefetch=False)
    assert all(torch.equal(a, b) for a, b in zip(k3, off)), \
        "the prefetch changed a value"
    if not unaligned:
        hot = V // 3
        w_i, w_o = tables()
        split = (w_i[:hot].clone(), w_o[:hot].clone(), w_i[hot:].clone(),
                 w_o[hot:].clone())
        k4 = fullw2v.fullw2v_cuda_tiled_fused(*split, *idx, 0.05, w_f, tile,
                                              *p, gemm_windows=G)
        torch.cuda.synchronize()
        assert torch.equal(torch.cat([k4[0], k4[2]]), k3[0])
        assert torch.equal(torch.cat([k4[1], k4[3]]), k3[1])
    torch.cuda.synchronize()
    assert len(took) == 1, fullw2v.TILED_LAUNCHES
    return k3, want, took[0], tuple(counters.tolist()), plan


def _shared_neg_batch(seed, S=8, L=48, N=5, tile=8, V=400):
    """The trainer's traffic: negatives shared per tile, and in every other
    sentence the same negatives in consecutive tiles (their rows are in the
    previous tile's write-back set, so the prefetch rejects them); short,
    empty and one-window sentences."""
    rng = np.random.default_rng(seed)
    tokens = np.stack([rng.choice(V // 2, size=L, replace=False)
                       for _ in range(S)]).astype(np.int32)
    negs = np.zeros((S, L, N), np.int32)
    for s in range(S):
        keep = rng.choice(np.arange(V // 2, V), size=N, replace=False)
        for t0 in range(0, L, tile):
            pool = keep if s % 2 == 0 else rng.choice(
                np.arange(V // 2, V), size=N, replace=False)
            negs[s, t0:t0 + tile] = pool
    lengths = rng.integers(0, L + 1, size=S).astype(np.int32)
    lengths[:4] = [L, 0, 1, 3]
    return tokens, negs, lengths


@pytest.mark.parametrize("tile,G", [(1, 1), (4, 1), (4, 2), (4, 4), (8, 1),
                                    (8, 2), (8, 4), (16, 1), (16, 2),
                                    (16, 4)])
def test_tiled_kernel_at_every_group(dev, tile, G):
    """K3 against the plain version at T in {1, 4, 8, 16} and G in {1, 2,
    4}; T=8, G=4 (the trainer's) and T=1 take compiled bodies, the rest the
    runtime-shaped one."""
    tokens, negs, lengths = _shared_neg_batch(50 + tile + G, tile=tile)
    k3, want, took, counters, plan = _tiled_all_ways(dev, tokens, negs,
                                                     lengths, tile, G)
    _assert_close(k3, want)
    assert took == fullw2v.tiled_instantiation(3, 5, 128, 48, tile, G)
    assert (took != "runtime") == ((3, 5, tile, G) in fullw2v.TILED_COMPILED)
    assert counters == fullw2v.prefetch_columns(
        plan.uniq, plan.ucount, plan.strict, lengths, tile)


def test_tiled_prefetch_rejects_the_write_back_set(dev):
    """Consecutive fused tiles that share their negatives: the prefetch
    takes some columns and rejects others, and the result is the plain
    version's and, bit for bit, the result without prefetch."""
    tokens, negs, lengths = _shared_neg_batch(7)
    k3, want, took, (taken, rejected), plan = _tiled_all_ways(
        dev, tokens, negs, lengths, 8, 4)
    assert took == "wf3_n5_t8_g4_d128"
    assert taken > 0 and rejected > 0
    _assert_close(k3, want)


def test_tiled_strict_and_hazard_rows(dev):
    """Small vocabulary: repeated targets make strict tiles, tokens repeat
    at the ring's store distances, a strict window's rows equal rows the
    step before it writes. K3 == plain, the prefetch changes nothing and
    K4 == K3 on the concatenation."""
    w_f, N = 3, 5
    L = 40
    lengths = [L, 0, 1, w_f, 2, L - 3, w_f + 2]
    tokens, negs, lengths = _hazard_batch(41, 48, len(lengths), L, N, w_f,
                                          lengths)
    plan = plan_tiles(tokens, negs, lengths, 8)
    assert plan.strict.any() and not plan.strict.all()
    k3, want, took, _, _ = _tiled_all_ways(dev, tokens, negs, lengths, 8, 4)
    assert took == "wf3_n5_t8_g4_d128"
    _assert_close(k3, want)


def test_tiled_runtime_body_unaligned_and_another_width(dev):
    """Unaligned tables take the runtime body at the main shape and give
    the compiled body's bits; d=96 takes it too and matches the plain
    version."""
    tokens, negs, lengths = _shared_neg_batch(9)
    k3, _, took, _, _ = _tiled_all_ways(dev, tokens, negs, lengths, 8, 4)
    k3u, want, tooku, _, _ = _tiled_all_ways(dev, tokens, negs, lengths, 8,
                                             4, unaligned=True)
    assert (took, tooku) == ("wf3_n5_t8_g4_d128", "runtime")
    assert all(torch.equal(a, b) for a, b in zip(k3u, k3))
    k96, want96, took96, _, _ = _tiled_all_ways(dev, tokens, negs, lengths,
                                                8, 4, d=96)
    assert took96 == "runtime"
    _assert_close(k96, want96)


def test_tiled_mirror_matches_the_library(dev):
    """The plain mirror (tiled_smem_bytes, tiled_choice) against the
    library's own layout and choice."""
    from repro_torch.kernels._build import load
    lib = load().lib
    w = torch.empty(4 * 256 + 1, device=dev)
    aligned, shifted = w[:-1].data_ptr(), w[1:].data_ptr()
    for w_f, N, d, L, tile, G in ((3, 5, 128, 64, 8, 4),
                                  (3, 5, 128, 1000, 8, 4),
                                  (2, 3, 128, 16, 1, 1), (3, 5, 96, 64, 8, 4),
                                  (3, 5, 128, 6000, 8, 4),
                                  (3, 30, 300, 64, 16, 4),
                                  (4, 7, 128, 40, 3, 3)):
        for staged in (True, False):
            for pf in (True, False):
                assert lib.fullw2v_tiled_smem_bytes(
                    d, w_f, N, L, tile, G, int(pf), int(staged)) == \
                    fullw2v.tiled_smem_bytes(w_f, N, d, L, tile, G, staged,
                                             pf)["total"]
        for ptr, ok in ((aligned, True), (shifted, False)):
            for pf in (True, False):
                got = lib.fullw2v_tiled_choice(ptr, ptr, None, None, d, w_f,
                                               N, L, tile, G, int(pf))
                assert (fullw2v.TILED_INSTANTIATIONS[got >> 1],
                        bool(got & 1)) == fullw2v.tiled_choice(
                    w_f, N, d, L, tile, G, aligned=ok, prefetch=pf)
