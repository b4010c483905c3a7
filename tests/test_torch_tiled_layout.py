"""The host side of the window-tiled kernels K3/K4 (``csrc/tiled.cuh``): the
plain mirror of their shared-memory layout and of the choice of compiled or
runtime-shaped instantiation (``csrc/fullw2v.cu``'s ``tiled_smem`` and
``tiled_choice``; the card test ``test_tiled_mirror_matches_the_library``
holds the two against each other), the host count of the columns the
cross-tile prefetch takes and rejects, and the wrappers' checks that run
before any launch."""
import numpy as np
import pytest
import torch

from repro_torch.configs.w2v import W2VConfig
from repro_torch.data.batching import plan_tiles
from repro_torch.kernels import fullw2v

H100_SMEM = 227 * 1024      # 232,448 bytes: what one block may opt into


@pytest.mark.parametrize("shape", fullw2v.TILED_COMPILED)
def test_compiled_tiled_shapes_take_their_instantiation(shape):
    w_f, n_neg, tile, G = shape
    name = fullw2v.tiled_instantiation(w_f, n_neg, 128, 64, tile, G)
    assert name == f"wf{w_f}_n{n_neg}_t{tile}_g{G}_d128"
    assert name in fullw2v.TILED_INSTANTIATIONS
    assert fullw2v.tiled_choice(w_f, n_neg, 128, 64, tile, G) == (name, True)
    # the same shape with an unaligned table takes the runtime body
    assert fullw2v.tiled_instantiation(w_f, n_neg, 128, 64, tile, G,
                                       aligned=False) == "runtime"


def test_main_tiled_shape_compiles_and_fits():
    """The trainer's T=8 shape (W=5 -> w_f=3, N=5, d=128, G = min(T, 4) =
    4) at chip_smoke's L=64 and at the default config's L=1000 takes the
    compiled body with the double-buffered out_uniq and the staged plan, and
    fits the opt-in limit."""
    cfg = W2VConfig(tile_windows=8)
    assert (cfg.fixed_window, cfg.negatives, cfg.dim) == (3, 5, 128)
    for L in (64, cfg.resolved_pad_len):
        assert fullw2v.tiled_choice(3, 5, 128, L, 8, 0) == \
            ("wf3_n5_t8_g4_d128", True)
        got = fullw2v.tiled_smem_bytes(3, 5, 128, L, 8, 4)
        assert got["indices"] > 0 and got["out_uniq"] == 2 * 48 * 512
        assert got["total"] <= H100_SMEM


@pytest.mark.parametrize("w_f,n_neg,d,tile,G", [
    (3, 5, 128, 8, 2), (3, 5, 128, 4, 4), (3, 5, 128, 16, 4),
    (3, 5, 128, 5, 2), (3, 5, 96, 8, 4), (3, 5, 256, 8, 4),
    (4, 7, 128, 1, 1), (2, 3, 128, 4, 4), (3, 4, 128, 8, 4)])
def test_other_tiled_shapes_take_the_runtime_body(w_f, n_neg, d, tile, G):
    assert fullw2v.tiled_choice(w_f, n_neg, d, 64, tile, G) == \
        ("runtime", True)


def test_tiled_plan_read_in_place_when_staging_does_not_fit():
    staged = fullw2v.tiled_smem_bytes(3, 5, 128, 6000, 8, 4)
    assert staged["total"] > H100_SMEM
    assert fullw2v.tiled_choice(3, 5, 128, 6000, 8, 4) == \
        ("runtime_unstaged", True)
    in_place = fullw2v.tiled_smem_bytes(3, 5, 128, 6000, 8, 4, staged=False)
    assert in_place["indices"] == 0 and in_place["total"] <= H100_SMEM


def test_tiled_prefetch_off_when_the_double_buffer_does_not_fit():
    """T=16, N=30, d=300: two halves of out_uniq (496 rows) do not fit, one
    does not either with the plan staged; the plan is read in place and
    the prefetch is off."""
    assert fullw2v.tiled_smem_bytes(3, 30, 300, 64, 16, 4,
                                    staged=False)["total"] > H100_SMEM
    assert fullw2v.tiled_choice(3, 30, 300, 64, 16, 4) == \
        ("runtime_unstaged", False)
    assert fullw2v.tiled_choice(3, 5, 128, 64, 8, 4, prefetch=False) == \
        ("wf3_n5_t8_g4_d128", False)


def test_tiled_layout_bytes_at_the_main_shape():
    """w_f=3, N=5, T=8, G=4, d=128, L=64: ring 2G+2w_f = 14 rows, out_uniq
    2 x 48 rows, 2 x 6 strict rows, 10 context columns, g 144 floats, 8
    flag words, 48 prefetch flags, a list of 48 + 4 + 6 rows issued ahead
    (2 ints each), two stages of pad4(pad4(64 + 320 + 1) + 2*8*48 + 2*8) =
    1172 ints."""
    got = fullw2v.tiled_smem_bytes(3, 5, 128, 64, 8, 4)
    assert got == {"ring": 14 * 512, "out_uniq": 96 * 512,
                   "out_rows": 12 * 512, "columns": 10 * 512, "g": 144 * 4,
                   "flags": 32, "prefetch_flags": 48 * 4,
                   "copy_list": 116 * 4, "indices": 2 * 1172 * 4,
                   "total": 132 * 512 + 144 * 4 + 32 + 48 * 4 + 116 * 4
                   + 2 * 1172 * 4}
    # G comes from resolve_gemm_windows (0 -> min(T, 4), clamped to T)
    assert fullw2v.tiled_smem_bytes(3, 5, 128, 64, 8, 0) == got
    assert fullw2v.tiled_smem_bytes(3, 5, 128, 64, 2, 4)["ring"] == \
        (2 * 2 + 6) * 512


def test_tiled_launch_counters_cover_every_instantiation():
    assert set(fullw2v.TILED_LAUNCHES) == set(fullw2v.TILED_INSTANTIATIONS)
    assert len(fullw2v.TILED_INSTANTIATIONS) == \
        len(fullw2v.TILED_COMPILED) + 2
    fullw2v.TILED_LAUNCHES["runtime"] = 3
    fullw2v.LAUNCHES["cuda_tiled"] = 2
    fullw2v.reset_launch_counts()
    assert set(fullw2v.TILED_LAUNCHES.values()) == {0}
    assert set(fullw2v.LAUNCHES.values()) == {0}


def _was_prefetched_counts(plan, lengths, tile):
    """The reference's was_prefetched (fullw2v.py:617-636), tile by tile."""
    taken = rejected = 0
    S, nt, _ = plan.uniq.shape
    for s in range(S):
        for ti in range(1, nt):
            ok = (ti * tile < lengths[s] and plan.strict[s, ti] == 0
                  and plan.strict[s, ti - 1] == 0)
            if not ok:
                continue
            prev = plan.uniq[s, ti - 1, :plan.ucount[s, ti - 1]]
            for c in range(plan.ucount[s, ti]):
                if plan.uniq[s, ti, c] in prev:
                    rejected += 1
                else:
                    taken += 1
    return taken, rejected


@pytest.mark.parametrize("tile", [1, 4, 8])
def test_prefetch_columns_match_was_prefetched(tile):
    """Negatives shared by a sentence's tiles (every tile after the first
    rejects them), a target reused as the next tile's negative (strict
    tiles), short and empty sentences."""
    rng = np.random.default_rng(tile)
    S, L, N, V = 12, 40, 5, 200
    tokens = rng.integers(0, 60, size=(S, L)).astype(np.int32)
    negs = np.zeros((S, L, N), np.int32)
    for s in range(S):
        shared = rng.choice(np.arange(100, V), size=N, replace=False)
        for t in range(L):
            negs[s, t] = shared if s % 2 == 0 else \
                rng.choice(np.arange(100, V), size=N, replace=False)
        if s % 3 == 0:
            negs[s, 1:, 0] = tokens[s, :-1]
    lengths = rng.integers(0, L + 1, size=S).astype(np.int32)
    lengths[:3] = [L, 0, 1]
    plan = plan_tiles(tokens, negs, lengths, tile)
    want = _was_prefetched_counts(plan, lengths, tile)
    assert want[0] > 0 and (tile == 1 or want[1] > 0)
    assert fullw2v.prefetch_columns(plan.uniq, plan.ucount, plan.strict,
                                    lengths, tile) == want


def test_tiled_counters_are_checked_before_any_launch():
    V, d, S, L, N, tile = 32, 8, 1, 8, 2, 4
    w = torch.zeros(V, d)
    tokens = torch.zeros(S, L, dtype=torch.int32)
    negs = torch.ones(S, L, N, dtype=torch.int32)
    lengths = torch.full((S,), L, dtype=torch.int32)
    plan = plan_tiles(tokens.numpy(), negs.numpy(), lengths.numpy(), tile)
    p = [torch.from_numpy(a) for a in (plan.uniq, plan.scatter, plan.ucount,
                                       plan.strict)]
    fullw2v.reset_launch_counts()
    for bad in (torch.zeros(2, dtype=torch.int32), torch.zeros(3,
                                                               dtype=torch.int64)):
        with pytest.raises(ValueError, match="counters"):
            fullw2v.fullw2v_cuda_tiled(w, w.clone(), tokens, negs, lengths,
                                       0.05, 1, tile, *p, counters=bad)
    with pytest.raises(ValueError, match="CUDA device"):
        fullw2v.fullw2v_cuda_tiled(w, w.clone(), tokens, negs, lengths, 0.05,
                                   1, tile, *p,
                                   counters=torch.zeros(2,
                                                        dtype=torch.int64))
    assert fullw2v.LAUNCHES["cuda_tiled"] == 0
    assert set(fullw2v.TILED_LAUNCHES.values()) == {0}
