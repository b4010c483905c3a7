"""The port's int8 error-feedback compression and elastic mesh plans
(``repro_torch.distributed.compression`` / ``elastic``) against the
reference's: the reference's five substrate tests
(``tests/test_train_substrate.py``, compression and elastic) mirrored on
the port, the int8 bytes and scales bit for bit on the same inputs with
the error-feedback residuals within 1 ulp, the mesh plans equal for every
n in 1..4096, and ``build(plan)`` as a device mesh on a fake process
group."""
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings

from repro.distributed import compression as ref_comp
from repro.distributed import elastic as ref_elastic
from repro_torch.distributed import compression as comp
from repro_torch.distributed.elastic import (MeshPlan, build,
                                             degrade_sequence, plan_mesh)
from repro_torch.tree import tree_leaves, tree_map


# ------------------------------------------------- the reference's five tests
@given(st.integers(0, 2 ** 31 - 1))
@settings(max_examples=20, deadline=None)
def test_quantize_bounded_error(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 3, 128).astype(np.float32))
    q, s = comp.quantize(x)
    err = (comp.dequantize(q, s) - x).abs().max().item()
    assert q.dtype == torch.int8
    assert err <= float(s) * 0.5 + 1e-7


def test_error_feedback_is_unbiased_over_rounds():
    """Σ transmitted ≈ Σ inputs — EF carries quantization error forward."""
    rng = np.random.default_rng(0)
    tree = {"g": torch.zeros(64)}
    ef = comp.ef_init(tree)
    total_in = np.zeros(64)
    total_tx = np.zeros(64)
    for _ in range(50):
        g = {"g": torch.from_numpy(rng.normal(0, 1, 64).astype(np.float32))}
        total_in += g["g"].numpy()
        q, s, ef = comp.compress_tree(g, ef)
        total_tx += comp.decompress_tree(q, s)["g"].numpy()
    resid = np.abs(total_in - total_tx).max()
    # residual is bounded by one quantization step, not O(rounds)
    assert resid < 0.2


def test_compression_ratio():
    tree = {"g": torch.zeros(1024)}
    raw, c = comp.compressed_mean_bytes(tree)
    assert raw == 4096 and c < raw / 3


@given(st.integers(1, 4096), st.sampled_from([4, 8, 16]))
@settings(max_examples=60, deadline=None)
def test_plan_mesh_properties(n, tp):
    plan = plan_mesh(n, tp)
    assert plan.size <= n
    assert plan.size >= 1
    assert plan.shape[-1] <= tp
    # mesh uses as many devices as divisibility allows with the chosen TP
    assert plan.size >= n // 2 or n < 4


def test_degrade_sequence():
    seq = degrade_sequence(512, 16, [16, 64, 200])
    sizes = [p.size for p in seq]
    assert sizes == sorted(sizes, reverse=True)
    # 496 and 432 devices both keep the requested TP=16
    assert all(p.shape[-1] == 16 for p in seq[:2])
    # an awkward survivor count (odd) degrades TP rather than dying
    odd = degrade_sequence(512, 16, [1])[0]
    assert odd.size >= 1 and odd.shape[-1] <= 16


# --------------------------------------------------- against the reference
def _inputs(seed):
    """Seeded f32 inputs: normals of several scales, exact ties at
    half-steps (127·k/2 of the amax scale, so half-to-even decides), a
    zero tensor (scale 1) and a single element."""
    rng = np.random.default_rng(seed)
    ties = (np.arange(-254, 255, dtype=np.float32) / 2.0)
    return [rng.normal(0, 3, 1000).astype(np.float32),
            (rng.normal(0, 1, (17, 33)) * 1e-6).astype(np.float32),
            rng.standard_cauchy(4096).astype(np.float32),
            ties,
            np.zeros(64, np.float32),
            np.array([-2.5], np.float32)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_bytes_and_scales_equal_the_reference(seed):
    for x in _inputs(seed):
        q, s = comp.quantize(torch.from_numpy(x))
        rq, rs = ref_comp.quantize(jnp.asarray(x))
        assert q.numpy().tobytes() == np.asarray(rq).tobytes()
        assert np.float32(s.item()).tobytes() == \
            np.asarray(rs, np.float32).tobytes()
        np.testing.assert_array_equal(
            comp.dequantize(q, s).numpy(),
            np.asarray(ref_comp.dequantize(rq, rs)))


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2 ** 31) - ia, ia)
    ib = np.where(ib < 0, np.int64(-2 ** 31) - ib, ib)
    return np.abs(ia - ib)


def test_compress_tree_rounds_equal_the_reference():
    """Five rounds of ``compress_tree`` on a nested tree (dict, tuple,
    list) of the same numpy inputs: the int8 bytes and scales of every
    round are the reference's bit for bit, the error-feedback residuals
    within 1 ulp."""
    rng = np.random.default_rng(7)

    def draw():
        return {"a": rng.normal(0, 2, (8, 16)).astype(np.float32),
                "b": (rng.normal(0, 1, 300).astype(np.float32),
                      [rng.normal(0, 1e-3, (3, 5)).astype(np.float32)])}

    first = draw()
    ef = comp.ef_init(tree_map(torch.from_numpy, first))
    ref_ef = ref_comp.ef_init(jax.tree.map(jnp.asarray, first))
    for r in range(5):
        x = first if r == 0 else draw()
        q, s, ef = comp.compress_tree(tree_map(torch.from_numpy, x), ef)
        rq, rs, ref_ef = ref_comp.compress_tree(jax.tree.map(jnp.asarray, x),
                                                ref_ef)
        assert isinstance(q["b"], tuple) and isinstance(q["b"][1], list)
        ours = tree_leaves(q)
        theirs = jax.tree.leaves(rq)
        assert [t.numpy().tobytes() for t in ours] == \
            [np.asarray(t).tobytes() for t in theirs], r
        assert [np.float32(t.item()) for t in tree_leaves(s)] == \
            [np.float32(t) for t in jax.tree.leaves(rs)], r
        for got, want in zip(tree_leaves(ef.residual),
                             jax.tree.leaves(ref_ef.residual)):
            assert _ulps(got.numpy(), want).max() <= 1, r
        deq = tree_leaves(comp.decompress_tree(q, s))
        ref_deq = jax.tree.leaves(ref_comp.decompress_tree(rq, rs))
        for got, want in zip(deq, ref_deq):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tree = tree_map(torch.from_numpy, first)
    assert comp.compressed_mean_bytes(tree) == \
        ref_comp.compressed_mean_bytes(jax.tree.map(jnp.asarray, first))


@pytest.mark.parametrize("tp", [4, 8, 16])
def test_mesh_plans_equal_the_reference(tp):
    for n in range(1, 4097):
        for pods in (None, 2, 4):
            a, b = plan_mesh(n, tp, pods), ref_elastic.plan_mesh(n, tp, pods)
            assert (a.shape, a.axes, a.size) == (b.shape, b.axes, b.size), n
    for failures in ([16, 64, 200], [1], [1, 1, 1, 7], [4000, 95]):
        ours = degrade_sequence(4096, tp, failures)
        theirs = ref_elastic.degrade_sequence(4096, tp, failures)
        assert [(p.shape, p.axes) for p in ours] == \
            [(p.shape, p.axes) for p in theirs]


@pytest.mark.parametrize("plan", [MeshPlan((2, 4), ("data", "model")),
                                  plan_mesh(48, 16),
                                  plan_mesh(64, 8, pods=2)],
                         ids=lambda p: "x".join(map(str, p.shape)))
def test_build_makes_the_plans_device_mesh(plan):
    """On a one-process fake process group of ``plan.size`` ranks the mesh
    has the plan's shape and axis names; a group of another size is
    refused."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialized"):
        build(plan, "cpu")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=plan.size)
    try:
        mesh = build(plan, "cpu")
        assert tuple(mesh.shape) == plan.shape
        assert mesh.mesh_dim_names == plan.axes
        assert mesh.size() == plan.size
        with pytest.raises(ValueError, match="needs"):
            build(MeshPlan((plan.size * 2,), ("data",)), "cpu")
    finally:
        dist.destroy_process_group()
