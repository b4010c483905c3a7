"""The port's LM substrate models (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU, every smoke arch at B=2, S=24,
both packages starting from the reference's parameters
(``convert.lm_params_from_reference``) and the same numpy inputs.

Tolerances, each stated where it is used: logits and loss within atol
1e-5 / rtol 1e-4 of the reference; each gradient leaf within 1e-4 of its
largest absolute value; ``prefill`` + ``decode_step`` at an f32 cache
within 1e-4 relative of ``forward`` (the reference's own bound); remat
and ``scan_layers`` give bit-identical numbers (the same ops in the same
order); a bf16 product within one bf16 rounding step of the
reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import get_smoke as ref_get_smoke
from repro.configs import list_archs
from repro.models import layers as ref_layers
from repro.models import lm as ref_lm
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_arch, get_smoke
from repro_torch.convert import lm_params_from_reference
from repro_torch.distributed.compression import tree_leaves, tree_map
from repro_torch.models import layers, lm, moe, ssm

ARCHS = list_archs()
DECODE_ARCHS = ["qwen3-8b", "mamba2-1.3b", "jamba-1.5-large-398b",
                "arctic-480b", "moonshot-v1-16b-a3b", "internvl2-76b"]
TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_REL = 1e-4
B, S = 2, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch, seed=0, s=S):
    """Both packages' smoke config and parameters (the reference's, handed
    over) and seeded numpy tokens, labels and prefix embeddings."""
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    ref_params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(seed))
    params = lm_params_from_reference(jax.tree.map(np.asarray, ref_params),
                                      "cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)
    pref = None
    if cfg.prefix_len:
        pref = rng.normal(size=(B, cfg.prefix_len, cfg.d_model)).astype(
            np.float32)
    return ref_cfg, cfg, ref_params, params, toks, labels, pref


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _grads(cfg, params, toks, labels, pref):
    """The port's loss and the gradient of every leaf."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    loss = lm.lm_loss(cfg, params, _t(toks), _t(labels), _t(pref))
    loss.backward()
    grads = tree_map(lambda x: x.grad.detach().clone(), params)
    for x in leaves:
        x.grad = None
        x.requires_grad_(False)
    return loss.detach(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    """Logits and ``lm_loss`` within atol 1e-5 / rtol 1e-4 of the
    reference's; every gradient leaf within 1e-4 of its largest absolute
    value (``jax.value_and_grad`` against ``backward``), on the
    reference's parameter tree (same keys)."""
    ref_cfg, cfg, ref_params, params, toks, labels, pref = _setup(arch)
    ref_logits = np.asarray(ref_lm.forward(ref_cfg, ref_params, toks, pref))
    logits = lm.forward(cfg, params, _t(toks), _t(pref)).numpy()
    assert logits.shape == (B, S + cfg.prefix_len, cfg.vocab)
    np.testing.assert_allclose(logits, ref_logits, **TOL)

    # the reference's gradient unrolled and without remat, its fastest
    # eager path (its own tests hold it to the scanned one; remat
    # recomputes the same ops)
    fast = dataclasses.replace(ref_cfg, remat=False, scan_layers=False)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_lm.lm_loss(fast, p, toks, labels, pref))(ref_params)
    loss, grads = _grads(cfg, params, toks, labels, pref)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    ours = tree_leaves(grads)
    assert len(ours) == len(ref_flat)
    for (path, want), got in zip(ref_flat, ours):
        want = np.asarray(want)
        assert got.shape == want.shape, path
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got.numpy() - want).max() / scale
        assert err <= GRAD_REL, (jax.tree_util.keystr(path), err)


def _pad_kv(cache, n=1):
    """The attention caches one position longer (the decode slot)."""
    return tuple({k: (torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
                      if k in ("k", "v") else v) for k, v in blk.items()}
                 for blk in cache)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_matches_forward_and_reference(arch):
    """``decode_step(prefill(x[:S]))`` at an f32 cache equals
    ``forward(x[:S+1])`` at position S within 1e-4 relative (the
    reference's test), and the reference's decode logits within atol
    1e-5 / rtol 1e-4; the prefill cache (KV, the raw conv tail, the SSM
    state) matches the reference's."""
    ref_cfg, cfg, ref_params, params, toks, _, pref = _setup(arch, 1,
                                                             s=17)
    s = 16
    full = lm.forward(cfg, params, _t(toks), _t(pref))
    logits, cache, clen = lm.prefill(cfg, params, _t(toks[:, :s]), _t(pref),
                                     cache_dtype=torch.float32)
    assert clen == s + cfg.prefix_len
    np.testing.assert_allclose(logits.numpy(),
                               full[:, cfg.prefix_len + s - 1].numpy(),
                               **TOL)
    dec, new_cache = lm.decode_step(cfg, params, _pad_kv(cache), clen,
                                    _t(toks[:, s:s + 1]))
    want = full[:, cfg.prefix_len + s].numpy()
    err = np.abs(want - dec.numpy()).max() / (np.abs(want).max() + 1e-9)
    assert err < 1e-4, err

    _, ref_cache, ref_clen = ref_lm.prefill(ref_cfg, ref_params,
                                            toks[:, :s], pref,
                                            cache_dtype=jnp.float32)
    assert int(ref_clen) == clen
    for got, want in zip(tree_leaves(cache), jax.tree.leaves(ref_cache)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-4)
    ref_padded = tuple(
        {k: (jnp.pad(v, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
             if k in ("k", "v") else v) for k, v in blk.items()}
        for blk in ref_cache)
    ref_dec, ref_new = ref_lm.decode_step(ref_cfg, ref_params, ref_padded,
                                          ref_clen, toks[:, s:s + 1])
    np.testing.assert_allclose(dec.numpy(), np.asarray(ref_dec), **TOL)
    for got, want in zip(tree_leaves(new_cache), jax.tree.leaves(ref_new)):
        assert got.shape == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-4)


def test_bf16_cache_decode_matches_reference():
    """At the default bf16 cache the decode logits stay within a bf16
    tolerance of the reference's (the cache is rounded the same way in
    both packages; the conv state comes back promoted to f32 in both)."""
    ref_cfg, cfg, ref_params, params, toks, _, _ = _setup("jamba-1.5-large-"
                                                          "398b", 2, s=17)
    _, cache, clen = lm.prefill(cfg, params, _t(toks[:, :16]))
    _, ref_cache, ref_clen = ref_lm.prefill(ref_cfg, ref_params,
                                            toks[:, :16])
    assert {str(x.dtype) for x in tree_leaves(cache)} == \
        {"torch.bfloat16", "torch.float32"}
    dec, new = lm.decode_step(cfg, params, _pad_kv(cache), clen,
                              _t(toks[:, 16:17]))
    ref_padded = tuple(
        {k: (jnp.pad(v, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
             if k in ("k", "v") else v) for k, v in blk.items()}
        for blk in ref_cache)
    ref_dec, ref_new = ref_lm.decode_step(ref_cfg, ref_params, ref_padded,
                                          ref_clen, toks[:, 16:17])
    np.testing.assert_allclose(dec.float().numpy(), np.asarray(ref_dec),
                               atol=2e-2, rtol=2e-2)
    assert [str(x.dtype).split(".")[-1] for x in tree_leaves(new)] == \
        [str(x.dtype) for x in jax.tree.leaves(ref_new)]


@pytest.mark.parametrize("variant", ["remat_off", "remat_dots",
                                     "scan_layers_off"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-1.5-large-398b"])
def test_remat_and_scan_layers_give_the_same_numbers(arch, variant):
    """Remat on (the default) against off and against the ``dots``
    policy, and ``scan_layers`` True against False: bit-identical logits,
    loss and gradients."""
    _, cfg, _, params, toks, labels, pref = _setup(arch, 2)
    other = dataclasses.replace(cfg, **{
        "remat_off": dict(remat=False),
        "remat_dots": dict(remat_policy="dots"),
        "scan_layers_off": dict(scan_layers=False)}[variant])
    a = lm.forward(cfg, params, _t(toks), _t(pref))
    b = lm.forward(other, params, _t(toks), _t(pref))
    assert torch.equal(a, b)
    la, ga = _grads(cfg, params, toks, labels, pref)
    lb, gb = _grads(other, params, toks, labels, pref)
    assert torch.equal(la, lb)
    for x, y in zip(tree_leaves(ga), tree_leaves(gb)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [(2, 37, 4, 2, 16, 5, 3),
                                   (1, 24, 4, 4, 8, 16, 8)],
                         ids=["chunks5x3", "default_chunks"])
def test_causal_attention_matches_naive_and_reference(shape):
    """The chunked online softmax within atol 2e-5 / rtol 1e-4 of a naive
    masked softmax (the reference's test) and within atol 1e-6 / rtol
    1e-5 of the reference's ``causal_attention``."""
    b, s, nh, nkv, hd, nq, nk = shape
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, nkv, hd)).astype(np.float32)
    out = layers.causal_attention(_t(q), _t(k), _t(v), n_q_chunks=nq,
                                  n_kv_chunks=nk).numpy()
    qg = q.reshape(b, s, nkv, nh // nkv, hd)
    logits = np.einsum("bqkgh,bskh->bqkgs", qg, k) / hd ** 0.5
    causal = np.arange(s)[:, None] >= np.arange(s)[None, :]
    logits = np.where(causal[None, :, None, None, :], logits, -1e30)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    naive = np.einsum("bqkgs,bskh->bqkgh", w, v).reshape(b, s, nh, hd)
    np.testing.assert_allclose(out, naive, atol=2e-5, rtol=1e-4)
    ref = np.asarray(ref_layers.causal_attention(q, k, v, n_q_chunks=nq,
                                                 n_kv_chunks=nk))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-5)


def test_ssd_chunked_matches_sequential_and_reference():
    """Chunked SSD dual form == the token-by-token recurrence (the
    reference's bounds: atol 1e-4 / rtol 1e-3) and the reference's
    ``ssd_chunked`` within atol 1e-5 / rtol 1e-4, output and state."""
    b, l, h, p, g, s, chunk = 1, 24, 2, 4, 1, 8, 8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = rng.uniform(0.1, 0.9, size=(b, l, h)).astype(np.float32)
    a = -rng.uniform(0.1, 1.0, size=(h,)).astype(np.float32)
    bmat = rng.normal(size=(b, l, g, s)).astype(np.float32)
    cmat = rng.normal(size=(b, l, g, s)).astype(np.float32)
    y, state = ssm.ssd_chunked(_t(x), _t(dt), _t(a), _t(bmat), _t(cmat),
                               chunk)
    st = np.zeros((b, h, p, s), np.float32)
    ys = np.zeros((b, l, h, p), np.float32)
    for t in range(l):
        decay = np.exp(dt[:, t] * a)
        bt = np.repeat(bmat[:, t], h // g, 1)
        ct = np.repeat(cmat[:, t], h // g, 1)
        st = (st * decay[:, :, None, None]
              + np.einsum("bh,bhs,bhp->bhps", dt[:, t], bt, x[:, t]))
        ys[:, t] = np.einsum("bhs,bhps->bhp", ct, st)
    np.testing.assert_allclose(y.numpy(), ys, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(state.numpy(), st, atol=1e-4, rtol=1e-3)
    ry, rstate = ref_ssm.ssd_chunked(x, dt, a, bmat, cmat, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(state.numpy(), np.asarray(rstate),
                               atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(_t(x[:, :21]), _t(dt[:, :21]), _t(a),
                        _t(bmat[:, :21]), _t(cmat[:, :21]), chunk)


def test_long_chunk_gradients_finite_where_the_reference_is_nan():
    """At a 256-token chunk (the published mamba2 chunk) the masked part
    of the intra-chunk decay overflows: the reference's gradients turn
    non-finite (``where`` after ``exp`` backpropagates 0 * inf), the
    port's (masked before the ``exp``) stay finite, and the logits and
    loss still match the reference's (atol 1e-5 / rtol 1e-4)."""
    ref_cfg, cfg = ref_get_smoke("mamba2-1.3b"), get_smoke("mamba2-1.3b")
    ref_cfg = dataclasses.replace(ref_cfg, ssm=dataclasses.replace(
        ref_cfg.ssm, chunk=256))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=256))
    ref_params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))
    params = lm_params_from_reference(jax.tree.map(np.asarray, ref_params),
                                      "cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 256)) \
        .astype(np.int32)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_lm.lm_loss(ref_cfg, p, toks, toks))(ref_params)
    assert not all(np.isfinite(np.asarray(g)).all()
                   for g in jax.tree.leaves(ref_grads))
    loss, grads = _grads(cfg, params, toks, toks, None)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    np.testing.assert_allclose(
        lm.forward(cfg, params, _t(toks)).numpy(),
        np.asarray(ref_lm.forward(ref_cfg, ref_params, toks)), **TOL)


@pytest.mark.parametrize("l", [21, 40])
def test_mamba_block_padding_matches_reference(l):
    """``mamba_block`` at a length that is not a chunk multiple (the
    zero-dt padding runs) and at one past the chunk: output, final state
    and the raw conv tail within atol 1e-5 / rtol 1e-4 of the
    reference's."""
    ref_cfg, cfg = ref_get_smoke("mamba2-1.3b"), get_smoke("mamba2-1.3b")
    ref_p = jax.tree.map(lambda a: a[0], ref_lm.init_params(
        ref_cfg, jax.random.PRNGKey(3))["blocks"][0]["mixer"])
    p = tree_map(_t, ref_p)
    x = np.random.default_rng(l).normal(size=(2, l, cfg.d_model)).astype(
        np.float32)
    out, (tail, state) = ssm.mamba_block(cfg, p, _t(x), return_cache=True)
    rout, (rtail, rstate) = ref_ssm.mamba_block(ref_cfg, ref_p, x,
                                                return_cache=True)
    for got, want in ((out, rout), (tail, rtail), (state, rstate)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-4)
    assert tail.shape == (2, cfg.ssm.d_conv - 1,
                          cfg.ssm.d_inner(cfg.d_model)
                          + 2 * cfg.ssm.n_groups * cfg.ssm.d_state)


def _moe_case(arch, capacity_factor, t=48):
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    if capacity_factor is not None:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(
            ref_cfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    ref_params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(4))
    ref_p = jax.tree.map(lambda a: a[0], ref_params["blocks"][0]["ffn"])
    p = tree_map(_t, ref_p)
    x = np.random.default_rng(5).normal(size=(2, t // 2, cfg.d_model)) \
        .astype(np.float32)
    return ref_cfg, cfg, ref_p, p, x


@pytest.mark.parametrize("capacity_factor", [None, 1.0, 0.5],
                         ids=["published", "cf1", "cf0.5"])
@pytest.mark.parametrize("arch", ["arctic-480b", "moonshot-v1-16b-a3b",
                                  "jamba-1.5-large-398b"])
def test_moe_block_matches_reference(arch, capacity_factor):
    """The routing first: the same expert ids (``gidx``, in the same
    order) and gates within 1e-6; then ``moe_block`` within atol 1e-5 /
    rtol 1e-4 of the reference's, at the smoke config's capacity factor
    (nothing dropped) and at two that drop tokens (the overflow slot)."""
    ref_cfg, cfg, ref_p, p, x = _moe_case(arch, capacity_factor)
    k = cfg.moe.top_k
    xf = x.reshape(1, -1, cfg.d_model)
    ref_gates = jax.nn.softmax(jnp.asarray(xf) @ ref_p["w_router"], -1)
    ref_gvals, ref_gidx = jax.lax.top_k(ref_gates, k)
    gvals, gidx = moe._route(p, _t(xf), k)
    np.testing.assert_array_equal(gidx.numpy(), np.asarray(ref_gidx))
    ref_gvals = ref_gvals / jnp.maximum(ref_gvals.sum(-1, keepdims=True),
                                        1e-9)
    np.testing.assert_allclose(gvals.numpy(), np.asarray(ref_gvals),
                               atol=1e-6, rtol=1e-6)
    out = moe.moe_block(cfg, p, _t(x)).numpy()
    ref = np.asarray(ref_lm.moe_mod.moe_block(ref_cfg, ref_p, x))
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-4)
    t = x.shape[0] * x.shape[1]
    cap = min(max(1, int(k * t * cfg.moe.capacity_factor
                         / cfg.moe.num_experts)), t)
    load = np.bincount(gidx.numpy().ravel(), minlength=cfg.moe.num_experts)
    assert (load.max() > cap) == (capacity_factor in (1.0, 0.5)), \
        (load, cap)


def test_rp_dot_bf16_out_within_a_bf16_step():
    """``rp_dot(bf16_out=True)`` casts the f32 product to bf16; the
    reference's ``preferred_element_type`` product may round the last
    bit otherwise, so the two agree within one bf16 step (2^-7
    relative)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 5, 64)).astype(np.float32)
    b = rng.normal(size=(64, 32)).astype(np.float32)
    got = layers.rp_dot(_t(a), _t(b), True)
    want = np.asarray(ref_layers.rp_dot(a, b, True).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    np.testing.assert_allclose(layers.rp_dot(_t(a), _t(b), False).numpy(),
                               np.asarray(ref_layers.rp_dot(a, b, False)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference_eval_shape(arch):
    """The full-size config's ``abstract_params`` are meta tensors (no
    storage) of the reference's ``eval_shape`` shapes and dtypes, leaf
    by leaf, and their count is the analytic ``param_count``."""
    ours = lm.abstract_params(get_arch(arch))
    theirs = ref_lm.abstract_params(ref_get_arch(arch))
    got, want = tree_leaves(ours), jax.tree.leaves(theirs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_meta and tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
    assert sum(g.numel() for g in got) == get_arch(arch).param_count()
    cache = lm.init_cache(get_arch(arch), 2, 64)
    ref_cache = ref_lm.init_cache(ref_get_arch(arch), 2, 64)
    for g, w in zip(tree_leaves(cache), jax.tree.leaves(ref_cache)):
        assert g.is_meta and tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).split(".")[-1] == str(w.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_numel_equals_param_count(arch):
    """The smoke config's seeded ``init_params`` has ``param_count()``
    elements, the reference's keys and shapes, and is reproducible from
    its seed."""
    cfg = get_smoke(arch)
    params = lm.init_params(cfg, seed=3, device="cpu")
    assert sum(x.numel() for x in tree_leaves(params)) == cfg.param_count()
    ref = ref_lm.abstract_params(ref_get_smoke(arch), jnp.float32)
    assert [tuple(x.shape) for x in tree_leaves(params)] == \
        [tuple(x.shape) for x in jax.tree.leaves(ref)]
    again = lm.init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


def test_entry_points_need_a_device_without_a_gpu():
    """Without a GPU, ``init_params`` and ``zero_cache`` raise unless the
    caller asks for the CPU, as ``init_state`` does."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the GPU")
    cfg = get_smoke("qwen3-8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.zero_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm_params_from_reference({"embed": np.zeros((2, 2), np.float32),
                                  "blocks": (), "final_norm": np.ones(2)})
    zero = lm.zero_cache(cfg, 1, 8, device="cpu")
    assert all(not x.any() for x in tree_leaves(zero))
