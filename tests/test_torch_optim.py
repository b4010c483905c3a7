"""The port's AdamW (``repro_torch.train.optim``) against the reference's
(``repro.train.optim``) on the CPU, and the checkpoint format of its
``AdamWState``.

Tolerances, each stated where it is used: ``lr_schedule`` within rtol
1e-6 at every step (``cos`` may round its last bit apart, and the floor
``min_lr_frac + (1 - min_lr_frac)·cos`` near its end cancels, which
scales that bit up to 3 ulps of the result);
``global_norm`` within rtol 1e-6 (the packages sum in another order);
five ``adamw_update`` steps on the same trees and gradients with
parameters, ``m`` and ``v`` within rtol 1e-5 / atol 1e-7 (f32 leaves) and
a bf16 leaf within one bf16 step; checkpoint keys equal and bytes equal
both ways across the packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt
from repro.train import optim as ref_optim
from repro_torch.convert import adamw_state_from_reference
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import (AdamWConfig, AdamWState, adamw_init,
                                     adamw_update, global_norm, lr_schedule)
from repro_torch.tree import tree_leaves, tree_map

D = 8


def _tree(rng, bf16=False):
    """A parameter-shaped tree: a matrix, a layer-stacked (2, d) norm scale
    (decayed: two dims), a (d,) scale (not decayed), a 3-d leaf in a
    tuple; with ``bf16`` one bf16 matrix."""
    t = {"w": rng.normal(0, 1, (D, 4)).astype(np.float32),
         "blocks": ({"pre_norm": (1 + 0.1 * rng.normal(0, 1, (2, D)))
                     .astype(np.float32),
                     "wq": rng.normal(0, 0.3, (2, D, 3)).astype(np.float32)},),
         "final_norm": rng.normal(1, 0.1, (D,)).astype(np.float32)}
    if bf16:
        t["h"] = rng.normal(0, 1, (D, D)).astype(np.float32)
    return t


def _grads(rng, like, scale):
    return tree_map(lambda a: (rng.normal(0, scale, a.shape)
                               .astype(np.float32)), like)


def _to_ref(tree, bf16_keys=()):
    return {k: (jax.tree.map(jnp.asarray, v) if k not in bf16_keys
                else jnp.asarray(v, jnp.bfloat16)) for k, v in tree.items()}


def _to_port(tree, bf16_keys=()):
    return {k: (tree_map(torch.from_numpy, v) if k not in bf16_keys
                else torch.from_numpy(v).to(torch.bfloat16))
            for k, v in tree.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16
                      else x)


@pytest.mark.parametrize("cfg", [
    AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5),
    AdamWConfig(lr=3e-3, weight_decay=0.0, grad_clip=0.5, warmup_steps=0,
                total_steps=3, min_lr_frac=0.5)])
def test_adamw_update_matches_reference(cfg):
    """Five steps from the same tree and the same gradients (steps 1 and
    3 large enough to clip): every parameter, moment and the step within
    rtol 1e-5 / atol 1e-7; the bf16 matrix within one bf16 step of its
    value (2^-7 relative); the stacked (2, d) norm scale is decayed, as in
    the reference."""
    rng = np.random.default_rng(0)
    params = _tree(rng, bf16=True)
    ref_p, p = _to_ref(params, ("h",)), _to_port(params, ("h",))
    ref_s, s = ref_optim.adamw_init(ref_p), adamw_init(p)
    ref_cfg = ref_optim.AdamWConfig(**{f: getattr(cfg, f) for f in (
        "lr", "b1", "b2", "eps", "weight_decay", "grad_clip",
        "warmup_steps", "total_steps", "min_lr_frac")})
    for step in range(5):
        g = _grads(rng, params, 10.0 if step in (1, 3) else 0.05)
        ref_p, ref_s = ref_optim.adamw_update(ref_cfg, ref_p, _to_ref(g),
                                              ref_s)
        p, s = adamw_update(cfg, p, _to_port(g), s)
        assert int(s.step) == int(ref_s.step) == step + 1
        assert s.step.dtype == torch.int32
        for want, got in zip(jax.tree.leaves(ref_p), tree_leaves(p)):
            if got.dtype == torch.bfloat16:
                np.testing.assert_allclose(_np(got), _np(want),
                                           rtol=2 ** -7, atol=0)
            else:
                np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                           atol=1e-7)
        for tree, ref_tree in ((s.m, ref_s.m), (s.v, ref_s.v)):
            for want, got in zip(jax.tree.leaves(ref_tree),
                                 tree_leaves(tree)):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), _np(want),
                                           rtol=1e-5, atol=1e-7)


def test_stacked_norm_scale_is_decayed():
    """With a zero gradient only decoupled weight decay moves a leaf: the
    stacked (2, d) norm scale by lr·wd·p (ndim >= 2, the reference's
    rule), the (d,) one not at all."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5, warmup_steps=0,
                      total_steps=10, min_lr_frac=1.0)
    p = {"stacked": torch.full((2, D), 2.0), "flat": torch.full((D,), 2.0)}
    s = adamw_init(p)
    adamw_update(cfg, p, tree_map(torch.zeros_like, p), s)
    torch.testing.assert_close(p["stacked"], torch.full((2, D), 1.9))
    assert torch.equal(p["flat"], torch.full((D,), 2.0))


@pytest.mark.parametrize("kw", [
    dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
    dict(lr=3e-4, warmup_steps=1, total_steps=12),
    dict(lr=1e-3, warmup_steps=0, total_steps=0),
    dict(lr=2e-3, warmup_steps=7, total_steps=5, min_lr_frac=0.3)])
def test_lr_schedule_matches_reference_at_every_step(kw):
    cfg, ref_cfg = AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    for step in range(0, kw["total_steps"] + 12):
        want = np.float32(ref_optim.lr_schedule(ref_cfg, jnp.int32(step)))
        got = lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, atol=0)
        assert lr_schedule(cfg, step).item() == got.item()


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    np.testing.assert_allclose(
        global_norm(tree_map(torch.from_numpy, tree)).item(),
        float(ref_optim.global_norm(jax.tree.map(jnp.asarray, tree))),
        rtol=1e-6)


# ------------------------------------ the reference's three properties
def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=200, min_lr_frac=1.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state = adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.05


def test_lr_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1.0) < 1e-6          # end of warmup
    assert lrs[-1] <= lrs[1]
    assert abs(lrs[-1] - 0.1) < 1e-6          # cosine floor


def test_grad_clip_effect():
    cfg = AdamWConfig(lr=1e-2, grad_clip=1.0, weight_decay=0.0,
                      warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = adamw_init(params)
    _, state2 = adamw_update(cfg, params, {"w": torch.full((4,), 1e6)},
                             state)
    # clipped: second moment bounded by clip^2
    assert float(state2.v["w"].max()) <= 1.0 * (1 - cfg.b2) + 1e-6


# ----------------------------------------- the AdamWState checkpoint
def _states(seed):
    """The same {"params", "opt"} tree in both packages: the reference's
    after two updates, and the port's converted from it."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    ref_p = _to_ref(params)
    ref_s = ref_optim.adamw_init(ref_p)
    cfg = ref_optim.AdamWConfig(warmup_steps=0)
    for _ in range(2):
        ref_p, ref_s = ref_optim.adamw_update(cfg, ref_p, _to_ref(
            _grads(rng, params, 1.0)), ref_s)
    port = {"params": tree_map(lambda a: torch.from_numpy(np.array(a)),
                               jax.tree.map(np.asarray, ref_p)),
            "opt": adamw_state_from_reference(
                jax.tree.map(np.asarray, ref_s), "cpu")}
    return {"params": ref_p, "opt": ref_s}, port


def test_adamw_state_from_reference():
    ref, port = _states(0)
    s = port["opt"]
    assert isinstance(s, AdamWState)
    assert s.step.dtype == torch.int32 and s.step.shape == () and \
        int(s.step) == 2
    for want, got in zip(jax.tree.leaves(ref["opt"]), tree_leaves(s)):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()


def test_checkpoint_keys_name_namedtuple_fields_as_the_reference():
    """A tree holding an ``AdamWState`` flattens to the reference's keys
    (``opt/step``, ``opt/m/...``, ``opt/v/...``; ``blocks/0/...`` stays an
    index) in the reference's order."""
    ref, port = _states(1)
    ours = [k for k, _ in ckpt._flatten_with_paths(port)]
    assert ours == [k for k, _ in ref_ckpt._flatten_with_paths(ref)]
    assert "opt/step" in ours and "opt/m/blocks/0/pre_norm" in ours
    assert "params/blocks/0/wq" in ours


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_adamw_checkpoint_crosses_the_packages(tmp_path, writer):
    """A ``{"params", "opt"}`` checkpoint written by either package is
    restored by the other with equal bytes, the port's NamedTuple rebuilt
    as an ``AdamWState``."""
    ref, port = _states(2)
    d = str(tmp_path)
    if writer == "port":
        ckpt.save(d, 4, port, extra={"arch": "x"})
        got, extra = ref_ckpt.restore(d, ref)
        assert type(got["opt"]).__name__ == "AdamWState"
        want = port
    else:
        ref_ckpt.save(d, 4, ref, extra={"arch": "x"})
        got, extra = ckpt.restore(d, port, device="cpu")
        assert isinstance(got["opt"], AdamWState)
        assert got["opt"].step.dtype == torch.int32
        want = ref
    assert extra == {"arch": "x"}
    got_leaves = [np.asarray(x) for x in jax.tree.leaves(got)] \
        if writer == "port" else [x.numpy() for x in tree_leaves(got)]
    want_leaves = [x.numpy() for x in tree_leaves(want)] \
        if writer == "port" else [np.asarray(x) for x in
                                  jax.tree.leaves(want)]
    assert len(got_leaves) == len(want_leaves) == 13
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
