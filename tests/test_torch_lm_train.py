"""LM training in the port (``repro_torch.launch.steps``,
``repro_torch.train.loop``, the ``lm`` CLI) against the reference's
(``repro.launch.steps``, ``repro.train.loop``) on the CPU, both packages
starting from the reference's parameters and optimizer state
(``convert.lm_params_from_reference`` / ``adamw_state_from_reference``)
and the same numpy batches.

Tolerances, each stated where it is used:
* losses within rtol 1e-5 of the reference's at every step;
* parameters: Adam's update is about ``lr·sign(g)``, so where a gradient
  entry is near float noise its sign may flip between the packages and
  move that entry by up to ``2·lr_t·(1 + wd·|p|)`` in step t. Every
  parameter is held within the sum of those over the steps taken, and at
  least 99.9% of each leaf's entries within 1e-6 + 1e-5·|p|;
* ``m`` and ``v`` (after clipping both are small) within atol 1e-6;
* prefill and serve logits within atol 1e-5 / rtol 1e-4, the caches
  within one bf16 step (2^-7 relative, atol 1e-6), a bf16 leaf plus the
  f32 drift before its cast (``_hold_cache``);
* ``synthetic_lm_batches`` bit for bit."""
import dataclasses
import logging
import os
import re
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.launch import steps as ref_steps
from repro.models import lm as ref_lm
from repro.train import loop as ref_loop
from repro.train import optim as ref_optim
from repro.train.resilience import FailureInjector as RefFailureInjector
from repro_torch.configs import get_smoke
from repro_torch.convert import (adamw_state_from_reference,
                                 lm_params_from_reference)
from repro_torch.launch import steps
from repro_torch.models import lm
from repro_torch.train import loop
from repro_torch.train.optim import AdamWConfig, AdamWState, adamw_init
from repro_torch.train.resilience import FailureInjector, StepTimeout
from repro_torch.tree import tree_leaves, tree_map
from tests.conftest import REPO, SRC

LOSS_RTOL = 1e-5
B, S = 4, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_opt(cfg: AdamWConfig):
    return ref_optim.AdamWConfig(**dataclasses.asdict(cfg))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch_t(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _flip_bound(cfg: AdamWConfig, steps_taken, params) -> float:
    """The most sign flips can move a parameter over ``steps_taken``
    steps: 2·lr_t·(1 + wd·max|p|) summed."""
    pmax = max(float(x.abs().max()) for x in tree_leaves(params))
    lrs = [float(ref_optim.lr_schedule(_ref_opt(cfg), jnp.int32(t)))
           for t in steps_taken]
    return sum(2 * lr * (1 + cfg.weight_decay * pmax) for lr in lrs)


def _hold_params(got, want, bound, what):
    """Every entry within ``bound``; 99.9% of each leaf's entries within
    1e-6 + 1e-5·|p|."""
    ours, theirs = tree_leaves(got), jax.tree.leaves(want)
    assert len(ours) == len(theirs)
    for g, w in zip(ours, theirs):
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        diff = np.abs(g - w)
        assert diff.max() <= bound, (what, diff.max(), bound)
        tight = diff <= 1e-6 + 1e-5 * np.abs(w)
        assert tight.mean() >= 0.999, (what, tight.mean(), diff.max())


# ------------------------------------------------------------ train steps
@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["starcoder2-3b", "moonshot-v1-16b-a3b",
                                  "mamba2-1.3b"])
def test_train_step_matches_reference(arch, microbatches):
    """Three steps of ``make_train_step`` (batch 4, seq 16) from the same
    converted parameters and AdamW state on the reference's synthetic
    batches: losses within rtol 1e-5, parameters within the sign-flip
    bound (module docstring), moments within atol 1e-6, the step equal."""
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    opt = AdamWConfig(lr=1e-3, total_steps=6, warmup_steps=2)
    ref_p = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0))
    ref_s = ref_optim.adamw_init(ref_p)
    p = lm_params_from_reference(_np_tree(ref_p), "cpu")
    s = adamw_state_from_reference(_np_tree(ref_s), "cpu")
    ref_step = jax.jit(ref_steps.make_train_step(ref_cfg, _ref_opt(opt),
                                                 microbatches))
    step = steps.make_train_step(cfg, opt, microbatches)
    batches = ref_loop.synthetic_lm_batches(ref_cfg, B, S)
    for i in range(3):
        rb = next(batches)
        ref_p, ref_s, ref_m = ref_step(ref_p, ref_s, rb)
        p, s, m = step(p, s, _batch_t(rb))
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=LOSS_RTOL)
        assert int(m["step"]) == int(ref_m["step"]) == i + 1
        assert isinstance(s, AdamWState) and int(s.step) == i + 1
        _hold_params(p, ref_p, _flip_bound(opt, range(1, i + 2), p),
                     (arch, microbatches, i))
        for ours, theirs in ((s.m, ref_s.m), (s.v, ref_s.v)):
            for g, w in zip(tree_leaves(ours), jax.tree.leaves(theirs)):
                assert g.dtype == torch.float32
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-6, rtol=0)


def test_microbatches_accumulate_in_f32_for_bf16_parameters():
    """With bf16 parameters the one-batch step hands AdamW bf16 gradients
    and the microbatched steps f32 ones (accumulated in f32), with the
    one-batch loss within rtol 1e-5 (the mean of the microbatch means)."""
    cfg = get_smoke("qwen3-8b")
    opt = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    batch = _batch_t(next(ref_loop.synthetic_lm_batches(
        ref_get_smoke("qwen3-8b"), B, S)))
    losses, seen = [], []
    real = steps.adamw_update

    def spy(opt_, params, grads, state, **kw):
        seen.append({x.dtype for x in tree_leaves(grads)})
        return real(opt_, params, grads, state, **kw)

    steps.adamw_update = spy
    try:
        for mb in (1, 2, 4):
            p = lm.init_params(cfg, seed=0, dtype=torch.bfloat16,
                               device="cpu")
            _, _, m = steps.make_train_step(cfg, opt, mb)(
                p, adamw_init(p), batch)
            losses.append(float(m["loss"]))
    finally:
        steps.adamw_update = real
    assert seen == [{torch.bfloat16}, {torch.float32}, {torch.float32}]
    np.testing.assert_allclose(losses[1:], [losses[0]] * 2, rtol=1e-5)


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-1.3b",
                                  "jamba-1.5-large-398b", "musicgen-large"])
def test_prefill_and_serve_steps_match_reference(arch):
    """``make_prefill_step`` and ``make_serve_step`` of both packages from
    the same parameters: prefill logits within atol 1e-5 / rtol 1e-4, its
    cache as ``_hold_cache`` holds it, and one serve step on that cache
    (padded by one slot) with its logits and new cache held the same way."""
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    ref_p = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(1))
    p = lm_params_from_reference(_np_tree(ref_p), "cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.prefix_len:
        batch["prefix_embeds"] = rng.normal(
            0, 1, (2, cfg.prefix_len, cfg.d_model)).astype(np.float32)
    want = ref_steps.make_prefill_step(ref_cfg)(ref_p, batch)
    got = steps.make_prefill_step(cfg)(p, _batch_t(batch))
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-5,
                               rtol=1e-4)
    assert int(got["cache_len"]) == int(want["cache_len"])
    _hold_cache(got["cache"], want["cache"])

    def pad(c, xp):
        return tuple({k: (xp.pad(v, [(0, 0)] * 2 + [(0, 1)] + [(0, 0)] * 2)
                          if k in ("k", "v") else v) for k, v in blk.items()}
                     for blk in c)

    ref_cache = pad(want["cache"], jnp)
    nxt = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    want = ref_steps.make_serve_step(ref_cfg)(
        ref_p, {"tokens": nxt, "cache": ref_cache,
                "cache_len": want["cache_len"]})
    got = steps.make_serve_step(cfg)(
        p, {"tokens": torch.from_numpy(nxt),
            "cache": tree_map(_from_ref_leaf, _np_tree(ref_cache)),
            "cache_len": got["cache_len"]})
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-5,
                               rtol=1e-4)
    _hold_cache(got["cache"], want["cache"])


def _from_ref_leaf(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


BF16_STEP = 2 ** -7          # bf16's spacing relative to a normal value
F32_DRIFT = 1e-5             # the logits' atol, relative to a leaf's scale


def _hold_cache(got, want):
    """Each cache leaf against the reference's: an f32 leaf within 2^-7
    relative (atol 1e-6); a bf16 leaf within one bf16 step of itself plus
    the f32 drift upstream of its cast.

    The bound of a bf16 leaf: the two packages cast f32 values ``a``
    (ours) and ``b`` (the reference's) with ``|a - b| <= d``, sums of the
    same products in another order, so ``d`` scales with the leaf's
    largest entry rather than with the entry itself. Round-to-nearest
    moves each by at most half a step, ``u(x)/2 <= 2^-8·|x|``, hence
    ``|bf16(a) - bf16(b)| <= d + 2^-8·(|a| + |b|)
    <= d·(1 + 2^-8) + 2^-7·|w|·(1 + 2^-7)`` with ``w = bf16(b)`` (as
    ``|b| <= |w|·(1 + 2^-7)``). With ``d`` the logits' drift, ``1e-5``
    times the leaf's largest entry, that is at most the rtol and atol
    below. A small entry may thus differ by more than one step of itself
    (two steps at 2.6e-4 in the jamba smoke's conv window, where the f32
    values before the cast differ by 3.4e-6 at a leaf maximum of 3.2)."""
    ours, theirs = tree_leaves(got), jax.tree.leaves(want)
    assert len(ours) == len(theirs)
    for g, w in zip(ours, theirs):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        w = np.asarray(w, np.float32)
        if g.dtype == torch.bfloat16:
            atol = 1e-6 + F32_DRIFT * (1 + 2 ** -8) * float(np.abs(w).max())
            rtol = BF16_STEP * (1 + BF16_STEP)
        else:
            atol, rtol = 1e-6, BF16_STEP
        np.testing.assert_allclose(g.float().numpy(), w, atol=atol,
                                   rtol=rtol)


def test_input_specs_match_reference():
    """Meta tensors of the reference's shapes and dtypes for every kind of
    cell (the decode cache included)."""
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro_torch.configs.base import SHAPES
    for arch in ("qwen3-8b", "musicgen-large", "jamba-1.5-large-398b"):
        ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
        for name in ("train_4k", "prefill_32k", "decode_32k"):
            want = ref_steps.input_specs(ref_cfg, REF_SHAPES[name],
                                         jnp.float32)
            got = steps.input_specs(cfg, SHAPES[name], torch.float32)
            assert sorted(got) == sorted(want)
            ws, gs = jax.tree.leaves(want), tree_leaves(got)
            assert len(ws) == len(gs)
            for g, w in zip(gs, ws):
                assert g.device.type == "meta"
                assert tuple(g.shape) == tuple(w.shape)
                assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


# ------------------------------------------------------------ data stream
@pytest.mark.parametrize("arch", ["starcoder2-3b", "musicgen-large",
                                  "internvl2-76b"])
def test_synthetic_batches_bit_identical(arch):
    """Tokens, labels and (with a prefix) ``prefix_embeds``: the
    reference's arrays bit for bit, step after step, with dtypes int32 and
    float32."""
    ref_it = ref_loop.synthetic_lm_batches(ref_get_smoke(arch), 3, 10,
                                           seed=5)
    it = loop.synthetic_lm_batches(get_smoke(arch), 3, 10, seed=5,
                                   device="cpu")
    for _ in range(3):
        want, got = next(ref_it), next(it)
        assert sorted(got) == sorted(want)
        assert ("prefix_embeds" in got) == bool(get_smoke(arch).prefix_len)
        for k in want:
            w = np.asarray(want[k])
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k


# ------------------------------------- the reference's Trainer tests, mirrored
def _ref_init(cfg_name="starcoder2-3b"):
    return lm_params_from_reference(_np_tree(ref_lm.init_params(
        ref_get_smoke(cfg_name), jax.random.PRNGKey(0))), "cpu")


def _trainer(tmp_path=None, steps=12, injector=None, start_ref=True, **kw):
    """``tests/test_train_loop.py``'s trainer on the port, on the CPU, from
    the reference Trainer's initial parameters (a fresh trainer; one that
    restores a checkpoint keeps what it restored)."""
    cfg = get_smoke("starcoder2-3b")
    lc = loop.LoopConfig(steps=steps,
                         ckpt_dir=str(tmp_path) if tmp_path else None,
                         ckpt_every=4, log_every=100)
    opt = AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2)
    tr = loop.Trainer(cfg, opt, lc, batch=2, seq=16,
                      failure_injector=injector, device="cpu", **kw)
    if start_ref and tr.start_step == 0:
        tr.params = _ref_init()
        tr.opt_state = adamw_init(tr.params)
    return tr


def _ref_trainer(tmp_path=None, steps=12, injector=None):
    cfg = ref_get_smoke("starcoder2-3b")
    lc = ref_loop.LoopConfig(steps=steps,
                             ckpt_dir=str(tmp_path) if tmp_path else None,
                             ckpt_every=4, log_every=100)
    opt = ref_optim.AdamWConfig(lr=1e-3, total_steps=steps, warmup_steps=2)
    return ref_loop.Trainer(cfg, opt, lc, batch=2, seq=16,
                            failure_injector=injector)


def test_loss_decreases():
    """The reference's property, and the reference Trainer's 15 losses
    within rtol 1e-5."""
    tr = _trainer(steps=15)
    out = tr.train()
    losses = out["losses"]
    assert out["final_step"] == 15
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    ref = _ref_trainer(steps=15).train()
    np.testing.assert_allclose(losses, ref["losses"], rtol=LOSS_RTOL)
    assert out["stragglers"] == ref["stragglers"] == []


def test_checkpoint_resume(tmp_path):
    tr = _trainer(tmp_path, steps=6)
    tr.train()
    # new trainer picks up at the checkpointed step
    tr2 = _trainer(tmp_path, steps=10)
    assert tr2.start_step == 6
    out = tr2.train()
    assert out["final_step"] == 10


def test_failure_recovery_with_checkpoint(tmp_path):
    inj = FailureInjector([5, 9])
    tr = _trainer(tmp_path, steps=12, injector=inj)
    out = tr.train()
    assert out["final_step"] == 12
    assert not inj.fail_steps          # both failures consumed
    assert all(np.isfinite(l) for l in out["losses"])


def test_failure_without_checkpoint_still_completes():
    inj = FailureInjector([3])
    tr = _trainer(None, steps=6, injector=inj)
    out = tr.train()
    assert out["final_step"] == 6


def test_trainer_learns_a_fixed_batch():
    """From the port's own seeded parameters (not the reference's), the
    CLI's settings (lr 3e-4, warmup 1, 12 steps) on one fixed batch: the
    loss falls by more than 0.5 nats. On the synthetic stream of random
    tokens whether the last loss is below the first depends on the draw
    of the initial parameters, in both packages."""
    cfg = get_smoke("starcoder2-3b")
    fixed = next(loop.synthetic_lm_batches(cfg, 2, 16, device="cpu"))
    tr = loop.Trainer(cfg, AdamWConfig(lr=3e-4, total_steps=12,
                                       warmup_steps=1),
                      loop.LoopConfig(steps=12, log_every=100),
                      batch_fn=lambda step: fixed, device="cpu")
    losses = tr.train()["losses"]
    assert losses[0] - losses[-1] > 0.5, losses


def test_nonfinite_loss_raises():
    """A NaN parameter makes the loss non-finite: the step raises
    ``FloatingPointError``, which the recovery loop retries until its
    budget is spent."""
    tr = _trainer(steps=2)
    tr.params["final_norm"][0] = float("nan")
    with pytest.raises(FloatingPointError):
        tr.train()


def _slow_at(slow_steps, sleep_s):
    """The synthetic stream, with a host stall of ``sleep_s`` before the
    batch of each step in ``slow_steps``."""
    it = loop.synthetic_lm_batches(get_smoke("starcoder2-3b"), 2, 16,
                                   device="cpu")

    def batch_fn(step):
        if step in slow_steps:
            time.sleep(sleep_s)
        return next(it)
    return batch_fn


def test_step_timeout_fires_and_recovers(caplog):
    """``LoopConfig.step_timeout_s`` guards each step with a watchdog: a
    step that overruns it (a stall of twice the timeout) fails with
    ``StepTimeout``, is recovered, and the run ends at its last step.
    With no checkpoint the overrun step's update stands, so losses and
    parameters equal a run without the stall exactly.

    The run without the stall goes first: it takes the process's one-time
    warm-up (a first step of 2.5-2.7 s on a CPU that then steps in
    0.24-0.64 s, a second trainer's first step included), and its slowest
    warm step ``s`` (steps 1-3) sets the timeout, ``max(5 s, 4·s)``, so
    that the timeout does not grow with the cold step. The floor is for a
    loaded host: in a full ``-n 6`` run an unstalled step overran a
    2.06 s timeout whose warm steps had taken at most 0.52 s."""
    marks = []
    stream = _slow_at(set(), 0.0)

    def timed(step):
        marks.append(time.perf_counter())
        return stream(step)

    plain = _trainer(steps=4, batch_fn=timed)
    want = plain.train()
    marks.append(time.perf_counter())
    timeout = max(5.0, 4 * float(np.diff(marks)[1:].max()))
    tr = _trainer(steps=4, batch_fn=_slow_at({2}, 2 * timeout))
    tr.loop = dataclasses.replace(tr.loop, step_timeout_s=timeout)
    with caplog.at_level(logging.WARNING):
        out = tr.train()
    recovered = [r.getMessage() for r in caplog.records
                 if "recovering" in r.getMessage()]
    assert len(recovered) == 1 and "StepTimeout" in recovered[0], recovered
    assert out["final_step"] == 4 and len(out["losses"]) == 4
    assert out["losses"] == want["losses"]
    for g, w in zip(tree_leaves(tr.params), tree_leaves(plain.params)):
        assert torch.equal(g, w)


def test_step_timeout_beyond_the_restart_budget_raises():
    """Every step overruns (a 0.2 s stall against 0.05 s) and no restart
    is allowed: ``train`` raises ``StepTimeout``."""
    tr = _trainer(steps=2, batch_fn=_slow_at({0, 1}, 0.2))
    tr.loop = dataclasses.replace(tr.loop, step_timeout_s=0.05,
                                  max_restarts=0)
    with pytest.raises(StepTimeout):
        tr.train()


def test_failure_recovery_matches_the_reference(tmp_path):
    """The same schedule of failures (steps 5 and 9, checkpoints every 4)
    in both packages: equal final steps and loss histories (replayed
    steps included) within rtol 1e-5."""
    port = _trainer(tmp_path / "port", injector=FailureInjector([5, 9]))
    ref = _ref_trainer(tmp_path / "ref", injector=RefFailureInjector([5, 9]))
    out, ref_out = port.train(), ref.train()
    assert out["final_step"] == ref_out["final_step"] == 12
    assert len(out["losses"]) == len(ref_out["losses"])
    np.testing.assert_allclose(out["losses"], ref_out["losses"],
                               rtol=LOSS_RTOL)


# -------------------------------------------- cross-package checkpoints
def test_checkpoint_resume_across_the_packages(tmp_path):
    """The reference Trainer checkpoints 6 steps; the port's Trainer on a
    copy resumes at step 6 with the reference's bytes (parameters, moments
    and step) and trains to 10 with the reference's resumed losses (rtol
    1e-5); the reference Trainer resumes from the port's checkpoint at
    step 10 with the port's bytes."""
    import shutil
    a, b = tmp_path / "a", tmp_path / "b"
    _ref_trainer(a, steps=6).train()
    shutil.copytree(a, b)
    port = _trainer(a, steps=10)
    assert port.start_step == 6
    assert isinstance(port.opt_state, AdamWState)
    ref = _ref_trainer(b, steps=10)
    for got, want in zip(tree_leaves({"p": port.params,
                                      "o": port.opt_state}),
                         jax.tree.leaves({"p": ref.params,
                                          "o": ref.opt_state})):
        assert got.numpy().tobytes() == np.asarray(want).tobytes()
    out, ref_out = port.train(), ref.train()
    assert out["final_step"] == ref_out["final_step"] == 10
    np.testing.assert_allclose(out["losses"], ref_out["losses"],
                               rtol=LOSS_RTOL)
    back = _ref_trainer(a, steps=10)
    assert back.start_step == 10
    for got, want in zip(jax.tree.leaves({"p": back.params,
                                          "o": back.opt_state}),
                         tree_leaves({"p": port.params,
                                      "o": port.opt_state})):
        assert np.asarray(got).tobytes() == want.numpy().tobytes()


# ---------------------------------------------------------------- the CLI
def _cli(module, *flags, device=True):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", module, "lm", "--arch", "starcoder2-3b",
           "--smoke", "--steps", "12", "--batch", "2", "--seq", "16",
           *flags]
    return subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


LINE = re.compile(r"final step (\d+); loss (\S+) -> (\S+)")


def test_lm_cli_matches_the_reference_cli():
    """``python -m repro_torch.launch.train lm ... --device cpu`` and the
    reference's ``python -m repro.launch.train lm ...`` with the same
    flags both exit 0 and print ``final step 12; loss a -> b`` with finite
    losses (the packages draw different initial parameters from one seed,
    so a and b differ between them)."""
    ours = _cli("repro_torch.launch.train", "--device", "cpu")
    assert ours.returncode == 0, ours.stderr[-3000:]
    theirs = _cli("repro.launch.train")
    assert theirs.returncode == 0, theirs.stderr[-3000:]
    for out in (ours.stdout, theirs.stdout):
        m = LINE.search(out)
        assert m and m.group(1) == "12", out
        assert np.isfinite(float(m.group(2))) and \
            np.isfinite(float(m.group(3)))


def test_lm_cli_defaults_to_the_gpu():
    """Without ``--device`` the CLI runs on the GPU: with none it fails
    rather than running on the CPU."""
    out = _cli("repro_torch.launch.train")
    if torch.cuda.is_available():
        assert out.returncode == 0 and LINE.search(out.stdout), out.stderr
    else:
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr, out.stderr[-2000:]
        assert "final step" not in out.stdout
