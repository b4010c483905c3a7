"""The MoE's dispatch groups on a data-sharded mesh and its expert
parallelism (``repro_torch.models.moe``) against the reference.

* The repair: on a ``(data=2, model=1)`` mesh of 2 gloo ranks the prefill
  and serve cells of smoke moonshot-v1-16b-a3b at ``capacity_factor``
  0.5 (tokens drop) route each data shard's tokens as one dispatch group,
  as the reference's ``_dispatch_groups`` does: their logits equal one
  process's prefill and decode of each shard's rows, concatenated, within
  1e-5 relative, and differ from one process's run of the whole batch as
  one group (routing the gathered batch as one group) by far more.
* ``_local_expert_pass`` (one shard's experts) equals the reference's at
  f32 within rtol 1e-5 / atol 1e-6 for every model shard.
* Expert parallelism on 4 gloo ranks ``(data=2, model=2)``, smoke
  moonshot and arctic (its dense residual) at ``capacity_factor`` 1.25
  (the published value; tokens drop): the forward equals the reference's
  ``_local_expert_pass`` per (data, model) shard, cast to bf16, summed in
  rank order and cast back; and forward and gradients (block input,
  ``w_router``, the experts, the residual) equal the reference's
  ``moe_block`` on 4 forced host devices (a subprocess; jax 0.9.0's
  ``make_mesh`` needs Auto axes here; the reference's MoE module is
  reached through ``repro.models.lm``, which drives it). Tolerance: the outputs pass
  through one bf16 rounding of each partial and of their sum, so an
  entry may differ by one bf16 ulp of the largest partial (2^-8 of its
  magnitude) where the two packages' f32 partials round to neighbours.
  The gradients see one more rounding, the cotangent's cast to bf16,
  which is the same in both packages (the same cotangent), so they are
  held to f32 sums: within 1e-5 of the largest entry of each.
* A mesh ``Trainer`` (smoke moonshot, global batch 4, seq 32, 3 steps) on
  the same 4 ranks takes the expert-parallel path and ends within the
  bf16 sum's reach of one process: losses within 2^-8 relative, every
  parameter within the sign-flip bound 2·Σlr_t·(1 + wd·max|p|).

The ranks run in a subprocess script (spawned ranks import their function
from its ``__main__``) and hand rank 0 numpy arrays through
``all_gather_object``."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.distributed.sharding import axis_rules
from repro_torch.models import moe
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import AdamWConfig, lr_schedule
from repro_torch.tree import tree_leaves
from tests.conftest import REPO, SRC, run_subprocess

EP_ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b")
EP_CF = 1.25                      # the published capacity factor
REPAIR_CF = 0.5
OPT = dict(lr=1e-3, total_steps=3, warmup_steps=1)
BF16_ULP = 2.0 ** -8
GRAD_REL = 1e-5


def ep_cfg(arch, cf=EP_CF):
    cfg = get_smoke(arch)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def ep_inputs(seed=0):
    """Seeded numpy inputs of the expert-parallel block: per arch its
    router, experts, residual (arctic), block input (4, 8, d) and the
    loss's cotangent."""
    rng = np.random.default_rng(seed)
    z = {}
    for arch in EP_ARCHS:
        cfg = get_smoke(arch)
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts

        def draw(shape, scale):
            return rng.standard_normal(shape).astype(np.float32) * scale

        pre = arch + "/"
        z[pre + "w_router"] = draw((d, e), d ** -0.5)
        z[pre + "we_gate"] = draw((e, d, ff), d ** -0.5)
        z[pre + "we_up"] = draw((e, d, ff), d ** -0.5)
        z[pre + "we_down"] = draw((e, ff, d), ff ** -0.5)
        if cfg.moe.dense_residual:
            r = cfg.moe.dense_residual_ff
            z[pre + "res/w_gate"] = draw((d, r), d ** -0.5)
            z[pre + "res/w_up"] = draw((d, r), d ** -0.5)
            z[pre + "res/w_down"] = draw((r, d), r ** -0.5)
        z[pre + "x"] = draw((4, 8, d), 1.0)
        z[pre + "w"] = draw((4, 8, d), 1.0)
    return z


def split_params(z, arch, to=torch.from_numpy):
    pre = arch + "/"
    p = {k: to(z[pre + k]) for k in ("w_router", "we_gate", "we_up",
                                     "we_down")}
    res = {k.split("/")[-1]: to(v) for k, v in z.items()
           if k.startswith(pre + "res/")}
    if res:
        p["residual"] = res
    return p


SCRIPT = textwrap.dedent('''
    import dataclasses
    import pickle
    import sys

    REPAIR_CF = __REPAIR_CF__
    EP_CF = __EP_CF__
    OPT = __OPT__


    def np_tree(tree):
        from repro_torch.launch.steps import gather
        from repro_torch.tree import tree_map
        return tree_map(lambda t: t.detach().cpu().float().numpy(),
                        gather(tree))


    def repair_rank(mesh, toks, dec_toks):
        """Prefill and serve cells of smoke moonshot at capacity factor
        REPAIR_CF on a (data=2, model=1) mesh."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import SHAPES, InputShape
        from repro_torch.launch.steps import build_cell
        from repro_torch.models import lm
        torch.set_num_threads(1)
        dm = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data",
                                                             "model"))
        cfg = get_smoke("moonshot-v1-16b-a3b")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=REPAIR_CF))
        SHAPES["ep_prefill"] = InputShape("ep_prefill", 16, 4, "prefill")
        SHAPES["ep_decode"] = InputShape("ep_decode", 16, 4, "decode")
        params = lm.init_params(cfg, seed=1, device="cpu")
        cell, _, _ = build_cell(cfg, "ep_prefill", dm,
                                param_dtype=torch.float32)
        pre = cell(params, {"tokens": torch.from_numpy(toks)})
        cell, _, _ = build_cell(cfg, "ep_decode", dm,
                                param_dtype=torch.float32)
        dec = cell(params, {"tokens": torch.from_numpy(dec_toks),
                            "cache": pre["cache"],
                            "cache_len": torch.tensor(15, dtype=torch.int32)})
        mine = {"prefill": np_tree(pre["logits"]),
                "decode": np_tree(dec["logits"])}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        return every


    def ep_rank(mesh, z):
        """The expert-parallel block (forward and gradients) and a mesh
        Trainer on a (data=2, model=2) mesh."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import get_smoke
        from repro_torch.distributed.sharding import axis_rules
        from repro_torch.models import moe
        from repro_torch.train.loop import LoopConfig, Trainer
        from repro_torch.train.optim import AdamWConfig
        torch.set_num_threads(1)
        dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data",
                                                             "model"))
        mine = {"coords": (dm.get_local_rank("data"),
                           dm.get_local_rank("model"))}
        for arch in ("moonshot-v1-16b-a3b", "arctic-480b"):
            cfg = get_smoke(arch)
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=EP_CF))
            pre = arch + "/"
            p = {k: torch.from_numpy(z[pre + k]).requires_grad_(True)
                 for k in ("w_router", "we_gate", "we_up", "we_down")}
            res = {k.split("/")[-1]: torch.from_numpy(v).requires_grad_(True)
                   for k, v in z.items() if k.startswith(pre + "res/")}
            if res:
                p["residual"] = res
            x = torch.from_numpy(z[pre + "x"]).requires_grad_(True)
            with axis_rules(dm):
                assert moe._ep_rules(cfg) is not None
                out = moe.moe_block(cfg, p, x)
            (out * torch.from_numpy(z[pre + "w"])).sum().backward()
            got = {"out": out.detach().numpy(), "gx": x.grad.numpy()}
            for k in ("w_router", "we_gate", "we_up", "we_down"):
                got["g/" + k] = p[k].grad.numpy()
            for k, v in res.items():
                got["g/res/" + k] = v.grad.numpy()
            mine[arch] = got
        tr = Trainer(get_smoke("moonshot-v1-16b-a3b"), AdamWConfig(**OPT),
                     LoopConfig(steps=3, log_every=100), mesh=dm, batch=4,
                     seq=32, device="cpu")
        calls = []
        real = moe._moe_ep
        moe._moe_ep = lambda *a: calls.append(1) or real(*a)
        out = tr.train()
        moe._moe_ep = real
        mine["trainer"] = {"losses": out["losses"], "ep_calls": len(calls),
                           "params": np_tree(tr.params)}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        return every


    if __name__ == "__main__":
        import numpy as np
        from repro_torch.launch.mesh import start_ranks
        z = dict(np.load(sys.argv[2]))
        if sys.argv[3] == "repair":
            res = start_ranks(repair_rank, 2, "cpu", z["toks"],
                              z["dec_toks"], timeout=240)
        else:
            res = start_ranks(ep_rank, 4, "cpu", z, timeout=240)
        with open(sys.argv[1], "wb") as f:
            pickle.dump(res, f)
''').replace("__REPAIR_CF__", repr(REPAIR_CF)).replace(
    "__EP_CF__", repr(EP_CF)).replace("__OPT__", repr(OPT))

REFERENCE = '''
    import dataclasses
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType

    from repro.configs import get_smoke
    from repro.distributed.sharding import axis_rules
    from repro.models import lm

    moe = lm.moe_mod
    assert jax.device_count() == 4
    z = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in ("moonshot-v1-16b-a3b", "arctic-480b"):
        cfg = get_smoke(arch)
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=EP_CF))
        pre = arch + "/"
        p = {k: jnp.asarray(z[pre + k])
             for k in ("w_router", "we_gate", "we_up", "we_down")}
        res = {k.split("/")[-1]: jnp.asarray(v) for k, v in z.items()
               if k.startswith(pre + "res/")}
        if res:
            p["residual"] = res
        x, w = jnp.asarray(z[pre + "x"]), jnp.asarray(z[pre + "w"])
        with axis_rules(mesh):
            y = jax.jit(lambda p, x: moe.moe_block(cfg, p, x))(p, x)
            gp, gx = jax.jit(jax.grad(
                lambda p, x: jnp.sum(moe.moe_block(cfg, p, x) * w),
                argnums=(0, 1)))(p, x)
        out[pre + "out"] = np.asarray(y)
        out[pre + "gx"] = np.asarray(gx)
        for k in ("w_router", "we_gate", "we_up", "we_down"):
            out[pre + "g/" + k] = np.asarray(gp[k])
        for k, v in gp.get("residual", {}).items():
            out[pre + "g/res/" + k] = np.asarray(v)
    np.savez(sys.argv[2], **out)
    print("OK")
'''


@pytest.fixture(scope="module")
def inputs():
    z = ep_inputs()
    rng = np.random.default_rng(7)
    cfg = get_smoke("moonshot-v1-16b-a3b")
    z["toks"] = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    z["dec_toks"] = rng.integers(0, cfg.vocab, (4, 1)).astype(np.int32)
    return z


def _run_ranks(tmp_path_factory, inputs, part):
    d = tmp_path_factory.mktemp("moe_" + part)
    script, out, src = d / "moe_ep.py", d / "out.pkl", d / "in.npz"
    script.write_text(SCRIPT)
    np.savez(src, **inputs)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, str(script), str(out), str(src),
                        part], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=400)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def repair_ranks(tmp_path_factory, inputs):
    return _run_ranks(tmp_path_factory, inputs, "repair")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    return {"ep": _run_ranks(tmp_path_factory, inputs, "ep")}


@pytest.fixture(scope="module")
def reference(tmp_path_factory, inputs):
    d = tmp_path_factory.mktemp("moe_ep_ref")
    src, dst = d / "in.npz", d / "out.npz"
    np.savez(src, **inputs)
    code = (textwrap.dedent(REFERENCE).replace("EP_CF", repr(EP_CF))
            .replace("sys.argv[1]", repr(str(src)))
            .replace("sys.argv[2]", repr(str(dst))))
    r = run_subprocess(code, n_devices=4, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return dict(np.load(dst))


# --------------------------------------------------------------- the repair
def test_prefill_and_serve_dispatch_one_group_per_data_shard(repair_ranks,
                                                             inputs):
    """The mesh cells' logits are one process's on each data shard's rows
    (one group each); one group over the whole batch drops other tokens."""
    from repro_torch.models import lm
    cfg = ep_cfg("moonshot-v1-16b-a3b", REPAIR_CF)
    params = lm.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(inputs["toks"])
    dec = torch.from_numpy(inputs["dec_toks"])

    def one_process(rows):
        logits, cache, clen = lm.prefill(cfg, params, toks[rows])
        d_logits, _ = lm.decode_step(cfg, params, cache, clen - 1,
                                     dec[rows])
        return logits.numpy(), d_logits.numpy()

    halves = [one_process(slice(0, 2)), one_process(slice(2, 4))]
    want_pre = np.concatenate([h[0] for h in halves])
    want_dec = np.concatenate([h[1] for h in halves])
    whole_pre, whole_dec = one_process(slice(0, 4))
    scale = np.abs(want_pre).max()
    # one group over the gathered batch drops other tokens
    assert np.abs(whole_pre - want_pre).max() > 1e-2 * scale
    assert np.abs(whole_dec - want_dec).max() > 1e-2 * np.abs(want_dec).max()
    for r in repair_ranks:
        np.testing.assert_allclose(r["prefill"], want_pre, rtol=0,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(r["decode"], want_dec, rtol=0,
                                   atol=1e-5 * np.abs(want_dec).max())


@pytest.mark.parametrize("sizes,t,groups", [
    ({"data": 2, "model": 1}, 64, 2), ({"data": 2, "model": 2}, 64, 2),
    ({"data": 4, "model": 1}, 6, 1), ({"data": 1, "model": 4}, 64, 1),
    ({"pod": 2, "data": 2, "model": 2}, 64, 4)])
def test_dispatch_groups_follow_the_data_shards(sizes, t, groups):
    """The reference's rule: one group per data shard when it divides the
    tokens; a caller on its data rank's rows sees one group of its own."""
    import types

    from repro.distributed import sharding as ref_sharding
    from repro.models import lm as ref_lm
    ref_moe = ref_lm.moe_mod
    n = sizes.get("pod", 1) * sizes["data"]
    with axis_rules(sizes):
        assert moe._dispatch_groups(t) == groups
        if t % n == 0:
            with moe.token_shards(n):
                assert moe._local_groups(t // n) == 1
    ref_rules = ref_sharding.Rules(types.SimpleNamespace(shape=sizes))
    with ref_sharding.activate_rules(ref_rules):
        assert ref_moe._dispatch_groups(t) == groups
    assert moe._dispatch_groups(t) == 1              # no rules: one group


# ------------------------------------------------------ the local pass
@pytest.mark.parametrize("arch", EP_ARCHS)
@pytest.mark.parametrize("shard", [0, 1])
def test_local_expert_pass_matches_reference(arch, shard, inputs):
    import jax.numpy as jnp
    from repro.configs import get_smoke as ref_smoke
    from repro.models import lm as ref_lm
    ref_moe = ref_lm.moe_mod
    cfg = ep_cfg(arch)
    rcfg = dataclasses.replace(ref_smoke(arch), moe=dataclasses.replace(
        ref_smoke(arch).moe, capacity_factor=EP_CF))
    p = split_params(inputs, arch, to=lambda a: a)
    e_loc = cfg.moe.num_experts // 2
    sl = slice(shard * e_loc, (shard + 1) * e_loc)
    x = inputs[arch + "/x"][:2].reshape(-1, cfg.d_model)
    got = moe._local_expert_pass(
        cfg, torch.from_numpy(x), torch.from_numpy(p["w_router"]),
        *(torch.from_numpy(p[k][sl]) for k in ("we_gate", "we_up",
                                                "we_down")),
        shard * e_loc, cfg.moe.num_experts).numpy()
    want = np.asarray(ref_moe._local_expert_pass(
        rcfg, jnp.asarray(x), jnp.asarray(p["w_router"]),
        *(jnp.asarray(p[k][sl]) for k in ("we_gate", "we_up", "we_down")),
        jnp.int32(shard * e_loc), cfg.moe.num_experts))
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --------------------------------------------------- expert parallelism
def _bf16(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _within_ulp(got, want, scale):
    diff = np.abs(got - want)
    assert diff.max() <= BF16_ULP * scale, (diff.max(), BF16_ULP * scale)


@pytest.mark.parametrize("arch", EP_ARCHS)
def test_ep_forward_is_reference_local_pass_summed_in_bf16(arch, ranks,
                                                           inputs):
    """Each (data, model) rank's output: the reference's local pass of its
    data shard's rows for each model shard's experts, cast to bf16 and
    summed in model-rank order, cast back (plus the residual)."""
    import jax.numpy as jnp
    from repro.configs import get_smoke as ref_smoke
    from repro.models import lm as ref_lm
    ref_moe = ref_lm.moe_mod
    rcfg = dataclasses.replace(ref_smoke(arch), moe=dataclasses.replace(
        ref_smoke(arch).moe, capacity_factor=EP_CF))
    p = split_params(inputs, arch, to=jnp.asarray)
    x = inputs[arch + "/x"]
    d, e = rcfg.d_model, rcfg.moe.num_experts
    e_loc = e // 2
    residual = None
    if rcfg.moe.dense_residual:      # the port's own, as the ranks add it
        from repro_torch.models.layers import mlp_block
        residual = mlp_block(split_params(inputs, arch)["residual"],
                             torch.from_numpy(x.reshape(-1, d))).numpy()
    want, biggest = [], 0.0
    for di in range(2):
        xb = jnp.asarray(x[2 * di:2 * di + 2].reshape(-1, d))
        parts = [np.asarray(ref_moe._local_expert_pass(
            rcfg, xb, p["w_router"],
            *(p[k][mi * e_loc:(mi + 1) * e_loc]
              for k in ("we_gate", "we_up", "we_down")),
            jnp.int32(mi * e_loc), e)) for mi in range(2)]
        biggest = max(biggest, *(np.abs(q).max() for q in parts))
        acc = _bf16(parts[0])
        for q in parts[1:]:
            acc = acc + _bf16(q)
        out = acc.float().numpy()
        if residual is not None:
            out = out + residual[16 * di:16 * di + 16]
        want.append(out.reshape(2, -1, d))
    want = np.concatenate(want)
    for r in ranks["ep"]:
        got = r[arch]["out"]
        assert (got == want).mean() >= 0.99
        _within_ulp(got, want, biggest)


@pytest.mark.parametrize("arch", EP_ARCHS)
def test_ep_matches_reference_moe_block(arch, ranks, reference):
    """Forward and gradients on 4 gloo ranks against the reference's
    ``moe_block`` (``_moe_shardmap``) on 4 host devices. Every rank holds
    the whole output, the block input's gradient and the router's and
    residual's (summed over data and model once); the experts' gradients
    are each model rank's block, so the model ranks' sum is the whole."""
    ep = ranks["ep"]
    pre = arch + "/"
    out_ref = reference[pre + "out"]
    for r in ep:
        got = r[arch]
        _within_ulp(got["out"], out_ref, np.abs(out_ref).max())
        for k in ["gx", "g/w_router"] + [k[len(pre):] for k in reference
                                         if k.startswith(pre + "g/res/")]:
            want = reference[pre + k]
            np.testing.assert_allclose(got[k], want, rtol=0,
                                       atol=GRAD_REL * np.abs(want).max())
    for k in ("g/we_gate", "g/we_up", "g/we_down"):
        want = reference[pre + k]
        for di in range(2):
            blocks = [r[arch][k] for r in ep if r["coords"][0] == di]
            assert len(blocks) == 2
            np.testing.assert_allclose(blocks[0] + blocks[1], want, rtol=0,
                                       atol=GRAD_REL * np.abs(want).max())


def test_mesh_trainer_takes_ep_and_matches_one_process(ranks):
    opt = AdamWConfig(**OPT)
    tr = Trainer(get_smoke("moonshot-v1-16b-a3b"), opt,
                 LoopConfig(steps=3, log_every=100), batch=4, seq=32,
                 device="cpu")
    one = tr.train()
    pmax = max(float(p.abs().max()) for p in tree_leaves(tr.params))
    bound = sum(2 * float(lr_schedule(opt, t)) * (1 + opt.weight_decay
                                                  * pmax)
                for t in (1, 2, 3))
    for r in ranks["ep"]:
        t = r["trainer"]
        assert t["ep_calls"] > 0
        np.testing.assert_allclose(t["losses"], one["losses"],
                                   rtol=BF16_ULP)
        for g, w in zip(tree_leaves(t["params"]), tree_leaves(tr.params)):
            assert np.abs(g - w.numpy()).max() <= bound
    first = tree_leaves(ranks["ep"][0]["trainer"]["params"])
    for r in ranks["ep"][1:]:
        for a, b in zip(first, tree_leaves(r["trainer"]["params"])):
            assert np.array_equal(a, b)


def test_remat_recompute_keeps_the_forward_context(monkeypatch):
    """With remat on, a block's recompute runs where the backward runs: on
    CUDA the autograd engine's device thread, which does not inherit the
    caller's context variables. Here the backward runs on another thread:
    every MoE call, the forward's and the recompute's, still sees the
    active rules and the token shards."""
    import threading

    from repro_torch.distributed.sharding import current_rules
    from repro_torch.models import lm
    cfg = get_smoke("moonshot-v1-16b-a3b")
    assert cfg.remat
    params = lm.init_params(cfg, seed=0, device="cpu")
    leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9))
                            .astype(np.int64))
    seen = []
    real = moe._local_groups

    def spy(t):
        seen.append((current_rules() is not None,
                     moe._TOKEN_SHARDS.get()))
        return real(t)

    monkeypatch.setattr(moe, "_local_groups", spy)
    with torch.enable_grad():
        with axis_rules({"data": 2, "model": 1}), moe.token_shards(2):
            loss = lm.lm_loss(cfg, params, toks[:, :-1], toks[:, 1:])
        n_forward = len(seen)
        errors = []

        def backward():
            try:
                loss.backward()
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(e)

        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert n_forward == cfg.n_layers and len(seen) == 2 * n_forward
    assert all(s == (True, 2) for s in seen), seen
    assert all(p.grad is not None for p in leaves)
