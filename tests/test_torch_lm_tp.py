"""Tensor-parallel compute of the LM substrate on a ``torch.distributed``
mesh (``repro_torch.launch.steps`` computing on local shards) against one
process, the reference's cells and the dry-run's count.

One module-scoped spawn of 4 gloo ranks holds two ``DeviceMesh``es,
``(data=2, model=2)`` and ``(data=1, model=4)``. On each, for smoke
qwen3-8b (4 heads, 2 KV heads: local KV heads at model=2, the sequence
split over ``model`` at model=4), mamba2-1.3b (the gated norm's sum of
squares over ``model``, the conv window's relayout), moonshot-v1-16b-a3b
(tensor-parallel attention beside expert parallelism) and
jamba-1.5-large-398b (hybrid), f32, ``build_cell``'s train, prefill and
decode cells run against one process's steps on the same parameters and
batches:

* **train**: one step; the loss within rtol 1e-5, the first moments
  (after one step ``(1 - b1)`` times the clipped gradient) within 1e-5 of
  each leaf's largest entry, and every parameter within the sign-flip
  bound of ``tests/test_torch_lm_train.py`` (2·lr·(1 + wd·max|p|)), 99.9%
  of each leaf within 1e-6 + 1e-5·|p|. Those are the f32 tolerance of a
  sum over ``model`` in another order, as far as Adam's first update lets
  it show (it moves each entry by ±lr whatever the gradient's size, so a
  gradient entry near float noise may flip its sign: the moments carry
  the check).
* **prefill and decode**: logits within 1e-5 of their largest entry (an
  f32 sum reordered over ``model``); each cache DTensor's local shard has
  the shape of the reference's spec (its ``cache_shardings`` on a
  stand-in mesh), its placements follow it, and its values are one
  process's cache sliced by them, a bf16 leaf within one bf16 step of
  itself plus 1e-5 of the leaf's largest entry (the ``_hold_cache`` bound
  of ``tests/test_torch_lm_train.py``), an f32 leaf within 1e-5 of its
  largest. The decode cell starts from one process's prefill cache.
  Readings on the CPU: gradients within 2.1e-6 of their leaf's largest
  entry, logits within 5.3e-7 of theirs, caches within 1.7e-6 past the
  bf16 step.
* The MoE archs' expert-parallel sums round to bf16 in every MoE layer,
  as the reference's, so one process runs their blocks with that
  arithmetic (each data shard's rows one group, each model rank's experts'
  partial cast to bf16 and summed in rank order; ``ep_emulated``). A
  partial whose f32 value differs in its last bits (the reordered sums
  upstream) may still round to its bf16 neighbour, one bf16 step (2^-7 of
  the entry) away, and so may the output's gradient, which the cast's
  backward rounds too. So their gradients are held within one bf16 step
  of each leaf's largest entry (2^-7), their logits and caches within
  half of one (2^-9) of the largest entry, their loss within rtol 1e-4.
  Readings on the CPU: gradients 9.7e-4 to 2.9e-3 of the leaf's largest
  entry, logits up to 3.9e-4 and caches up to 4.9e-4 (jamba; moonshot's
  within 4.2e-7), the loss within 3.5e-6. With the bf16 cast taken out of
  both sides (a mutation check on a copy of the code) the same cells read
  gradients within 4.7e-6, logits within 2.3e-6 and caches within 2.7e-6:
  the f32 bounds above hold, so the gap is those roundings.
* **a spy** on the steps' relayouts: no parameter leaf that the rules
  shard over ``model`` along ``heads``, ``kv_heads``, ``ff``, ``inner`` or
  ``experts`` is gathered over ``model`` in any cell; a mixer whose heads
  do not split with its channels raises rather than gathers.

Against the reference: smoke qwen3's and mamba2's prefill and decode
logits of the (data=2, model=2) cells equal the reference's
``build_cell`` cells on 4 forced host devices (a subprocess; Auto axes,
f32 parameters) within atol 1e-5 / rtol 1e-4, the decode cell of both
packages starting from one process's prefill cache; one step of smoke
qwen3's train cell equals the reference's (loss, moments, parameters;
``test_qwen3_train_cell_matches_the_reference``). That subprocess and
the dry-run's run while the ranks do.

The dry-run: on a fake process group, the counted FLOPs per rank of
smoke qwen3's train cell (4 KV heads) at (data=2, model=2) are half those
at (data=2, model=1), and at (data=1, model=4), twice the rows on a
quarter of each product, half those too: every matmul-class product of
the dense cut runs on its shard.
"""
import inspect
import json
import os
import pickle
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_smoke as ref_get_smoke
from repro.distributed import sharding as ref_sharding
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke
from repro_torch.models import lm
from repro_torch.train.optim import AdamWConfig, lr_schedule
from tests.conftest import REPO, SRC

ARCHS = ("qwen3-8b", "mamba2-1.3b", "moonshot-v1-16b-a3b",
         "jamba-1.5-large-398b")
MESHES = ((2, 2), (1, 4))
REF_ARCHS = ("qwen3-8b", "mamba2-1.3b")   # against the reference's cells
OPT = dict(lr=1e-3, total_steps=3, warmup_steps=1)
B, S = 4, 16
F32_REL = 1e-5                  # a reordered f32 sum, of the largest entry
LOSS_RTOL = 1e-5
BF16_STEP = 2 ** -7
BF16_EPS = 2 ** -8
MOE_LOSS_RTOL = 1e-4            # the MoE archs (module docstring)
MOE_GRAD_REL = BF16_STEP
MOE_REL = 2 ** -9

NEST = '''
def nest(z, prefix):
    """The parameter tree of the flat ``prefix + path`` arrays of ``z``
    (``blocks`` a tuple)."""
    tree = {}
    for key, val in z.items():
        if not key.startswith(prefix):
            continue
        *up, leaf = key[len(prefix):].split("/")
        node = tree
        for k in up:
            node = node.setdefault(k, {})
        node[leaf] = val
    tree["blocks"] = tuple(tree["blocks"][str(i)]
                           for i in range(len(tree["blocks"])))
    return tree
'''

def flat(tree, prefix=""):
    """The leaves of ``tree`` (dicts, tuples) as numpy arrays keyed by
    ``prefix + path``."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/"))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(flat(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


FLAT = "\n" + inspect.getsource(flat)

SCRIPT = (textwrap.dedent('''
    import pickle
    import sys

    import numpy as np

    ARCHS = __ARCHS__
    REF_ARCHS = __REF_ARCHS__
    MESHES = __MESHES__
    OPT = __OPT__
    B, S = __B__, __S__
''') + NEST + textwrap.dedent('''

    def spy(record):
        """Wrap the steps' relayout: every call that gathers a TP leaf
        (``TP_AXES`` over ``model``) over ``model`` is recorded."""
        from repro_torch.distributed.sharding import (TP_AXES,
                                                      _leaf_logical_axes)
        from repro_torch.launch import steps
        from repro_torch.tree import tree_map_with_path
        real_gau, real_red = steps.gather_at_use, steps._redistribute
        real_call = steps.Cell.__call__
        paths = {}

        def call(self, *args):
            paths.clear()
            try:
                return real_call(self, *args)
            finally:
                paths.clear()

        def gau(params):
            tree_map_with_path(
                lambda path, x: paths.__setitem__(id(x), (path, x)), params)
            return real_gau(params)

        def red(x, like, src, dst):
            if id(like) in paths:
                path = paths[id(like)][0]
                names = like.device_mesh.mesh_dim_names
                i = names.index("model")
                logical = _leaf_logical_axes(path, like.ndim)
                if src[i].is_shard() and logical[src[i].dim] in TP_AXES:
                    record["tp_leaves"].add(path)
                    if not dst[i].is_shard(src[i].dim):
                        record["gathered"].append(path)
            return real_red(x, like, src, dst)

        steps.gather_at_use, steps._redistribute = gau, red
        steps.Cell.__call__ = call


    def ep_emulated(m, n_data):
        """One process's ``moe_block`` with the expert-parallel path's
        arithmetic on ``m`` model ranks and ``n_data`` data shards: each
        shard's rows routed as one group, each model rank's experts'
        partial output cast to bf16, summed in rank order, cast back."""
        import torch
        from repro_torch.models import moe
        from repro_torch.models.layers import mlp_block

        def block(cfg, p, x):
            b, s, d = x.shape
            e = cfg.moe.num_experts
            k = e // m
            outs = []
            for rows in x.chunk(n_data, 0):
                xf = rows.reshape(-1, d)
                acc = None
                for mi in range(m):
                    part = moe._local_expert_pass(
                        cfg, xf, p["w_router"],
                        *(p[w][mi * k:(mi + 1) * k]
                          for w in ("we_gate", "we_up", "we_down")),
                        mi * k, e).to(torch.bfloat16)
                    acc = part if acc is None else acc + part
                outs.append(acc.reshape(rows.shape).to(x.dtype))
            out = torch.cat(outs)
            if cfg.moe.dense_residual:
                out = out + mlp_block(p["residual"], x, cfg.bf16_reduce)
            return out
        return block


    class one_process:
        """One process's steps; a MoE arch's blocks take the mesh's
        expert-parallel arithmetic (``ep_emulated``)."""

        def __init__(self, cfg, dm):
            self.on = cfg.moe is not None
            self.fn = ep_emulated(dm.size(1), dm.size(0))

        def __enter__(self):
            from repro_torch.models import moe
            self.real = moe.moe_block
            if self.on:
                moe.moe_block = self.fn

        def __exit__(self, *exc):
            from repro_torch.models import moe
            moe.moe_block = self.real


    def np32(t):
        return t.detach().float().cpu().numpy()


    def gap(got, want):
        """The largest entry of ``|got - want|`` and of ``|want|``."""
        d = (got.float() - want.float()).abs()
        return (float(d.max()), float(want.abs().max())) if d.numel() else (
            0.0, 0.0)


    def leaf_report(got, want, mesh):
        """A cache DTensor against one process's leaf: its local shape and
        placements, and its distance to the leaf sliced by them (for a
        bf16 leaf, past one bf16 step of the entry)."""
        import torch
        from repro_torch.launch.steps import distribute
        mine = distribute(want, mesh, got.placements).to_local()
        w = mine.float()
        return {"local": tuple(got.to_local().shape),
                "global": tuple(got.shape),
                "dtype": str(got.dtype),
                "placements": [getattr(p, "dim", None)
                               for p in got.placements],
                "excess": float(((got.to_local().float() - w).abs()
                                 - BF16_STEP * (1 + BF16_STEP) * w.abs())
                                .max()) if got.dtype == __BF16__ else
                float((got.to_local().float() - w).abs().max()),
                "max": float(w.abs().max()) if w.numel() else 0.0}


    def arch_part(dm, arch, z):
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import SHAPES, InputShape
        from repro_torch.launch.steps import (build_cell, gather,
                                              make_prefill_step,
                                              make_serve_step,
                                              make_train_step)
        from repro_torch.models import lm
        from repro_torch.train.optim import AdamWConfig, adamw_init
        from repro_torch.tree import tree_leaves
        cfg = get_smoke(arch)
        opt = AdamWConfig(**OPT)
        SHAPES["tp_train"] = InputShape("tp_train", S, B, "train")
        SHAPES["tp_prefill"] = InputShape("tp_prefill", S, B, "prefill")
        SHAPES["tp_decode"] = InputShape("tp_decode", S, B, "decode")
        out = {}

        # train: one step of the cell against one process's step
        batch = {"tokens": torch.from_numpy(z["train"][:, :-1].copy()),
                 "labels": torch.from_numpy(z["train"][:, 1:].copy())}
        cell, _, _ = build_cell(cfg, "tp_train", dm, opt=opt,
                                param_dtype=torch.float32)
        p = lm.init_params(cfg, seed=1, device="cpu")
        p, st, m = cell(p, adamw_init(p), batch)
        one = lm.init_params(cfg, seed=1, device="cpu")
        with one_process(cfg, dm):
            one, one_st, one_m = make_train_step(cfg, opt)(
                one, adamw_init(one), batch)
        diffs, tight = [], []
        for g, w in zip(tree_leaves(gather(p)), tree_leaves(one)):
            d = (g - w).abs()
            diffs.append(float(d.max()))
            tight.append(float((d <= 1e-6 + 1e-5 * w.abs()).float()
                               .mean()))
        out["train"] = {"loss": float(m["loss"]),
                        "one_loss": float(one_m["loss"]),
                        "max_abs": max(diffs), "tight": min(tight),
                        "pmax": max(float(w.abs().max())
                                    for w in tree_leaves(one)),
                        "grad": [gap(g, w) for g, w in zip(
                            tree_leaves(gather(st.m)),
                            tree_leaves(one_st.m))]}

        # prefill, then decode from one process's prefill cache
        params = lm.init_params(cfg, seed=2, device="cpu")
        toks = torch.from_numpy(z["prefill"])
        cell, _, _ = build_cell(cfg, "tp_prefill", dm,
                                param_dtype=torch.float32)
        pre = cell(params, {"tokens": toks})
        with one_process(cfg, dm):
            want = make_prefill_step(cfg)(params, {"tokens": toks})
        out["prefill"] = {
            "logits": np32(gather(pre["logits"])),
            "want": np32(want["logits"]),
            "cache": [leaf_report(g, w, dm) for g, w in
                      zip(tree_leaves(pre["cache"]),
                          tree_leaves(want["cache"]))]}
        dtoks = torch.from_numpy(z["decode"])
        clen = torch.tensor(S - 1, dtype=torch.int32)
        cell, _, _ = build_cell(cfg, "tp_decode", dm,
                                param_dtype=torch.float32)
        dec = cell(params, {"tokens": dtoks, "cache": want["cache"],
                            "cache_len": clen})
        with one_process(cfg, dm):
            wd = make_serve_step(cfg)(params, {"tokens": dtoks,
                                               "cache": want["cache"],
                                               "cache_len": clen})
        out["decode"] = {
            "logits": np32(gather(dec["logits"])), "want": np32(wd["logits"]),
            "placements": [getattr(q, "dim", None)
                           for q in dec["logits"].placements],
            "cache": [leaf_report(g, w, dm) for g, w in
                      zip(tree_leaves(dec["cache"]),
                          tree_leaves(wd["cache"]))]}
        return out


    def reference_part(dm, z):
        """Smoke qwen3's and mamba2's prefill cells and their decode cells
        from one process's prefill cache, and one train step of smoke
        qwen3, on the parameters the reference's cells take."""
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.launch.steps import build_cell, gather
        from repro_torch.train.optim import AdamWConfig, adamw_init
        from repro_torch.tree import tree_map

        def params_of(pre):
            return tree_map(lambda a: torch.from_numpy(a.copy()),
                            nest(z, pre + "p/"))

        def leaf(a):
            if a.dtype == np.uint16:         # bf16 bits
                return torch.from_numpy(a.view("int16").copy()).view(
                    torch.bfloat16)
            return torch.from_numpy(a.copy())

        out = {}
        for arch in REF_ARCHS:
            pre = arch + "/"
            cfg = get_smoke(arch)
            params = params_of(pre)
            n = len({k.split("/")[2] for k in z if k.startswith(pre + "c/")})
            cache = tuple({k.rsplit("/", 1)[1]: leaf(v) for k, v in z.items()
                           if k.startswith(f"{pre}c/{i}/")}
                          for i in range(n))
            cell, _, _ = build_cell(cfg, "tp_prefill", dm,
                                    param_dtype=torch.float32)
            pre_out = cell(params, {"tokens": torch.from_numpy(z[pre + "toks"])})
            cell, _, _ = build_cell(cfg, "tp_decode", dm,
                                    param_dtype=torch.float32)
            dec = cell(params, {"tokens": torch.from_numpy(z[pre + "dec"]),
                                "cache": cache,
                                "cache_len": torch.tensor(S - 1,
                                                          dtype=torch.int32)})
            out[pre + "prefill"] = np32(gather(pre_out["logits"]))
            out[pre + "decode"] = np32(gather(dec["logits"]))
        cfg = get_smoke("qwen3-8b")
        params = params_of("qwen3-8b/")
        train = z["qwen3-8b/train"]
        cell, _, _ = build_cell(cfg, "tp_train", dm, opt=AdamWConfig(**OPT),
                                param_dtype=torch.float32)
        p, st, m = cell(params, adamw_init(params),
                        {"tokens": torch.from_numpy(train[:, :-1].copy()),
                         "labels": torch.from_numpy(train[:, 1:].copy())})
        out["train"] = {"loss": float(m["loss"]),
                        "p": tree_map(np32, gather(p)),
                        "m": tree_map(np32, gather(st.m))}
        return out


    def uneven_part(dm, z):
        """A mixer whose 2 heads do not split over 4 model ranks with its
        128 channels: its cell raises."""
        import dataclasses
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.launch.steps import build_cell
        from repro_torch.models import lm
        cfg = get_smoke("mamba2-1.3b")
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, head_dim=64))
        cell, _, _ = build_cell(cfg, "tp_prefill", dm,
                                param_dtype=torch.float32)
        try:
            cell(lm.init_params(cfg, seed=1, device="cpu"),
                 {"tokens": torch.from_numpy(z["prefill"])})
        except ValueError as e:
            return str(e)
        return None


    def rank(mesh, z):
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        torch.set_num_threads(1)
        inputs = {a: {k.split("/", 1)[1]: v for k, v in z.items()
                      if k.startswith(a + "/")} for a in ARCHS}
        ref = {k[4:]: v for k, v in z.items() if k.startswith("ref/")}
        record = {"tp_leaves": set(), "gathered": []}
        spy(record)
        mine = {"rank": dist.get_rank()}
        for shape in MESHES:
            dm = init_device_mesh("cpu", shape,
                                  mesh_dim_names=("data", "model"))
            res = {"coords": (dm.get_local_rank("data"),
                              dm.get_local_rank("model"))}
            for arch in ARCHS:
                res[arch] = arch_part(dm, arch, inputs[arch])
            if shape == (2, 2):
                res["reference"] = reference_part(dm, ref)
            else:
                res["uneven"] = uneven_part(dm, inputs["mamba2-1.3b"])
            mine[shape] = res
        mine["tp_leaves"] = sorted(record["tp_leaves"])
        mine["gathered"] = record["gathered"]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        return every


    if __name__ == "__main__":
        import numpy as np
        from repro_torch.launch.mesh import start_ranks
        z = dict(np.load(sys.argv[2]))
        res = start_ranks(rank, 4, "cpu", z, timeout=300)
        with open(sys.argv[1], "wb") as f:
            pickle.dump(res, f)
''')).replace("__ARCHS__", repr(ARCHS)).replace(
    "__MESHES__", repr(MESHES)).replace("__REF_ARCHS__", repr(REF_ARCHS)).replace("__OPT__", repr(OPT)).replace(
    "__B__", repr(B)).replace("__S__", repr(S)).replace(
    "__BF16__", "torch.bfloat16").replace(
    "BF16_STEP", repr(BF16_STEP))

REFERENCE = textwrap.dedent('''
    import sys

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType

    from repro.configs import get_smoke
    from repro.configs.base import SHAPES, InputShape
    from repro.launch.steps import build_cell
    from repro.train.optim import AdamWConfig, adamw_init
''') + NEST + FLAT + textwrap.dedent('''
    assert jax.device_count() == 4
    S, B = __S__, __B__
    z = dict(np.load(sys.argv[1]))
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    SHAPES["tp_train"] = InputShape("tp_train", S, B, "train")
    SHAPES["tp_prefill"] = InputShape("tp_prefill", S, B, "prefill")
    SHAPES["tp_decode"] = InputShape("tp_decode", S, B, "decode")

    def leaf(a):
        return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                           else a)

    out = {}
    for arch in __REF_ARCHS__:
        pre = arch + "/"
        cfg = get_smoke(arch)
        params = jax.tree.map(jnp.asarray, nest(z, pre + "p/"))
        jit, _, _ = build_cell(cfg, "tp_prefill", mesh,
                               param_dtype=jnp.float32)
        out[pre + "prefill"] = np.asarray(
            jit(params, {"tokens": jnp.asarray(z[pre + "toks"])})["logits"])
        n = len({k.split("/")[2] for k in z if k.startswith(pre + "c/")})
        cache = tuple({k.rsplit("/", 1)[1]: leaf(v) for k, v in z.items()
                       if k.startswith(f"{pre}c/{i}/")} for i in range(n))
        jit, _, _ = build_cell(cfg, "tp_decode", mesh,
                               param_dtype=jnp.float32)
        out[pre + "decode"] = np.asarray(
            jit(params, {"tokens": jnp.asarray(z[pre + "dec"]),
                         "cache": cache,
                         "cache_len": jnp.int32(S - 1)})["logits"])
    cfg = get_smoke("qwen3-8b")
    params = jax.tree.map(jnp.asarray, nest(z, "qwen3-8b/p/"))
    train = z["qwen3-8b/train"]
    jit, _, _ = build_cell(cfg, "tp_train", mesh, opt=AdamWConfig(**__OPT__),
                           param_dtype=jnp.float32)
    p, st, m = jit(params, adamw_init(params),
                   {"tokens": jnp.asarray(train[:, :-1]),
                    "labels": jnp.asarray(train[:, 1:])})
    out["train/loss"] = np.asarray(m["loss"])
    out.update(flat(p, "train/p/"))
    out.update(flat(st.m, "train/m/"))
    np.savez(sys.argv[2], **out)
    print("OK")
''').replace("__S__", repr(S)).replace("__B__", repr(B)).replace(
    "__REF_ARCHS__", repr(REF_ARCHS)).replace("__OPT__", repr(OPT))

PORT_DRYRUN = """
    import dataclasses
    import json

    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import SHAPES, InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch.roofline import analyze, counting

    SHAPES["tp_train"] = InputShape("tp_train", 8, 4, "train")
    # 4 KV heads: every product of the dense cut splits over model=4 too
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), n_kv_heads=4)
    out = {}
    for shape in ((2, 1), (2, 2), (1, 4)):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=shape[0] * shape[1])
        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        cell, args = dryrun._build(cfg, "tp_train", mesh, "float32", 1, 3,
                                   None)
        with FakeTensorMode():
            placed = dryrun._placed_args(cell, args, SHAPES["tp_train"])
            with counting() as count:
                cell(*placed)
        out[repr(shape)] = analyze(count).flops
    print("JSON" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks, the reference's cells and the dry-run counts: the two
    subprocesses run while the ranks do. The decode cells of both
    packages start from one process's prefill cache of the port."""
    rng = np.random.default_rng(11)
    z = {}
    for arch in ARCHS:
        v = get_smoke(arch).vocab
        z[arch + "/train"] = rng.integers(0, v, (B, S + 1)).astype(np.int32)
        z[arch + "/prefill"] = rng.integers(0, v, (B, S)).astype(np.int32)
        z[arch + "/decode"] = rng.integers(0, v, (B, 1)).astype(np.int32)
    ref = {}
    for arch in REF_ARCHS:
        cfg = get_smoke(arch)
        params = lm.init_params(cfg, seed=5, device="cpu")
        ref.update(flat(params, arch + "/p/"))
        toks = ref[arch + "/toks"] = z[arch + "/prefill"]
        ref[arch + "/dec"] = z[arch + "/decode"]
        _, cache, _ = lm.prefill(cfg, params, torch.from_numpy(toks))
        for i, blk in enumerate(cache):
            for k, v in blk.items():
                ref[f"{arch}/c/{i}/{k}"] = (
                    v.view(torch.int16).numpy().view(np.uint16)
                    if v.dtype == torch.bfloat16 else v.numpy())
    ref["qwen3-8b/train"] = z["qwen3-8b/train"]
    z.update({"ref/" + k: v for k, v in ref.items()})

    d = tmp_path_factory.mktemp("lm_tp")
    np.savez(d / "ref_in.npz", **ref)
    np.savez(d / "in.npz", **z)
    (d / "lm_tp.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC)
    ref_env = dict(env, XLA_FLAGS=(env.get("XLA_FLAGS", "") + " --xla_force"
                                   "_host_platform_device_count=4"))
    ref_code = (REFERENCE.replace("sys.argv[1]", repr(str(d / "ref_in.npz")))
                .replace("sys.argv[2]", repr(str(d / "ref_out.npz"))))
    side = {name: subprocess.Popen(
        [sys.executable, "-c", code], env=e, cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, code, e in (("reference", ref_code, ref_env),
                              ("dryrun", textwrap.dedent(PORT_DRYRUN),
                               env))}
    try:
        r = subprocess.run([sys.executable, str(d / "lm_tp.py"),
                            str(d / "out.pkl"), str(d / "in.npz")],
                           cwd=REPO, env=env, capture_output=True,
                           text=True, timeout=400)
        assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
        outs = {name: p.communicate(timeout=400)
                for name, p in side.items()}
    finally:
        for p in side.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in side.items():
        assert p.returncode == 0, (name, outs[name][1][-3000:])
    with open(d / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    line = [ln for ln in outs["dryrun"][0].splitlines()
            if ln.startswith("JSON")][-1]
    return {"ranks": ranks, "reference": dict(np.load(d / "ref_out.npz")),
            "dryrun": json.loads(line[4:])}


@pytest.fixture(scope="module")
def ranks(runs):
    return runs["ranks"]


def _n_moe(cfg) -> int:
    if cfg.moe is None:
        return 0
    return sum(1 for i in range(cfg.n_layers) if i % cfg.moe_every == 0)


def _rel(arch) -> float:
    """Of the largest entry: an f32 sum reordered over ``model``, or for a
    MoE arch the expert-parallel bf16 sums (module docstring)."""
    return F32_REL if _n_moe(get_smoke(arch)) == 0 else MOE_REL


class _SpecRules(ref_sharding.Rules):
    """The reference's rules, answering specs instead of NamedShardings."""

    def sharding(self, logical_axes, shape, allow_uneven=True):
        return self.spec(logical_axes, shape, allow_uneven)


def _ref_local_shapes(arch, shape, max_len):
    """Each cache leaf's local shape by the reference's spec on a
    stand-in mesh of ``shape``."""
    sizes = {"data": shape[0], "model": shape[1]}
    rules = _SpecRules(types.SimpleNamespace(shape=sizes))
    specs = jax.tree.leaves(
        ref_lm.cache_shardings(ref_get_smoke(arch), rules, B, max_len),
        is_leaf=lambda x: isinstance(x, P))
    leaves = jax.tree.leaves(ref_lm.init_cache(ref_get_smoke(arch), B,
                                               max_len))
    out = []
    for spec, leaf in zip(specs, leaves):
        local = []
        for dim, axes in zip(leaf.shape, tuple(spec) + (None,) * leaf.ndim):
            n = 1
            for a in (() if axes is None else
                      (axes,) if isinstance(axes, str) else axes):
                n *= sizes[a]
            local.append(dim // n)
        out.append((tuple(local), tuple(spec)))
    return out


def _cases():
    return [(a, s) for s in MESHES for a in ARCHS]


@pytest.mark.parametrize("arch,shape", _cases())
def test_train_step_matches_one_process(ranks, arch, shape):
    opt = AdamWConfig(**OPT)
    moe = _n_moe(get_smoke(arch)) > 0
    grad_rel = MOE_GRAD_REL if moe else F32_REL
    for r in ranks:
        t = r[shape][arch]["train"]
        np.testing.assert_allclose(t["loss"], t["one_loss"],
                                   rtol=MOE_LOSS_RTOL if moe else LOSS_RTOL)
        for i, (d, scale) in enumerate(t["grad"]):
            assert d <= grad_rel * scale, (i, d, scale)
        bound = 2 * float(lr_schedule(opt, 1)) * (
            1 + opt.weight_decay * t["pmax"])
        assert t["max_abs"] <= bound, (t["max_abs"], bound)
        if not moe:
            assert t["tight"] >= 0.999, t["tight"]


@pytest.mark.parametrize("arch,shape", _cases())
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_prefill_and_decode_match_one_process(ranks, arch, shape, kind):
    rel = _rel(arch)
    for r in ranks:
        o = r[shape][arch][kind]
        scale = float(np.abs(o["want"]).max())
        np.testing.assert_allclose(o["logits"], o["want"], rtol=0,
                                   atol=rel * scale)
        for leaf in o["cache"]:
            if leaf["dtype"] == "torch.bfloat16":
                allowed = 1e-6 + max(F32_REL * (1 + BF16_EPS),
                                     rel) * leaf["max"]
            else:
                allowed = max(F32_REL, rel) * leaf["max"]
            assert leaf["excess"] <= allowed, (arch, shape, kind, leaf)
    if kind == "decode":
        for r in ranks:                 # logits over (batch, vocab)
            want = [0 if shape[0] > 1 else None, 1]
            assert r[shape][arch]["decode"]["placements"] == want


@pytest.mark.parametrize("arch,shape", _cases())
def test_cache_shards_have_the_reference_spec_shapes(ranks, arch, shape):
    for kind, max_len in (("prefill", S), ("decode", S)):
        want = _ref_local_shapes(arch, shape, max_len)
        for r in ranks:
            got = r[shape][arch][kind]["cache"]
            assert len(got) == len(want)
            for g, (local, spec) in zip(got, want):
                assert g["local"] == local, (arch, kind, g, spec)
                follow = []
                for name in ("data", "model"):
                    dims = [d for d, axes in enumerate(spec)
                            if name == axes or (isinstance(axes, tuple)
                                                and name in axes)]
                    follow.append(dims[0] if dims else None)
                assert g["placements"] == follow, (arch, kind, g, spec)


def test_model_sharded_leaves_are_never_gathered_over_model(ranks):
    """The spy saw the TP leaves of every arch (attention, MLP, Mamba2
    projections, experts) and none gathered over ``model``."""
    for r in ranks:
        assert r["gathered"] == []
        names = {p.split("/")[-1] for p in r["tp_leaves"]}
        assert {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_x",
                "w_z", "w_out", "we_gate", "we_up", "we_down"} <= names


def test_a_mixer_that_cannot_split_raises(ranks):
    for r in ranks:
        msg = r[(1, 4)]["uneven"]
        assert msg is not None and "do not split" in msg


def test_ranks_are_the_meshes_coordinates(ranks):
    for shape in MESHES:
        coords = sorted(r[shape]["coords"] for r in ranks)
        assert coords == sorted((d, m) for d in range(shape[0])
                                for m in range(shape[1]))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_qwen3_cells_match_the_reference(runs, kind):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[(2, 2)]["reference"]["qwen3-8b/" + kind],
                                   runs["reference"]["qwen3-8b/" + kind],
                                   atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_mamba2_cells_match_the_reference(runs, kind):
    for r in runs["ranks"]:
        np.testing.assert_allclose(
            r[(2, 2)]["reference"]["mamba2-1.3b/" + kind],
            runs["reference"]["mamba2-1.3b/" + kind], atol=1e-5, rtol=1e-4)


def test_qwen3_train_cell_matches_the_reference(runs):
    """One step of the (data=2, model=2) train cell against the
    reference's on 4 host devices, as ``tests/test_torch_lm_train.py``
    holds one process to the reference: the loss within rtol 1e-5, the
    first moments (the clipped gradients) within atol 1e-6, the
    parameters within the sign-flip bound and 99.9% of each leaf within
    1e-6 + 1e-5·|p|."""
    ref = runs["reference"]
    opt = AdamWConfig(**OPT)
    for r in runs["ranks"]:
        t = r[(2, 2)]["reference"]["train"]
        np.testing.assert_allclose(t["loss"], ref["train/loss"],
                                   rtol=LOSS_RTOL)
        moments = flat(t["m"], "train/m/")
        assert moments.keys() == {k for k in ref if k.startswith("train/m/")}
        for k, v in moments.items():
            np.testing.assert_allclose(v, ref[k], atol=1e-6, rtol=0,
                                       err_msg=k)
        params = flat(t["p"], "train/p/")
        pmax = max(float(np.abs(ref[k]).max()) for k in params)
        bound = 2 * float(lr_schedule(opt, 1)) * (
            1 + opt.weight_decay * pmax)
        for k, v in params.items():
            d = np.abs(v - ref[k])
            assert d.max() <= bound, (k, d.max(), bound)
            assert (d <= 1e-6 + 1e-5 * np.abs(ref[k])).mean() >= 0.999, k


def test_dryrun_flops_fall_by_the_model_share(runs):
    f = runs["dryrun"]
    assert f["(2, 2)"] > 0 and f["(1, 4)"] > 0
    assert f["(2, 2)"] == f["(2, 1)"] / 2
    # twice the rows of (data=2, model=1), a quarter of every product
    assert f["(1, 4)"] == f["(2, 1)"] / 2
