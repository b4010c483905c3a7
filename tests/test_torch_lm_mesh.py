"""LM training and serving on a ``torch.distributed`` mesh: 4 gloo ranks on
the CPU as a ``(data=2, model=2)`` ``DeviceMesh``, against one process.

* ``Trainer(mesh=...)``, smoke starcoder2-3b, global batch 4, seq 32, 3
  steps: every rank's losses within rtol 1e-5 of the one-rank
  ``Trainer``'s and its gathered parameters within the sign-flip bound of
  ``tests/test_torch_lm_train.py`` (every entry within 2·lr_t·(1 +
  wd·|p|) summed over the steps, 99.9% of each leaf within 1e-6 +
  1e-5·|p|; the gradients are averaged over the data ranks, so their sums
  run in another order); parameters and moments as DTensors whose local
  shards have the shapes their specs imply (role "param" and "opt").
* ``build_cell`` on the same group, qwen3 smoke with ``n_heads=4,
  n_kv_heads=2`` (the reference's multi-device LM cells): a train cell's
  two steps against one process's steps (the same tolerances), and a
  decode cell's logits within 2e-6 of their largest entry of one
  process's serve step (the cell computes on local shards: the
  row-parallel partials are summed over ``model`` in another order) and
  its cache equal to it bit for bit, placed by the cell's output
  shardings.
* ``constrain`` redistributes a DTensor by the active rules.
* A checkpointed mesh run resumes on the mesh with its bits (rank 0
  writes the gathered tree; every rank restores and re-places it).

The ranks run in a subprocess script (spawned ranks import their function
from its ``__main__``) and hand rank 0 everything through
``all_gather_object``."""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import AdamWConfig
from repro_torch.tree import tree_leaves
from tests.conftest import REPO, SRC

OPT = dict(lr=1e-3, total_steps=3, warmup_steps=1)

SCRIPT = textwrap.dedent('''
    import pickle
    import sys

    OPT = __OPT__


    def spec_shape(shape, spec, sizes):
        out = []
        for dim, axes in zip(shape, spec):
            n = 1
            for a in (() if axes is None else
                      (axes,) if isinstance(axes, str) else axes):
                n *= sizes[a]
            out.append(dim // n)
        return tuple(out)


    def local_shapes_ok(tree, shardings, sizes):
        from repro_torch.tree import tree_leaves
        return all(
            tuple(x.to_local().shape) == spec_shape(x.shape, sh.spec, sizes)
            and tuple(x.placements) == sh.placements
            for x, sh in zip(tree_leaves(tree), tree_leaves(shardings)))


    def to_np(tree):
        from repro_torch.launch.steps import gather
        from repro_torch.tree import tree_map
        return tree_map(lambda t: t.detach().cpu().float().numpy(),
                        gather(tree))


    def trainer_part(dm, sizes):
        from repro_torch.configs import get_smoke
        from repro_torch.distributed.sharding import Rules, param_shardings
        from repro_torch.train.loop import LoopConfig, Trainer
        from repro_torch.train.optim import AdamWConfig
        cfg = get_smoke("starcoder2-3b")
        tr = Trainer(cfg, AdamWConfig(**OPT), LoopConfig(steps=3,
                                                         log_every=100),
                     mesh=dm, batch=4, seq=32, device="cpu")
        out = tr.train()
        rules = Rules(dm)
        like = to_np(tr.params)
        return {
            "losses": out["losses"], "final_step": out["final_step"],
            "params": like, "m": to_np(tr.opt_state.m),
            "step": int(tr.opt_state.step),
            "param_shards": local_shapes_ok(
                tr.params, param_shardings(tr.params, rules), sizes),
            "opt_shards": local_shapes_ok(
                tr.opt_state.m, param_shardings(tr.params, rules,
                                                role="opt"), sizes)
            and local_shapes_ok(tr.opt_state.v, param_shardings(
                tr.params, rules, role="opt"), sizes),
            "embed_m_sharded": any(p.is_shard() for p in
                                   tr.opt_state.m["embed"].placements)}


    def resume_part(dm, d):
        """A checkpointed 2-step mesh run (rank 0 writes the gathered
        tree), then a new mesh Trainer on the directory: it restores at
        step 2 with the first run's bits and ends at 3."""
        import numpy as np
        from repro_torch.configs import get_smoke
        from repro_torch.train.loop import LoopConfig, Trainer
        from repro_torch.train.optim import AdamWConfig
        from repro_torch.tree import tree_leaves

        def trainer(steps):
            return Trainer(get_smoke("starcoder2-3b"), AdamWConfig(**OPT),
                           LoopConfig(steps=steps, ckpt_dir=d, ckpt_every=1,
                                      log_every=100),
                           mesh=dm, batch=4, seq=32, device="cpu")

        first = trainer(2)
        first.train()
        second = trainer(3)
        same = all(np.array_equal(a, b) for a, b in zip(
            tree_leaves(to_np({"p": first.params, "o": first.opt_state})),
            tree_leaves(to_np({"p": second.params,
                               "o": second.opt_state}))))
        from torch.distributed.tensor import DTensor
        placed = all(isinstance(x, DTensor) for x in tree_leaves(
            {"p": second.params, "m": second.opt_state.m,
             "v": second.opt_state.v}))
        start = second.start_step
        return {"start": start, "restored_bits": same, "placed": placed,
                "final": second.train()["final_step"]}


    def cell_part(dm, sizes):
        import dataclasses

        import numpy as np
        import torch
        from repro_torch.configs import get_smoke
        from repro_torch.configs.base import SHAPES, InputShape
        from repro_torch.launch.steps import build_cell, gather
        from repro_torch.models import lm
        from repro_torch.train.optim import AdamWConfig, adamw_init
        from repro_torch.tree import tree_leaves
        cfg = dataclasses.replace(get_smoke("qwen3-8b"), n_heads=4,
                                  n_kv_heads=2)
        SHAPES["tiny_train"] = InputShape("tiny_train", 64, 8, "train")
        SHAPES["tiny_decode"] = InputShape("tiny_decode", 64, 8, "decode")
        rng = np.random.default_rng(3)
        out = {}
        cell, args, rules = build_cell(cfg, "tiny_train", dm,
                                       opt=AdamWConfig(**OPT),
                                       param_dtype=torch.float32)
        out["train_meta"] = all(a.device.type == "meta"
                                for a in tree_leaves(args))
        params = lm.init_params(cfg, seed=1, device="cpu")
        state = adamw_init(params)
        losses = []
        for _ in range(2):
            toks = rng.integers(0, cfg.vocab, (8, 65)).astype(np.int32)
            batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                     "labels": torch.from_numpy(toks[:, 1:].copy())}
            params, state, m = cell(params, state, batch)
            losses.append(float(m["loss"]))
        out["train"] = {"losses": losses, "params": to_np(params),
                        "shards": local_shapes_ok(
                            params, cell.in_shardings[0], sizes)}
        cell, args, rules = build_cell(cfg, "tiny_decode", dm,
                                       param_dtype=torch.float32)
        out["serve_fsdp"] = rules.table["fsdp"]
        params = lm.init_params(cfg, seed=2, device="cpu")
        cache = lm.zero_cache(cfg, 8, 64, device="cpu")
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))
                                .astype(np.int32))
        res = cell(params, {"tokens": toks, "cache": cache,
                            "cache_len": torch.tensor(5, dtype=torch.int32)})
        out["decode"] = {
            "logits": to_np(res["logits"]),
            "cache": to_np(res["cache"]),
            "shards": local_shapes_ok(res["cache"],
                                      cell.out_shardings["cache"], sizes)
            and local_shapes_ok(res["logits"],
                                cell.out_shardings["logits"], sizes),
            "logits_placements": [getattr(p, "dim", None)
                                  for p in res["logits"].placements]}
        return out


    def constrain_part(dm):
        import torch
        from repro_torch.distributed.sharding import axis_rules, constrain
        from repro_torch.launch.steps import distribute
        from torch.distributed.tensor import Replicate
        x = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
        d = distribute(x, dm, (Replicate(), Replicate()))
        with axis_rules(dm):
            y = constrain(d, "batch", None, "vocab")
        return ([getattr(p, "dim", None) for p in y.placements],
                tuple(y.to_local().shape),
                bool(torch.equal(y.full_tensor(), x)))


    def rank(mesh, ckpt_dir):
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        torch.set_num_threads(1)
        dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        sizes = {"data": 2, "model": 2}
        mine = {"rank": dist.get_rank(),
                "coords": (dm.get_local_rank("data"),
                           dm.get_local_rank("model")),
                "trainer": trainer_part(dm, sizes),
                "cells": cell_part(dm, sizes),
                "constrain": constrain_part(dm),
                "resume": resume_part(dm, ckpt_dir)}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        return every


    if __name__ == "__main__":
        from repro_torch.launch.mesh import start_ranks
        res = start_ranks(rank, 4, "cpu", sys.argv[2], timeout=240)
        with open(sys.argv[1], "wb") as f:
            pickle.dump(res, f)
''').replace("__OPT__", repr(OPT))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm_mesh")
    script, out = d / "lm_mesh.py", d / "out.pkl"
    script.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, str(script), str(out),
                        str(d / "ckpt")], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-4000:])
    with open(out, "rb") as f:
        return pickle.load(f)


def _flip_bound(opt, n_steps, params):
    from repro_torch.train.optim import lr_schedule
    pmax = max(float(np.abs(x).max()) for x in tree_leaves(params))
    return sum(2 * float(lr_schedule(opt, t)) * (1 + opt.weight_decay * pmax)
               for t in range(1, n_steps + 1))


def _hold(got, want, bound):
    ours, theirs = tree_leaves(got), tree_leaves(want)
    assert len(ours) == len(theirs)
    for g, w in zip(ours, theirs):
        w = w.numpy() if isinstance(w, torch.Tensor) else w
        diff = np.abs(g - w)
        assert diff.max() <= bound, (diff.max(), bound)
        assert (diff <= 1e-6 + 1e-5 * np.abs(w)).mean() >= 0.999


def test_mesh_trainer_equals_one_rank(ranks):
    opt = AdamWConfig(**OPT)
    tr = Trainer(get_smoke("starcoder2-3b"), opt,
                 LoopConfig(steps=3, log_every=100), batch=4, seq=32,
                 device="cpu")
    one = tr.train()
    assert sorted(r["coords"] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    for r in ranks:
        t = r["trainer"]
        assert t["final_step"] == 3 and t["step"] == 3
        np.testing.assert_allclose(t["losses"], one["losses"], rtol=1e-5)
        _hold(t["params"], tr.params, _flip_bound(opt, 3, t["params"]))
        for g, w in zip(tree_leaves(t["m"]), tree_leaves(tr.opt_state.m)):
            np.testing.assert_allclose(g, w.numpy(), atol=1e-6, rtol=0)
    # every rank holds the same parameters after the steps
    first = tree_leaves(ranks[0]["trainer"]["params"])
    for r in ranks[1:]:
        for a, b in zip(first, tree_leaves(r["trainer"]["params"])):
            assert np.array_equal(a, b)


def test_mesh_trainer_shards_have_their_specs_shapes(ranks):
    for r in ranks:
        t = r["trainer"]
        assert t["param_shards"] and t["opt_shards"]
        assert t["embed_m_sharded"]        # ZeRO: the embed's m/v sharded


def test_build_cell_train_runs_on_the_group(ranks):
    """Two train-cell steps on the mesh against one process's steps from
    the same parameters and batches."""
    import dataclasses
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import lm
    from repro_torch.train.optim import adamw_init
    opt = AdamWConfig(**OPT)
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), n_heads=4, n_kv_heads=2)
    params = lm.init_params(cfg, seed=1, device="cpu")
    state = adamw_init(params)
    step = make_train_step(cfg, opt)
    rng = np.random.default_rng(3)
    losses = []
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab, (8, 65)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
                 "labels": torch.from_numpy(toks[:, 1:].copy())}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    for r in ranks:
        c = r["cells"]
        assert c["train_meta"]
        np.testing.assert_allclose(c["train"]["losses"], losses, rtol=1e-5)
        _hold(c["train"]["params"], params,
              _flip_bound(opt, 2, c["train"]["params"]))
        assert c["train"]["shards"]


def test_build_cell_decode_runs_on_the_group(ranks):
    """The decode cell's logits equal one process's serve step within
    2e-6 of their largest entry, and its cache bit for bit, placed by the
    cell's output shardings (logits over ``batch`` and ``vocab``); serving
    replicates parameters over data. The cell computes on local shards:
    each row-parallel product's partials are summed over ``model``, an
    f32 sum in another order than one process's. The gap read on the
    CPU is 4.4e-7 of the largest entry; the limit leaves 4.5 times
    that."""
    import dataclasses
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_smoke("qwen3-8b"), n_heads=4, n_kv_heads=2)
    rng = np.random.default_rng(3)
    for _ in range(2):
        rng.integers(0, cfg.vocab, (8, 65))   # the train part's draws
    params = lm.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))
                            .astype(np.int32))
    want = make_serve_step(cfg)(params, {
        "tokens": toks, "cache": lm.zero_cache(cfg, 8, 64, device="cpu"),
        "cache_len": torch.tensor(5, dtype=torch.int32)})
    for r in ranks:
        c = r["cells"]
        assert c["serve_fsdp"] == (None,)
        d = c["decode"]
        assert d["shards"]
        assert d["logits_placements"] == [0, 1]     # Shard(0), Shard(1)
        np.testing.assert_allclose(
            d["logits"], want["logits"].numpy(), rtol=0,
            atol=2e-6 * float(want["logits"].abs().max()))
        for g, w in zip(tree_leaves(d["cache"]), tree_leaves(want["cache"])):
            assert np.array_equal(g, w.float().numpy())


def test_constrain_redistributes_a_dtensor(ranks):
    for r in ranks:
        place, local, same = r["constrain"]
        assert place == [0, 2]                      # Shard(0), Shard(2)
        assert local == (2, 6, 4) and same


def test_mesh_trainer_resumes_from_its_checkpoint(ranks):
    for r in ranks:
        res = r["resume"]
        assert res["start"] == 2 and res["final"] == 3
        assert res["restored_bits"] and res["placed"]
