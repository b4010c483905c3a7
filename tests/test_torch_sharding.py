"""The port's logical-axis sharding rules
(``repro_torch.distributed.sharding``), ``cache_shardings`` and
``make_production_mesh`` against the reference's on the CPU.

The oracle is the reference's ``Rules`` on a stand-in mesh that has only
``.shape`` (a name→size dict), through a subclass whose ``sharding``
returns ``self.spec(...)``: the reference's resolution without a jax mesh
of 256 or 512 devices. Specs are compared exactly (tuples of ``None``, a
mesh axis name, or a tuple of names), and every placed leaf must divide
evenly. The production meshes are built on torch's fake process-group
backend (one process standing for 256 or 512 ranks) in a subprocess."""
import functools
import types

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import get_arch as ref_get_arch
from repro.configs import list_archs
from repro.distributed import sharding as ref_sharding
from repro.models import lm as ref_lm
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (Rules, param_shardings,
                                              placements)
from repro_torch.models import lm
from repro_torch.tree import tree_leaves, tree_map_with_path
from tests.conftest import run_subprocess

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


class _SpecRules(ref_sharding.Rules):
    """The reference's rules, answering specs instead of NamedShardings."""

    def sharding(self, logical_axes, shape, allow_uneven=True):
        return self.spec(logical_axes, shape, allow_uneven)


def _oracle(multi_pod, overrides=None):
    mesh = types.SimpleNamespace(shape=dict(MESHES[multi_pod]))
    return _SpecRules(mesh, overrides)


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return ref_lm.abstract_params(ref_get_arch(arch))


def _ref_specs(tree):
    """``(path, spec)`` of the oracle's spec tree, in jax's leaf order."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(ref_sharding._path_str(path), tuple(spec))
            for path, spec in flat]


def _divides(shape, spec, sizes):
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        n = 1
        for a in ((axes,) if isinstance(axes, str) else axes):
            n *= sizes[a]
        if dim % n:
            return False
    return True


def _placements_follow(spec, place, sizes):
    """Each mesh dim's placement is Shard(d) exactly where tensor dim d's
    spec entry names it."""
    for name, pl in zip(sizes, place):
        owners = [d for d, axes in enumerate(spec) if axes is not None and
                  name in ((axes,) if isinstance(axes, str) else axes)]
        if owners:
            if not (pl.is_shard() and pl.dim == owners[0]):
                return False
        elif not pl.is_replicate():
            return False
    return True


@pytest.mark.parametrize("role", ["param", "opt"])
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch, multi_pod, role):
    """Every leaf of every arch's full config on both production meshes
    and for both roles: the same path and spec as the reference's rules,
    an even split, and placements that follow the spec."""
    sizes = MESHES[multi_pod]
    want = _ref_specs(ref_sharding.param_shardings(
        _ref_abstract(arch), _oracle(multi_pod), role=role))
    p_abs = lm.abstract_params(get_arch(arch))
    got = param_shardings(p_abs, Rules(sizes), role=role)
    paths = []
    tree_map_with_path(lambda path, x: paths.append(path), p_abs)
    shards = tree_leaves(got)
    assert [p for p, _ in want] == paths
    assert [s for _, s in want] == [sh.spec for sh in shards]
    for leaf, sh in zip(tree_leaves(p_abs), shards):
        assert _divides(leaf.shape, sh.spec, sizes), (arch, leaf.shape,
                                                      sh.spec)
        assert _placements_follow(sh.spec, sh.placements, sizes)
    if role == "opt":
        emb = got["embed"].spec
        assert emb != (None, None) and emb == dict(want)["embed"]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_cache_shardings_equal_the_reference(arch, multi_pod):
    """The decode cache's specs at a serving shape, at batch 1 (sequence
    parallelism) and at a batch the data axes do not divide: all three
    branches of the KV choice, and the conv and SSM-state rules."""
    sizes = MESHES[multi_pod]
    ref_cfg, cfg = ref_get_arch(arch), get_arch(arch)
    for batch, max_len in ((128, 4096), (1, 8192), (24, 512)):
        want = [tuple(s) for s in jax.tree.leaves(
            ref_lm.cache_shardings(ref_cfg, _oracle(multi_pod), batch,
                                   max_len),
            is_leaf=lambda x: isinstance(x, P))]
        got = tree_leaves(lm.cache_shardings(cfg, Rules(sizes), batch,
                                             max_len))
        assert [g.spec for g in got] == want, (arch, batch)
        for g in got:
            assert _placements_follow(g.spec, g.placements, sizes)


# ---------------------------------- the reference's unit cases, mirrored
def _mesh(multi_pod=False):
    return dict(MESHES[multi_pod])


def test_resolve_divisibility():
    r = Rules(_mesh())
    assert r.resolve("heads", 64) == "model"
    assert r.resolve("heads", 24) == "model"      # uneven OK (padded)
    assert r.resolve("heads", 24, allow_uneven=False) is None
    assert r.resolve("kv_heads", 2) is None       # kv: replicate if uneven
    assert r.resolve("kv_heads", 16) == "model"
    assert r.resolve("batch", 256) == ("data",)
    assert r.resolve("experts", 128) == "model"


def test_resolve_multipod_batch():
    r = Rules(_mesh(multi_pod=True))
    assert r.resolve("batch", 256) == ("pod", "data")
    # batch=1 (long-context) cannot shard
    assert r.resolve("batch", 1) is None


def test_spec_no_duplicate_axes():
    r = Rules(_mesh())
    spec = r.spec(("vocab", "ff"), (4096, 4096))
    # 'model' may appear only once
    flat = [a for a in spec if a is not None]
    assert len(flat) == 1


def test_pod_axis_dropped_on_single_pod():
    r = Rules(_mesh())
    assert r._present(("pod", "data")) == ("data",)


def test_opt_role_shards_embed():
    cfg = get_arch("qwen3-8b")
    rules = Rules(_mesh())
    p_abs = lm.abstract_params(cfg)
    p_sh = param_shardings(p_abs, rules)
    o_sh = param_shardings(p_abs, rules, role="opt")
    assert p_sh["embed"].spec == (None, None)          # replicated param
    assert o_sh["embed"].spec != (None, None)          # ZeRO-sharded state


@pytest.mark.parametrize("overrides", [
    None, sharding.PURE_DP_OVERRIDES, {"fsdp": (None,)},
    {"head_dim": (None,)}])
def test_rules_with_overrides_equal_the_reference(overrides):
    """Resolution and specs under the reference's override tables, for
    every logical name at a spread of sizes, uneven and not."""
    for multi_pod in (False, True):
        ours = Rules(_mesh(multi_pod), overrides)
        theirs = _oracle(multi_pod, overrides)
        for name in list(sharding.DEFAULT_RULES) + [None, "nope"]:
            for dim in (1, 2, 3, 8, 24, 32, 48, 64, 256, 512, 4096):
                for uneven in (True, False):
                    assert ours.resolve(name, dim, uneven) == \
                        theirs.resolve(name, dim, uneven), (name, dim)
        for axes, shape in ((("vocab", "ff"), (4096, 4096)),
                            (("batch", "seq", "heads", None),
                             (256, 64, 24, 128)),
                            (("vocab_opt", "d_opt"), (151936, 4096))):
            assert ours.spec(axes, shape) == tuple(theirs.spec(axes, shape))


def test_placements_split_a_dim_over_mesh_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    sizes = _mesh(multi_pod=True)
    assert placements(sizes, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert placements(sizes, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        placements(sizes, (("data", "pod"),))


def test_vocab_shard_sharding_equals_the_reference():
    for multi_pod in (False, True):
        for rows in (4096, 4000, 17):
            ours = sharding.vocab_shard_sharding(_mesh(multi_pod), rows)
            axes = _oracle(multi_pod).resolve("cold_vocab", rows,
                                              allow_uneven=False)
            assert ours.spec == (axes,)


def test_constrain_is_the_identity_off_a_mesh():
    """No rules active, or a plain tensor under rules: the same object
    back (the models' placement sites cost nothing off a mesh); under
    rules the axes must name every dimension."""
    import torch
    x = torch.ones(2, 3, 4)
    assert sharding.constrain(x, "batch", "seq", "embed") is x
    with sharding.axis_rules(_mesh()) as rules:
        assert sharding.current_rules() is rules
        assert sharding.constrain(x, "batch", "seq", "embed") is x
        with pytest.raises(AssertionError):
            sharding.constrain(x, "batch", "seq")
    assert sharding.current_rules() is None
    with sharding.activate_rules(Rules(_mesh(), {"fsdp": (None,)})) as r:
        assert sharding.current_rules() is r and r.table["fsdp"] == (None,)


# ------------------------------------------------------------- build_cell
@pytest.fixture
def ref_build_cell(monkeypatch):
    """The reference's ``build_cell`` on the stand-in mesh: its ``Rules``
    answer specs, ``NamedSharding(mesh, P())`` is ``P()``, and ``jax.jit``
    hands back the keyword arguments it was given (the argument and output
    shardings) instead of a compiled step."""
    from repro.launch import steps as ref_steps
    monkeypatch.setattr(ref_steps, "Rules", _SpecRules)
    monkeypatch.setattr(ref_steps, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(ref_steps, "jax", types.SimpleNamespace(
        jit=lambda fn, **kw: kw, eval_shape=jax.eval_shape,
        ShapeDtypeStruct=jax.ShapeDtypeStruct))

    def build(arch, shape_name, multi_pod, **kw):
        mesh = types.SimpleNamespace(shape=dict(MESHES[multi_pod]))
        jit_kw, _, _ = ref_steps.build_cell(ref_get_arch(arch), shape_name,
                                            mesh, **kw)
        return jit_kw
    return build


def _ref_named_specs(tree):
    """``(path, spec)`` of a reference spec tree, a NamedTuple's fields
    named as the port's walk names them."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [("/".join(str(getattr(k, "name", k.key if hasattr(k, "key")
                                  else getattr(k, "idx", k)))
                      for k in path), tuple(spec))
            for path, spec in flat]


def _port_named_specs(tree):
    out = []
    tree_map_with_path(lambda path, sh: out.append((path, tuple(sh.spec))),
                       tree)
    return out


@pytest.mark.parametrize("knobs", [
    {}, {"zero_stage": 2},
    {"rule_overrides": sharding.PURE_DP_OVERRIDES},
    {"zero_stage": 2, "rule_overrides": sharding.PURE_DP_OVERRIDES}],
    ids=["zero3", "zero2", "zero3-pure_dp", "zero2-pure_dp"])
@pytest.mark.parametrize("shape_name",
                         ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "jamba-1.5-large-398b"])
def test_build_cell_shardings_equal_the_reference(ref_build_cell, arch,
                                                  shape_name, knobs):
    """``build_cell``'s argument shardings (parameters, the optimizer state
    of a train cell, the batch) and a decode cell's output shardings, on
    both production meshes, under ``zero_stage`` 3 and 2 and with and
    without the pure-data-parallel overrides: every leaf's path and spec
    equal the reference's. Train cells shard parameters and the optimizer
    state by different rules under ``zero_stage=2``; serving cells replace
    the rules by data-replicated parameters where the model-sharded copy
    fits (qwen3-8b) and keep them where it does not (jamba)."""
    from repro_torch.launch.steps import build_cell
    for multi_pod in (False, True):
        want = ref_build_cell(arch, shape_name, multi_pod, **knobs)
        cell, _, _ = build_cell(get_arch(arch), shape_name,
                                _mesh(multi_pod), **knobs)
        assert len(cell.in_shardings) == len(want["in_shardings"])
        for ours, theirs in zip(cell.in_shardings, want["in_shardings"]):
            assert _port_named_specs(ours) == _ref_named_specs(theirs)
        if shape_name == "decode_32k":
            assert _port_named_specs(cell.out_shardings) == \
                _ref_named_specs(want["out_shardings"])
    if shape_name == "train_4k" and knobs.get("zero_stage") == 2:
        # parameters replicated over data, their optimizer state not
        p_sh, o_sh, _ = cell.in_shardings
        assert not any("data" in str(sh.spec) for sh in tree_leaves(p_sh))
        assert any("data" in str(sh.spec) for sh in tree_leaves(o_sh.m))


# ------------------------------------------------------- production mesh
def test_make_production_mesh_on_the_fake_backend():
    """``make_production_mesh`` over a fake process group of 256 and then
    512 ranks: the reference's shapes and dim names; ``Rules`` on the
    DeviceMesh gives the name→size mapping's specs; a group of another
    size and no group at all are refused."""
    code = """
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import get_arch
        from repro_torch.distributed.sharding import Rules, param_shardings
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import lm
        from repro_torch.tree import tree_leaves
        try:
            make_production_mesh(device_type="cpu")
        except RuntimeError as e:
            print("NOGROUP", "initialized" in str(e))
        p_abs = lm.abstract_params(get_arch("qwen3-8b"))
        for world, multi in ((256, False), (512, True)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=world)
            try:
                make_production_mesh(multi_pod=not multi, device_type="cpu")
            except ValueError as e:
                print("WRONG", world, "needs" in str(e))
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            a = [s.spec for s in tree_leaves(param_shardings(
                p_abs, Rules(mesh), role="opt"))]
            b = [s.spec for s in tree_leaves(param_shardings(
                p_abs, Rules(sizes), role="opt"))]
            print("MESH", world, tuple(mesh.shape), mesh.mesh_dim_names,
                  a == b, len(a))
            dist.destroy_process_group()
    """
    out = run_subprocess(code, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NOGROUP True" in out.stdout, out.stdout
    assert "WRONG 256 True" in out.stdout and "WRONG 512 True" in out.stdout
    assert "MESH 256 (16, 16) ('data', 'model') True" in out.stdout, \
        out.stdout
    assert "MESH 512 (2, 16, 16) ('pod', 'data', 'model') True" in \
        out.stdout, out.stdout
