"""The port's process-group layer (``repro_torch.launch.mesh``,
``repro_torch.distributed.collectives``) on the CPU: each collective at 2
and 4 gloo ranks against its numpy definition (int8 and bf16 payloads
included), the one-rank identities, the backend rule, and a rank that
raises or hangs failing ``start_ranks`` within its timeout.

The ranks are spawned processes, which import their function from a
script's ``__main__``; so each run is a script written into ``tmp_path``
and run in a subprocess."""
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.distributed import collectives as coll
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import DataMesh, make_host_mesh, plan_ranks
from tests.conftest import REPO, SRC

SCRIPT = textwrap.dedent('''
    import json
    import sys
    import time

    import numpy as np

    OPS = ("all_gather", "all_to_all", "psum_scatter", "pmean")
    DTYPES = ("float32", "bfloat16", "int8")


    def values(n, r):
        rng = np.random.default_rng(r)
        return rng.integers(-20, 20, size=(n, 3, 4)).astype(np.float64)


    def definition(op, xs, me):
        n = len(xs)
        if op == "all_gather":
            return np.stack(xs)
        if op == "all_to_all":
            return np.stack([xs[s][me] for s in range(n)])
        if op == "psum_scatter":
            return sum(x[me] for x in xs)[None]
        acc = xs[0].astype(np.float32)
        for x in xs[1:]:
            acc = acc + x.astype(np.float32)
        return acc / np.float32(n)


    def collectives(mesh):
        import torch
        torch.set_num_threads(1)
        from repro_torch.distributed import collectives as coll
        n, me = mesh.size, mesh.rank
        xs = [values(n, r) for r in range(n)]
        out = {"rank": me, "size": n, "backend": mesh.backend,
               "device": str(mesh.device), "ok": {}}
        for op in OPS:
            for name in DTYPES:
                if op == "pmean" and name != "float32":
                    continue
                dt = getattr(torch, name)
                x = torch.tensor(xs[me]).to(dt)
                got = getattr(coll, op)(x, mesh)
                want = definition(op, xs, me)
                out["ok"][op + "/" + name] = bool(
                    got.dtype == dt and tuple(got.shape) == want.shape
                    and np.array_equal(got.float().numpy(),
                                       want.astype(np.float32)))
        # pmean: every rank the same bits, summed in rank order
        x = torch.tensor(np.random.default_rng(10 + me).normal(
            size=(5, 7)).astype(np.float32))
        mean = coll.pmean(x, mesh)
        every = coll.all_gather(mean, mesh)
        out["pmean_same_bits"] = bool(all(
            torch.equal(every[0].view(torch.int32), e.view(torch.int32))
            for e in every))
        return out


    def fail(mesh):
        import torch.distributed as dist
        if mesh.rank == 1:
            raise ValueError("rank 1 fails on purpose")
        dist.barrier()          # rank 0 waits for a rank that is gone
        return "unreachable"


    def hang(mesh):
        time.sleep(3600)


    if __name__ == "__main__":
        from repro_torch.launch.mesh import RankFailed, start_ranks
        mode, n, timeout = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
        t0 = time.monotonic()
        try:
            res = start_ranks(globals()[mode], n, "cpu", timeout=timeout)
        except RankFailed as e:
            res = {"failed": str(e)}
        res = dict(res) if isinstance(res, dict) else {"value": res}
        res["seconds"] = time.monotonic() - t0
        print(json.dumps(res))
''')


def _run(tmp_path, mode: str, n: int, timeout: float = 120.0) -> dict:
    path = tmp_path / "ranks.py"
    path.write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(path), mode, str(n),
                          str(timeout)], env=env, capture_output=True,
                         text=True, timeout=timeout + 120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def by_ranks(tmp_path_factory):
    """Rank 0's collective results at 2 and 4 ranks (one run each)."""
    return {n: _run(tmp_path_factory.mktemp(f"coll{n}"), "collectives", n)
            for n in (2, 4)}


OPS = ["all_gather/float32", "all_gather/bfloat16", "all_gather/int8",
       "all_to_all/float32", "all_to_all/bfloat16", "all_to_all/int8",
       "psum_scatter/float32", "psum_scatter/bfloat16", "psum_scatter/int8",
       "pmean/float32"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", OPS)
def test_collective_matches_its_definition(by_ranks, n, op):
    res = by_ranks[n]
    assert res["size"] == n and res["backend"] == "gloo"
    assert res["device"] == "cpu"
    assert res["ok"][op], res


@pytest.mark.parametrize("n", [2, 4])
def test_pmean_gives_every_rank_the_same_bits(by_ranks, n):
    assert by_ranks[n]["pmean_same_bits"]


@pytest.mark.parametrize("fn", [coll.all_gather, coll.all_to_all,
                                coll.psum_scatter, coll.pmean])
def test_one_rank_collectives_are_identities(fn):
    """A process without a group is a one-rank mesh; every collective is
    then an exact identity (``all_gather`` adds the rank axis) and
    touches no group."""
    mesh = make_host_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "none")
    for x in (torch.arange(24.0).view(1, 4, 6),
              torch.arange(24, dtype=torch.int8).view(1, 4, 6),
              torch.ones((1, 2, 3), dtype=torch.bfloat16)):
        got = fn(x, mesh)
        assert got.dtype == x.dtype
        assert torch.equal(got.reshape(x.shape), x)
        assert torch.equal(fn(x, None).reshape(x.shape), x)


def test_blocks_must_match_the_mesh():
    mesh = DataMesh(rank=0, size=2, device=torch.device("cpu"),
                    backend="gloo")
    for fn in (coll.all_to_all, coll.psum_scatter):
        with pytest.raises(ValueError, match=r"\(2, \.\.\.\) blocks"):
            fn(torch.zeros((3, 4)), mesh)
    with pytest.raises(ValueError, match="rank 2 outside"):
        DataMesh(rank=2, size=2, device=torch.device("cpu"))


@pytest.mark.parametrize("device,n,cards,want", [
    ("cpu", 2, 0, ("gloo", ["cpu", "cpu"])),
    ("cpu", 4, 8, ("gloo", ["cpu"] * 4)),
    (None, 2, 1, ("gloo", ["cuda:0", "cuda:0"])),
    ("cuda", 4, 1, ("gloo", ["cuda:0"] * 4)),
    ("cuda", 2, 4, ("nccl", ["cuda:0", "cuda:1"])),
    (None, 4, 4, ("nccl", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"])),
])
def test_backend_rule(monkeypatch, device, n, cards, want):
    """NCCL when every rank can have a card of its own (rank r on
    ``cuda:r``), gloo otherwise: on the CPU, or every rank on one card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    backend, devices = plan_ranks(device, n)
    assert (backend, [str(d) for d in devices]) == want


def test_no_gpu_raises_before_spawning(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*a, **kw):
        raise AssertionError("spawned a process")

    monkeypatch.setattr(mesh_mod.mp, "get_context", no_spawn)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_mod.start_ranks(print, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_mod.start_ranks(print, 2, "cuda")
    with pytest.raises(ValueError, match="at least one rank"):
        plan_ranks("cpu", 0)


def test_a_raising_rank_fails_the_launcher_within_its_timeout(tmp_path):
    """Rank 1 raises while rank 0 waits in a barrier for it: the
    launcher reports rank 1's traceback and stops rank 0, long before the
    timeout."""
    res = _run(tmp_path, "fail", 2, timeout=60.0)
    assert "rank 1 failed" in res["failed"]
    assert "rank 1 fails on purpose" in res["failed"]
    assert res["seconds"] < 50


def test_a_hanging_rank_fails_the_launcher_at_its_timeout(tmp_path):
    t0 = time.monotonic()
    res = _run(tmp_path, "hang", 2, timeout=4.0)
    assert "still running after 4 s" in res["failed"]
    assert 4 <= res["seconds"] < 30
    assert time.monotonic() - t0 < 60


def test_cli_without_a_gpu_raises_before_spawning():
    """More than one shard and no ``--device cpu`` on a machine without a
    GPU: the command fails before it starts a rank."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "w2v", "--vocab",
         "64", "--sentences", "20", "--vocab-shard", "2"], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr, out.stderr[-2000:]
    assert "start_ranks:" not in out.stdout
