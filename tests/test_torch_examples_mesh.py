"""``examples/torch_distributed_w2v.py`` (4 gloo ranks on the CPU) against
``examples/distributed_w2v.py`` (4 fake XLA host devices) from the same
initial tables (the reference session's, captured right after its
construction): rank 0's embeddings within atol 2e-5 / rtol 1e-4
(``tests/test_torch_trainer.py``'s ``TOL``), the printed quality within
1e-3 of the reference's, and rank 0's printed quality equal to every
rank's (the Hogwild replicas are averaged after every batch).

Both sides run in subprocesses: jax fixes its device count at start (the
reference re-executes itself to set it; here the wrapper sets it and the
reference's child marker), and the spawned ranks import their function
from the example by name. They exchange ``.npz`` files."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np

from tests.conftest import REPO, SRC
from tests.test_torch_examples import QUALITY_ATOL, TOL, line_shapes, parse

REF = textwrap.dedent('''
    import runpy
    import sys

    import numpy as np

    import repro.core.trainer as trainer

    made = []


    class Spy(trainer.TrainSession):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append((self, {{k: np.asarray(v)
                                for k, v in self.state.params().items()}}))


    trainer.TrainSession = Spy
    runpy.run_path({example!r}, run_name="__main__")
    session, init = made[0]
    np.savez({out!r}, final=np.asarray(session.embeddings()), **init)
''')

PORT = textwrap.dedent('''
    import json
    import sys

    import numpy as np

    sys.path.insert(0, {examples!r})
    import torch_distributed_w2v as example

    if __name__ == "__main__":
        z = np.load({init!r})
        out = example.run("cpu", init_tables={{k: z[k] for k in
                                               ("w_in", "w_out")}})
        np.save({emb!r}, out["embeddings"])
        with open({quality!r}, "w") as f:
            json.dump(out["quality"], f)
''')


def _run(script, path, env=None):
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ if env is None else env, PYTHONPATH=SRC)
    proc = subprocess.run([sys.executable, path], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_distributed_matches_the_reference(tmp_path):
    ref_npz = str(tmp_path / "ref.npz")
    env = dict(os.environ, _W2V_DIST_CHILD="1", JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    ref_out = _run(REF.format(example=f"{REPO}/examples/distributed_w2v.py",
                              out=ref_npz), str(tmp_path / "ref.py"), env)
    assert "devices: 4" in ref_out.splitlines()
    emb, quality = str(tmp_path / "emb.npy"), str(tmp_path / "q.json")
    port_out = _run(PORT.format(examples=f"{REPO}/examples", init=ref_npz,
                                emb=emb, quality=quality),
                    str(tmp_path / "port.py"))

    lines = port_out.splitlines()
    assert "devices: 4" in lines and "backend: torch_tiled" in lines
    assert "backend=torch_tiled device=cpu ranks=4 collectives=gloo" in lines
    assert line_shapes(port_out) == line_shapes(ref_out)
    z = np.load(ref_npz)
    np.testing.assert_allclose(np.load(emb), z["final"], **TOL)
    every = json.load(open(quality))
    printed = parse(port_out)["quality"]
    assert len(every) == 4
    for q in every:
        assert {k: round(v, 3) for k, v in q.items()} == printed
        assert q == every[0]
    want = parse(ref_out)["quality"]
    assert set(printed) == set(want)
    for k in want:
        assert abs(printed[k] - want[k]) <= QUALITY_ATOL, (k, printed, want)
