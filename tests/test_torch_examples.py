"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``) on the CPU, on the same seeds and from the same
initial tables or parameters (the reference's, captured from its session
or Trainer and handed to the port's ``run(..., init_tables=...)`` /
``run(..., init_params=...)``):

* quickstart: neighbour ids equal, quality metrics within 1e-3 absolute,
  embeddings within atol 2e-5 / rtol 1e-4 (``tests/test_torch_trainer.py``'s
  ``TOL``; over the 8 epochs x 13 batches the port stayed within 6.6e-7
  of the reference, so no drift allowance is needed);
* serve: both finish with ``serve_w2v: ok``, the served ids equal and the
  scores within 1e-5 (before and after the hot swap, and the analogies);
* lm_train_smoke: 6 steps with an injected failure, final step and loss
  history within rtol 1e-5 (``LOSS_RTOL``, as
  ``test_failure_recovery_matches_the_reference``).

Each port example prints the reference's lines in the reference's format
(one parser reads both) plus one ``backend=... device=...`` line; without
a GPU and without ``--device cpu`` each raises. The distributed example
is held in ``test_torch_examples_mesh.py`` and the 100M run in
``test_torch_examples_100m.py``."""
import ast
import importlib.util
import re
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.core.quality import evaluate as ref_evaluate
from repro.core.trainer import TrainSession as RefSession
from repro.train.loop import Trainer as RefTrainer
from repro_torch.convert import lm_params_from_reference
from tests.conftest import REPO

TOL = dict(atol=2e-5, rtol=1e-4)
QUALITY_ATOL = 1e-3
SCORE_ATOL = 1e-5
LOSS_RTOL = 1e-5
EXAMPLES = ("quickstart", "distributed_w2v", "serve_w2v", "train_100m_w2v",
            "lm_train_smoke")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: beside the other test workers, torch's default
    (one thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tmp_tempdir(tmp_path, monkeypatch):
    """The examples' ``tempfile.mkdtemp`` directories land in tmp_path."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def load_example(name: str):
    """``examples/<name>.py`` as a module, its entry point not run."""
    path = f"{REPO}/examples/{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spy_sessions(mod, monkeypatch, base=RefSession, attr="TrainSession"):
    """Replace ``mod.<attr>`` with a subclass that keeps each instance and
    its tables (or parameters) as numpy right after construction."""
    made = []

    class Spy(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            if hasattr(self, "state"):
                self.init = {k: np.asarray(v)
                             for k, v in self.state.params().items()}
            else:
                self.init = jax.tree.map(np.asarray, self.params)
            made.append(self)

    monkeypatch.setattr(mod, attr, Spy)
    return made


_NUM = re.compile(r"[-+]?(\d[\d,]*\.?\d*|\.\d+)(e[-+]?\d+)?")


def line_shapes(text: str) -> list:
    """Each printed line with its numbers, paths, backend names and dict
    values masked: the format one parser reads."""
    out = []
    for ln in text.splitlines():
        if ln.startswith(("backend=", "start_ranks:")):
            continue                    # the port's own lines
        ln = re.sub(r"/\S+", "<path>", ln)
        ln = re.sub(r"backend[=:] ?\w+", "backend=<name>", ln)
        out.append(_NUM.sub("#", ln))
    return out


def parse(text: str) -> dict:
    """The numbers a reader takes from an example's output."""
    got = {"neighbours": {}}
    for ln in text.splitlines():
        if ln.startswith("quality: "):
            got["quality"] = ast.literal_eval(ln[len("quality: "):])
        m = re.match(r"\s*word (\d+) \(cluster (\d+)\) -> neighbours (.*)$",
                     ln)
        if m:
            got["neighbours"][int(m[1])] = ast.literal_eval(m[3])
        m = re.match(r"(\S+): step (\d+), loss ([\d.]+) -> ([\d.]+)", ln)
        if m:
            got["lm"] = (m[1], int(m[2]), float(m[3]), float(m[4]))
    return got


def evaluate_ref(session) -> dict:
    """The reference session's quality metrics, as its example computes
    them."""
    corpus = session.pipeline.corpus
    inv = np.zeros(session.pipeline.vocab.size, dtype=int)
    for w, i in session.pipeline.vocab.ids.items():
        inv[i] = corpus.clusters[w]
    return ref_evaluate(session.embeddings(), inv)


def test_quickstart_matches_the_reference(monkeypatch, capsys):
    ref = load_example("quickstart")
    made = spy_sessions(ref, monkeypatch)
    ref.main()
    ref_out = capsys.readouterr().out
    port = load_example("torch_quickstart")
    out = port.run("cpu", init_tables=made[0].init)
    port_out = capsys.readouterr().out

    assert out["session"].backend == "torch"
    assert "backend=torch device=cpu" in port_out.splitlines()
    assert line_shapes(port_out) == line_shapes(ref_out)
    got, want = parse(port_out), parse(ref_out)
    assert got["neighbours"] == want["neighbours"]
    for wid, nn in out["neighbours"].items():
        np.testing.assert_array_equal(nn, made[0].nearest(wid, k=4))
    ref_q = evaluate_ref(made[0])
    assert set(out["quality"]) == set(ref_q)
    for k, v in out["quality"].items():
        assert abs(v - ref_q[k]) <= QUALITY_ATOL, (k, v, ref_q[k])
    np.testing.assert_allclose(out["session"].embeddings(),
                               np.asarray(made[0].state.w_in), **TOL)


def test_serve_matches_the_reference(monkeypatch, capsys):
    ref = load_example("serve_w2v")
    made = spy_sessions(ref, monkeypatch)
    answers = []

    class Server(ref.EmbeddingServer):
        def neighbors(self, ids, *a, **kw):
            res = super().neighbors(ids, *a, **kw)
            answers.append(("nn", res))
            return res

        def analogy(self, triples, *a, **kw):
            res = super().analogy(triples, *a, **kw)
            answers.append(("analogy", res))
            return res

    monkeypatch.setattr(ref, "EmbeddingServer", Server)
    ref.main()
    ref_out = capsys.readouterr().out
    assert "hot_in" in made[0].init         # the vocab-sharded split tree
    port = load_example("torch_serve_w2v")
    out = port.run("cpu", init_tables=made[0].init)
    port_out = capsys.readouterr().out

    assert out["backend"] == "torch"
    for text in (ref_out, port_out):
        assert text.splitlines()[-1] == "serve_w2v: ok"
    assert line_shapes(port_out) == line_shapes(ref_out)
    assert parse(port_out)["neighbours"] == parse(ref_out)["neighbours"]
    # the reference's answers in order: nn, analogy, nn before the swap,
    # nn after it
    want = dict(zip(("nn", "analogy", "pre_swap", "post_swap"), answers))
    assert [kind for kind, _ in answers] == ["nn", "analogy", "nn", "nn"]
    for key, (ids, scores) in out["answers"].items():
        np.testing.assert_array_equal(ids, np.asarray(want[key][1].ids))
        np.testing.assert_allclose(scores, np.asarray(want[key][1].scores),
                                   atol=SCORE_ATOL, rtol=0)


def test_lm_train_smoke_matches_the_reference(monkeypatch, capsys):
    """``--steps 6 --inject-failure``: the failure at step 3 restores the
    step-0 checkpoint and replays, in both packages."""
    ref = load_example("lm_train_smoke")
    made = spy_sessions(ref, monkeypatch, base=RefTrainer, attr="Trainer")
    results = []
    train = RefTrainer.train
    monkeypatch.setattr(RefTrainer, "train",
                        lambda self: results.append(train(self))
                        or results[-1])
    monkeypatch.setattr("sys.argv", ["lm_train_smoke.py", "--steps", "6",
                                     "--inject-failure"])
    ref.main()
    ref_out = capsys.readouterr().out
    port = load_example("torch_lm_train_smoke")
    out = port.run("qwen3-8b", 6, True, "cpu",
                   init_params=lm_params_from_reference(made[0].init, "cpu"))
    port_out = capsys.readouterr().out

    assert "backend=torch device=cpu" in port_out.splitlines()
    assert line_shapes(port_out) == line_shapes(ref_out)
    want = results[0]
    assert out["final_step"] == want["final_step"] == 6
    assert len(out["losses"]) == len(want["losses"]) > 6   # replayed steps
    np.testing.assert_allclose(out["losses"], want["losses"],
                               rtol=LOSS_RTOL)
    name, step, first, last = parse(port_out)["lm"]
    assert (name, step) == parse(ref_out)["lm"][:2] == ("qwen3-8b", 6)
    np.testing.assert_allclose([first, last], parse(ref_out)["lm"][2:],
                               atol=1e-3)


@pytest.mark.parametrize("name", EXAMPLES)
def test_port_example_raises_without_a_gpu(name, monkeypatch):
    """With no GPU and no ``--device cpu`` each port example raises before
    it trains: it never moves to the CPU by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load_example(f"torch_{name}")
    argv = (["--batches", "1", "--vocab", "1000"]
            if name == "train_100m_w2v" else [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(argv)
