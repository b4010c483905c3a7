"""``examples/torch_train_100m_w2v.py`` against
``examples/train_100m_w2v.py`` on the CPU at ``--batches 4 --vocab
20000``, with 0 and 2 prefetch workers, from the same initial tables (the
reference session's): the printed mean embedding norm within rtol 1e-4
of the reference's, the port's table within atol 2e-5 / rtol 1e-4
(``tests/test_torch_trainer.py``'s ``TOL``) of the reference's, and a
second call on the same ``--ckpt-dir`` prints the resumed line in both
packages."""
import re

import numpy as np
import pytest

from tests.test_torch_examples import (TOL, line_shapes, load_example,
                                       spy_sessions)

ARGS = ["--batches", "4", "--vocab", "20000"]
NORM_RTOL = 1e-4


def _norm(text: str) -> float:
    return float(re.search(r"^embedding norms: mean (\S+)$", text,
                           re.M)[1])


def _port_shapes(ref_out: str) -> list:
    """The reference's line shapes as the port prints them: where the
    reference prints ``device_busy_frac`` (1 - wait / wall, which the port
    dropped) the port prints its share of wall time blocked on the host
    pipeline."""
    return [line.replace("(device busy #%)", "(pipeline wait #% of it)")
            for line in line_shapes(ref_out)]


@pytest.mark.parametrize("workers", [0, 2])
def test_train_100m_matches_the_reference(workers, tmp_path, monkeypatch,
                                          capsys):
    ref = load_example("train_100m_w2v")
    made = spy_sessions(ref, monkeypatch)
    argv = ["train_100m_w2v.py", *ARGS, "--prefetch-workers", str(workers)]
    port = load_example("torch_train_100m_w2v")

    def both():
        monkeypatch.setattr("sys.argv",
                            argv + ["--ckpt-dir", str(tmp_path / "ref")])
        ref.main()
        ref_out = capsys.readouterr().out
        session = port.run(4, 20_000, str(tmp_path / "port"), workers,
                           "cpu", init_tables=made[0].init)
        return ref_out, capsys.readouterr().out, session

    ref_out, port_out, session = both()
    assert session.backend == "torch"
    assert "backend=torch device=cpu" in port_out.splitlines()
    assert line_shapes(port_out) == _port_shapes(ref_out)
    np.testing.assert_allclose(_norm(port_out), _norm(ref_out),
                               rtol=NORM_RTOL)
    np.testing.assert_allclose(session.embeddings(),
                               np.asarray(made[0].state.w_in), **TOL)

    # the same checkpoint directory again: both resume at batch 4
    ref_out, port_out, session = both()
    for text in (ref_out, port_out):
        assert "resumed from checkpoint batch 4" in text.splitlines()
    assert session.resumed_step == made[1].resumed_step == 4
    assert line_shapes(port_out) == _port_shapes(ref_out)
