"""The comparisons that decide ``correct``, and their limits.

Each cell's limits are a file of their own, ``limits/<workload>.json``:
``{"<number>": {"limit": x, "lower": [readings], "upper": {"<variant>":
[readings]}}}``, where ``lower`` holds the readings of sound runs on the
card and ``upper`` those of the control and of each planted fault
(``faults.py``) that the limit was set from (``frozen`` reads 1 by
construction). A number passes when it is at most its limit; an exact
comparison has the limit 0. A cell with no limits file cannot be
correct.

Training (``train_numbers``) compares, leaf by leaf over the two tables,
the program's tables after the check steps with the reference's
(``reference.sgns`` from ``reference.init``'s tables over
``reference.batching``'s batches):

* ``batch_mismatch``: the check steps' sentence lengths, and the tokens
  and negatives of their real positions (each row's first ``length``
  slots), that differ from the reference's (exact, limit 0). Padding is
  not compared, so a batch padded to another width, or with other values
  in its padding slots, reads 0 where its real positions agree;
* ``grad1_gap``: the gap between the norms of the first step's update
  over its learning rate, the gradient as SGD gets it, worst leaf;
* ``change_gap``: the gap between the norms of the tables' change over
  the check steps, worst leaf;
* ``diff_rel``: the norm of the difference of the tables after the check
  steps, worst leaf.

Each is relative to the reference's norm of that leaf or of the median
leaf, whichever is larger. A leaf whose reference first-step gradient is
under a thousandth of the median leaf's moves by round-off alone and is
left out of the three norm comparisons.
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
GRAD_FLOOR = 1e-3       # leaves under this share of the median leaf's
                        # first-step gradient move by round-off alone


def load_limits(workload: str) -> Dict[str, dict]:
    path = HERE / "limits" / f"{workload}.json"
    if not path.exists():
        return {}
    return json.loads(path.read_text())


def verdict(numbers: Dict[str, float], limits: Dict[str, dict]
            ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """``(correct, [(name, value, limit)])``: correct when every number
    has a limit and none exceeds it (NaN fails)."""
    rows, ok = [], bool(numbers)
    for name, value in numbers.items():
        lim = limits.get(name, {}).get("limit")
        lim = float("nan") if lim is None else float(lim)
        rows.append((name, float(value), lim))
        if not (value <= lim):
            ok = False
    return ok, rows


def _real(batch) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(lengths, tokens, negatives)`` of a batch's real positions: the
    lengths of its non-empty rows, and the tokens and negatives of each
    such row's first ``length`` slots, in row order."""
    tok, neg, lens = (np.asarray(a) for a in batch)
    lens = lens.astype(np.int64)
    valid = np.arange(tok.shape[1])[None, :] < lens[:, None]
    over = int(np.maximum(lens - tok.shape[1], 0).sum())
    if over:            # a length past its row: the row cannot hold it
        raise ValueError(f"{over} positions lie past their rows")
    return lens[lens > 0], tok[valid], neg[valid]


def batch_mismatches(got: Sequence, want: Sequence) -> int:
    """Real positions (and lengths) that differ between two lists of
    ``(tokens, negatives, lengths)`` batches. Where the lengths agree,
    each differing token and negative counts; where they do not, every
    real position of the larger batch counts. A batch on one side only
    counts all of its real positions."""
    n = 0
    for i in range(max(len(got), len(want))):
        if i >= len(got) or i >= len(want):
            lens, tok, neg = _real((got if i < len(got) else want)[i])
            n += lens.size + tok.size + neg.size
            continue
        try:
            g = _real(got[i])
        except ValueError:
            g = None
        w = _real(want[i])
        if g is None or g[0].shape != w[0].shape or \
                g[2].shape[1:] != w[2].shape[1:] or \
                np.any(g[0] != w[0]):
            n += sum(x.size for x in w) if g is None else max(
                sum(x.size for x in g), sum(x.size for x in w))
            continue
        n += sum(int(np.count_nonzero(a != b)) for a, b in zip(g[1:], w[1:]))
    return n


def _norm(x: np.ndarray) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64).ravel()))


def _rel(gap: Dict[str, float], ref: Dict[str, float],
         leaves: Sequence[str]) -> float:
    """Worst leaf of ``gap / max(ref norm of the leaf, median leaf's)``."""
    med = float(np.median([ref[k] for k in ref]))
    worst = 0.0
    for k in leaves:
        den = max(ref[k], med)
        worst = max(worst, gap[k] / den if den > 0 else math.inf)
    return worst


def train_numbers(w0: Dict[str, np.ndarray], lr1: float,
                  prog1: Dict[str, np.ndarray], ref1: Dict[str, np.ndarray],
                  prog_k: Dict[str, np.ndarray],
                  ref_k: Dict[str, np.ndarray]) -> Tuple[dict, dict]:
    """``(numbers, detail)`` from the start tables ``w0``, the first
    step's learning rate, and the program's and the reference's tables
    after the first step and after the last check step."""
    g_ref = {k: _norm(ref1[k] - w0[k]) / lr1 for k in w0}
    g_prog = {k: _norm(prog1[k] - w0[k]) / lr1 for k in w0}
    med = float(np.median(list(g_ref.values())))
    leaves = [k for k in w0 if g_ref[k] >= GRAD_FLOOR * med]
    c_ref = {k: _norm(ref_k[k] - w0[k]) for k in w0}
    c_prog = {k: _norm(prog_k[k] - w0[k]) for k in w0}
    diff = {k: _norm(prog_k[k] - ref_k[k]) for k in w0}
    numbers = {
        "grad1_gap": _rel({k: abs(g_prog[k] - g_ref[k]) for k in w0},
                          g_ref, leaves),
        "change_gap": _rel({k: abs(c_prog[k] - c_ref[k]) for k in w0},
                           c_ref, leaves),
        "diff_rel": _rel(diff, c_ref, leaves),
    }
    detail = {"leaves": leaves, "grad1_ref": g_ref, "grad1_prog": g_prog,
              "change_ref": c_ref, "change_prog": c_prog, "diff": diff}
    return numbers, detail
