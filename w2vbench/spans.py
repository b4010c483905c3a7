"""The program's span and counter totals of a run, for the readers of the
``program_span`` metrics that split the step loop's wait.

The program (``repro_torch.spans``) records spans and counters exactly
while a ``torch.profiler`` is active, which in a run is the traced
window and nothing else. A record that carries the totals under
``"spans"`` is read as it is; otherwise :func:`totals` takes them once
from the program's process-wide view (``process_totals()``) and keeps
them there. An untraced run, or a program without the recorder, gives
``None``.
"""
from __future__ import annotations

import sys
from typing import Optional


def totals(rec: dict) -> Optional[dict]:
    """``{"spans": {name: {"count", "seconds"}}, "counters": {name: n}}``
    of the run, or ``None``."""
    if "spans" not in rec:
        mod = sys.modules.get("repro_torch.spans")
        got = getattr(mod, "process_totals", None)
        got = got() if got is not None else None
        rec["spans"] = got if got and got["spans"] else None
    return rec["spans"]


def count(t: dict, name: str) -> int:
    return t["spans"].get(name, {}).get("count", 0)


def seconds(t: dict, name: str) -> float:
    return t["spans"].get(name, {}).get("seconds", 0.0)


def per_fetch_ms(rec: dict, name: str) -> Optional[float]:
    """Milliseconds of the spans ``name`` over the window's ``w2v.fetch``
    count: per step of the step loop."""
    t = totals(rec)
    if t is None or not count(t, "w2v.fetch"):
        return None
    return seconds(t, name) / count(t, "w2v.fetch") * 1e3


def mean_ms(rec: dict, name: str) -> Optional[float]:
    """Mean milliseconds of one span ``name``."""
    t = totals(rec)
    if t is None or not count(t, name):
        return None
    return seconds(t, name) / count(t, name) * 1e3
