"""The device trace of a measured window, from ``torch.profiler``.

``Trace`` profiles CPU and CUDA activity over the window (entered when
the window's clock starts and left after its closing synchronize).
``summarize`` reduces the events: the seconds in which a kernel, copy or
set ran on the card (the union of their intervals), each device
operation's total time, and the idle stretches of the card labelled by
the innermost host event that spanned their middle.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "w2vbench.window"


class Trace:
    """Context manager: ``torch.profiler`` over the window when
    ``enabled``, nothing otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self._span = None

    def __enter__(self) -> "Trace":
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.__enter__()
            self._span = torch.profiler.record_function(WINDOW)
            self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.prof is not None:
            self._span.__exit__(*exc)
            self.prof.__exit__(*exc)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _events(prof):
    """``(name, start_us, end_us, on_card)`` of every profiled event: the
    profiler's raw event list where it has one (building its event tree
    takes minutes for a serving window's hundreds of thousands of
    calls), its event tree otherwise."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            a = e.start_ns() / 1e3
            yield e.name(), a, a + e.duration_ns() / 1e3, \
                e.device_type() == cuda
        return
    for e in prof.events():
        yield (e.name, e.time_range.start, e.time_range.end,
               e.device_type == cuda)


def summarize(trace: Trace, top: int = 10) -> Optional[dict]:
    """``{"busy_s", "window_s", "device_ops", "idle_gaps", "kernel_s"}``
    over the window span, or ``None`` without a trace. ``kernel_s`` maps
    each device operation's name to its seconds; ``device_ops`` and
    ``idle_gaps`` are the ``top`` largest, as ``[name, seconds]``."""
    if trace.prof is None:
        return None
    cpu, dev = [], []
    w0 = w1 = None
    for name, a, b, on_card in _events(trace.prof):
        if on_card:
            if name != WINDOW:         # the span's own mark on the card
                dev.append((a, b, name))
        else:
            if name == WINDOW:
                w0, w1 = a, b
            cpu.append((a, b, name))
    if w0 is None:
        return None
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in dev
              if b > w0 and a < w1]
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for a, b, n in inside:
        kernel_s[n] += (b - a) / 1e6
    busy = _union([(a, b) for a, b, _ in inside])
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    host = sorted((a, b, n) for a, b, n in cpu if n != WINDOW)
    idle: Dict[str, float] = collections.defaultdict(float)
    active: List[Tuple[float, float, str]] = []     # host calls open at mid
    j = 0
    for a, b in gaps:                               # gaps are in time order
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        label = (min(active, key=lambda h: h[1] - h[0])[2] if active
                 else "host: no traced call")
        idle[label] += (b - a) / 1e6
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    gaps_by = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_s, "window_s": (w1 - w0) / 1e6,
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps_by],
            "kernel_s": dict(kernel_s)}
