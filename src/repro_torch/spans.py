"""Spans and counters of the step loop and the host batching pipeline.

A :class:`SpanRecorder` keeps named time intervals (*spans*) and integer
*counters* while a ``torch.profiler`` is active, and nothing otherwise:
:func:`recording` is one read of torch's own flag
(``torch.autograd.profiler._is_profiler_enabled``), made only once torch
is imported, and a span site with recording off costs that read alone —
no clock read, no ``record_function``, no list append. There is no
switch of its own: a ``torch.profiler.profile`` turns it on.

A span has a name, a start and an end from ``time.time_ns()`` (the clock
of the profiler's CPU events, Unix-epoch nanoseconds, so spans and the
device trace line up), the native id of its thread, its parent span (the
innermost span open on the same thread when it began) and the key
``(epoch, index)`` of the batch it serves. A span begun on the thread
that runs the profiler is also entered as a profiler range of the same
name (``torch.profiler.record_function``'s C++ form), so the trace shows
it; the profiler is thread-local, so spans of other threads (the
producer, the finalize workers) are kept here only.

The module imports no torch: the batching pipeline and its process
workers stay torch-free. A ``TrainSession`` owns one recorder and hands
it to its pipeline; :meth:`SpanRecorder.totals` gives its totals per name.
:func:`process_totals` sums them over every recorder of the process that
recorded anything, for a caller that profiled a run but no longer holds
its session.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

_profiler = None            # torch.autograd.profiler, once torch is loaded
_recorded: List["SpanRecorder"] = []    # the recorders that kept anything
_recorded_lock = threading.Lock()


def recording() -> bool:
    """Whether a torch profiler is active (False while torch is not
    imported)."""
    mod = _profiler
    if mod is None:
        mod = _find_profiler()
        if mod is None:
            return False
    return mod._is_profiler_enabled


def _find_profiler():
    global _profiler
    _profiler = sys.modules.get("torch.autograd.profiler")
    return _profiler


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    start_ns: int
    end_ns: int = 0
    thread: int = 0
    parent: Optional["Span"] = None
    key: Optional[Tuple[int, int]] = None
    _range: object = dataclasses.field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


def _key(of) -> Optional[Tuple[int, int]]:
    """The batch key of ``of`` (a batch, or anything with ``epoch`` and
    ``index``)."""
    return None if of is None else (of.epoch, of.index)


class _Open:
    """A span open in a ``with`` block."""
    __slots__ = ("rec", "span")

    def __init__(self, rec: "SpanRecorder", span: Span):
        self.rec, self.span = rec, span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, *exc) -> None:
        self.rec.end(self.span)


class _Nothing:
    """The ``with`` block of a span site while recording is off."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        return None


_NOTHING = _Nothing()


class SpanRecorder:
    """Spans and counters of one training session, kept in memory."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self._open = threading.local()
        self._lock = threading.Lock()
        self._listed = False

    # -- spans of the calling thread ----------------------------------------
    def begin(self, name: str, of=None,
              start_ns: Optional[int] = None) -> Optional[Span]:
        """Open a span on this thread (``None`` while recording is off).
        ``start_ns`` is a ``time.time_ns()`` the caller has read already;
        ``of`` the batch the span serves."""
        if not recording():
            return None
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        span = Span(name, time.time_ns() if start_ns is None else start_ns,
                    thread=threading.get_native_id(),
                    parent=stack[-1] if stack else None, key=_key(of))
        torch = sys.modules["torch"]
        if torch._C._autograd._profiler_enabled():  # this thread's profiler
            # the C++ range: record_function's Python __exit__ can wait
            # milliseconds for the GIL before the range ends
            make = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.autograd.profiler.record_function)
            span._range = make(name)
            span._range.__enter__()
        stack.append(span)
        return span

    def end(self, span: Optional[Span], end_ns: Optional[int] = None,
            of=None, keep: bool = True) -> None:
        """Close ``span`` (nothing for ``None``); ``of`` sets its batch
        key, ``keep=False`` leaves it out of the spans (its profiler
        range stays in the trace)."""
        if span is None:
            return
        if span._range is not None:
            span._range.__exit__(None, None, None)
            span._range = None
        span.end_ns = time.time_ns() if end_ns is None else end_ns
        if of is not None:
            span.key = _key(of)
        stack = getattr(self._open, "stack", [])
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:
            stack.remove(span)
        if keep:
            self._keep(span)

    def span(self, name: str, of=None):
        """``with recorder.span(name, of=batch):`` — :meth:`begin` and
        :meth:`end` around the block."""
        if not recording():
            return _NOTHING
        return _Open(self, self.begin(name, of))

    # -- spans and counters handed over after the fact ------------------------
    def add(self, name: str, start_ns: int, end_ns: int, of=None,
            thread: int = 0, parent: Optional[Span] = None) -> Span:
        """Keep a span timed elsewhere (another thread or process, on the
        same clock). The caller checks :func:`recording`."""
        span = Span(name, start_ns, end_ns, thread=thread, parent=parent,
                    key=_key(of))
        self._keep(span)
        return span

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to a counter. The caller checks :func:`recording`."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
        self._list()

    def _keep(self, span: Span) -> None:
        self.spans.append(span)
        self._list()

    def _list(self) -> None:
        """Enter this recorder in :func:`process_totals` once it keeps
        anything, that is once a profiler has run."""
        if not self._listed:
            with _recorded_lock:
                if not self._listed:
                    _recorded.append(self)
                    self._listed = True

    # -- hand-over ------------------------------------------------------------
    def totals(self) -> dict:
        """``{"spans": {name: {"count", "seconds"}}, "counters": {name:
        n}}`` of everything this recorder kept."""
        return _totals([self])


def _totals(recorders: List[SpanRecorder]) -> dict:
    per: Dict[str, List[int]] = {}    # name -> [count, ns]
    counters: Dict[str, int] = {}
    for rec in recorders:
        for s in list(rec.spans):
            t = per.setdefault(s.name, [0, 0])
            t[0] += 1
            t[1] += s.end_ns - s.start_ns
        with rec._lock:
            for name, n in rec.counters.items():
                counters[name] = counters.get(name, 0) + n
    return {"spans": {n: {"count": c, "seconds": ns / 1e9}
                      for n, (c, ns) in per.items()},
            "counters": counters}


def process_totals() -> dict:
    """:meth:`SpanRecorder.totals` summed over every recorder of this
    process that recorded anything (each such recorder is kept alive
    for it). It serves a caller that profiled a run and holds no session
    any more; a caller that holds one reads its ``spans.totals()``."""
    with _recorded_lock:
        recorders = list(_recorded)
    return _totals(recorders)
