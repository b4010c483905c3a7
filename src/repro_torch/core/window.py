"""Ring-buffer lifetime bookkeeping for context words (paper §3.2).

A word at position ``p`` of a sentence is a *context* word of the windows
centred at ``p - W_f .. p + W_f`` (except its own window ``p``). FULL-W2V
keeps its input-embedding row resident in fast memory (GPU shared memory)
for exactly that lifetime: loaded when window ``p - W_f`` begins (i.e. when
it becomes the leading edge of the sliding window), written back when
window ``p + W_f`` has been processed.

The buffer needs ``R = 2*W_f + 1`` row slots; position ``p`` lives in slot
``p % R``. Slot reuse is conflict-free because positions ``p`` and ``p + R``
have disjoint lifetimes: ``p`` is dead after window ``p + W_f``, and ``p+R``
is first needed for window ``p + W_f + 1``.

The port's copy of ``repro.core.window``: the pure-Python state machine
of that schedule. ``kernels/ref.py`` (the plain torch versions) and the
CUDA kernels (``kernels/csrc/seq.cuh``) run the same schedule; the tests
hold this module event for event against the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


def ring_slots(w_f: int) -> int:
    return 2 * w_f + 1


def slot_of(p: int, w_f: int) -> int:
    return p % ring_slots(w_f)


def lifetime(p: int, w_f: int, length: int) -> Tuple[int, int]:
    """Windows [first, last] (inclusive) during which position p must be
    buffer-resident. Clipped to the sentence."""
    return max(0, p - w_f), min(length - 1, p + w_f)


@dataclasses.dataclass
class Event:
    kind: str        # "load" | "store" | "window"
    window: int      # window index t at which the event happens
    position: int    # sentence position (load/store) or t (window)


def schedule(length: int, w_f: int) -> List[Event]:
    """The exact load/store/window event stream for one sentence.

    Before window t, position q = t + w_f is loaded (evicting q - R if it
    exists). Windows 0's preload covers positions 0..w_f-1. After the last
    window, surviving positions are flushed in increasing order.
    """
    r = ring_slots(w_f)
    ev: List[Event] = []
    for q in range(0, min(w_f, length)):
        ev.append(Event("load", 0, q))
    for t in range(length):
        q = t + w_f
        if q < length:
            old = q - r
            if old >= 0:
                ev.append(Event("store", t, old))
            ev.append(Event("load", t, q))
        ev.append(Event("window", t, t))
    # Flush: position p was evicted in-loop iff p + r was loaded, i.e.
    # p <= length - r - 1. Survivors are exactly p in [length - r, length).
    for p in range(max(0, length - r), length):
        ev.append(Event("store", length - 1, p))
    return ev


def loads_and_stores(length: int, w_f: int) -> Tuple[int, int]:
    evs = schedule(length, w_f)
    return (sum(1 for e in evs if e.kind == "load"),
            sum(1 for e in evs if e.kind == "store"))


def traffic_reduction(w_f: int) -> float:
    """Paper §3.2: lifetime reuse removes 2W_f/(2W_f+1) of context-row
    global-memory traffic (each row read+written once instead of once per
    window it participates in)."""
    return (2 * w_f) / (2 * w_f + 1)


class RingBufferSim:
    """Tiny simulator used by hypothesis tests: tracks which position each
    slot holds at each window and validates the invariant that every context
    position of window t is resident."""

    def __init__(self, length: int, w_f: int):
        self.length = length
        self.w_f = w_f
        self.r = ring_slots(w_f)
        self.slots: Dict[int, Optional[int]] = {i: None for i in range(self.r)}
        self.stored: List[int] = []
        self.loaded: List[int] = []

    def run(self) -> "RingBufferSim":
        for e in schedule(self.length, self.w_f):
            if e.kind == "load":
                s = slot_of(e.position, self.w_f)
                self.slots[s] = e.position
                self.loaded.append(e.position)
            elif e.kind == "store":
                s = slot_of(e.position, self.w_f)
                assert self.slots[s] == e.position, (
                    f"store of {e.position} but slot holds {self.slots[s]}")
                self.stored.append(e.position)
            else:
                t = e.window
                for p in range(max(0, t - self.w_f),
                               min(self.length, t + self.w_f + 1)):
                    s = slot_of(p, self.w_f)
                    assert self.slots[s] == p, (
                        f"window {t}: position {p} not resident "
                        f"(slot {s} holds {self.slots[s]})")
        return self
