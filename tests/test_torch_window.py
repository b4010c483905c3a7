"""The port's ring-buffer state machine (``repro_torch.core.window``)
against the reference's ``repro.core.window``: the event stream of every
sentence length 0..40 at W_f 1..5, event for event, and the same
properties the reference's tests hold (one load and one store per
position, residency at every window, conflict-free slot reuse, the
traffic reduction of paper §3.2)."""
import dataclasses

import hypothesis.strategies as st
import pytest
from hypothesis import given, settings

import repro.core.window as ref_window
from repro_torch.core.window import (RingBufferSim, lifetime,
                                     loads_and_stores, ring_slots, schedule,
                                     slot_of, traffic_reduction)


@pytest.mark.parametrize("w_f", [1, 2, 3, 4, 5])
def test_schedule_matches_reference_event_for_event(w_f):
    for length in range(0, 41):
        got = [dataclasses.astuple(e) for e in schedule(length, w_f)]
        want = [dataclasses.astuple(e)
                for e in ref_window.schedule(length, w_f)]
        assert got == want, (length, w_f)
        assert loads_and_stores(length, w_f) == \
            ref_window.loads_and_stores(length, w_f)
        for p in range(length):
            assert lifetime(p, w_f, length) == \
                ref_window.lifetime(p, w_f, length)
            assert slot_of(p, w_f) == ref_window.slot_of(p, w_f)
    assert ring_slots(w_f) == ref_window.ring_slots(w_f) == 2 * w_f + 1
    assert traffic_reduction(w_f) == ref_window.traffic_reduction(w_f)


@given(st.integers(1, 40), st.integers(1, 5))
@settings(max_examples=60, deadline=None)
def test_every_position_loaded_and_stored_once(length, w_f):
    assert loads_and_stores(length, w_f) == (length, length)


@given(st.integers(0, 40), st.integers(1, 5))
@settings(max_examples=60, deadline=None)
def test_ring_buffer_sim_invariants(length, w_f):
    """Every context position of every window is resident, each store
    writes back the position its slot holds, and every position is loaded
    and stored once, in increasing order."""
    sim = RingBufferSim(length, w_f).run()
    assert sim.loaded == list(range(length))
    assert sorted(sim.stored) == list(range(length))
    assert len(set(sim.stored)) == length


def test_ring_buffer_sim_catches_a_broken_schedule(monkeypatch):
    """The simulator's residency check fires on a schedule that drops a
    load (its assertions are live, not vacuous)."""
    import repro_torch.core.window as win

    def dropped(length, w_f):
        return [e for e in schedule(length, w_f)
                if not (e.kind == "load" and e.position == 4)]

    monkeypatch.setattr(win, "schedule", dropped)
    with pytest.raises(AssertionError, match="not resident|slot holds"):
        win.RingBufferSim(12, 2).run()


@given(st.integers(1, 60), st.integers(1, 6))
@settings(max_examples=60, deadline=None)
def test_slot_conflict_freedom(length, w_f):
    """Positions p and p+R have disjoint lifetimes, so slot reuse is
    safe."""
    r = ring_slots(w_f)
    for p in range(length - r):
        _, last = lifetime(p, w_f, length)
        first, _ = lifetime(p + r, w_f, length)
        assert last < first
        assert slot_of(p, w_f) == slot_of(p + r, w_f)


def test_traffic_reduction_values():
    # paper §3.2: ~86% for W_f=3, ~91% for W_f=5
    assert abs(traffic_reduction(3) - 6 / 7) < 1e-9
    assert abs(traffic_reduction(5) - 10 / 11) < 1e-9
