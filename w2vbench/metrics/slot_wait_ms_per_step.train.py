"""Milliseconds a window step's loop waited for a pinned slot of the
host-to-device double buffer, i.e. for the step two back to end on the
card: the program's spans ``w2v.lift.slot_wait`` over the window's
``w2v.fetch`` count."""
from w2vbench import spans


def read(rec):
    return spans.per_fetch_ms(rec, "w2v.lift.slot_wait")
