"""Milliseconds a window step's loop sat blocked on the host pipeline for
its batch: the program's spans ``w2v.pipeline.wait`` (the epochs' last
takes, which close the epoch's pool, included) over the window's
``w2v.fetch`` count. The part of ``host_wait_ms_per_step`` that waits on
batching; the rest waits on the card or copies."""
from w2vbench import spans


def read(rec):
    return spans.per_fetch_ms(rec, "w2v.pipeline.wait")
