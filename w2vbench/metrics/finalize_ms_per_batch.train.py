"""Milliseconds one finalize worker spent on one batch (negative draws
with their redraw rounds, tile and exchange plans): the mean of the
program's spans ``w2v.finalize`` over the batches the window took."""
from w2vbench import spans


def read(rec):
    return spans.mean_ms(rec, "w2v.finalize")
