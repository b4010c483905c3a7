"""Milliseconds of one batch's encode, subsample and pack on the
pipeline's producer thread, its wait for a free slot left out: the mean
of the program's spans ``w2v.produce`` over the batches the window
took."""
from w2vbench import spans


def read(rec):
    return spans.mean_ms(rec, "w2v.produce")
