"""Percent of the positions of the window's batches that are padding:
one less the real positions (``w2v.positions.real``, the rows' summed
lengths) over the padded ones (``w2v.positions.padded``, S x L), from
the program's counters. Each negative draw round covers the padded
shape, so padding is work the host pipeline does for no word."""
from w2vbench import spans


def read(rec):
    t = spans.totals(rec)
    padded = t["counters"].get("w2v.positions.padded", 0) if t else 0
    if not padded:
        return None
    real = t["counters"].get("w2v.positions.real", 0)
    return 100.0 * (1.0 - real / padded)
