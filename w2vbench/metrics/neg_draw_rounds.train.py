"""Rounds one batch's negative draw took: the first draw of the whole
array and each redraw while a slot conflicts (17 at most; a batch that
still conflicts then is filled without drawing). The program's counter
``w2v.draw.rounds`` over the batches the window took, one ``w2v.finalize``
span each."""
from w2vbench import spans


def read(rec):
    t = spans.totals(rec)
    if t is None or not spans.count(t, "w2v.finalize"):
        return None
    return t["counters"].get("w2v.draw.rounds", 0) / spans.count(
        t, "w2v.finalize")
