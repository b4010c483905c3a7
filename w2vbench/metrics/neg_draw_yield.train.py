"""Percent of the negative slots drawn that serve real words: the
program's counters over the batches the window took, the slots at real
positions (real positions x N at T=1, ``w2v.draw.real_slots``) over the
slots drawn in all rounds, redraws included (``w2v.draw.slots``)."""
from w2vbench import spans


def read(rec):
    t = spans.totals(rec)
    drawn = t["counters"].get("w2v.draw.slots", 0) if t else 0
    if not drawn:
        return None
    return 100.0 * t["counters"].get("w2v.draw.real_slots", 0) / drawn
