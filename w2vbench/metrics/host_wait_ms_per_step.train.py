"""Milliseconds a window step's loop waited on the host pipeline for its
batch: ``TrainSession``'s ``fetch_seconds`` (the program's own span around
taking the next batch, its lift into pinned buffers and the wait for a
buffer slot included), summed over the waits that fell inside the window
(those of its second step on), per such step."""


def read(rec):
    if rec.get("steps", 0) < 2:
        return None
    return rec["fetch_s"] / (rec["steps"] - 1) * 1e3
