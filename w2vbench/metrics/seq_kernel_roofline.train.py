"""The sequential SGNS kernel's share of its roofline, in %: the least
time the window's batches allow (``counts.sgns_flops`` at the f32 peak,
``counts.sgns_bytes`` at HBM bandwidth, the larger, summed over the
window's steps) over the device time of every kernel whose name holds
``seq_kernel`` in the window's trace. Nothing to read when no such kernel
ran."""

KERNEL = "seq_kernel"


def read(rec):
    tr = rec.get("trace")
    if not tr or "least_s" not in rec:
        return None
    t = sum(s for n, s in tr["kernel_s"].items() if KERNEL in n)
    return 100.0 * rec["least_s"] / t if t > 0 else None
