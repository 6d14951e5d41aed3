"""The share of the bandwidth bound in a span's device time, in %."""
from portbench.bounds import bound_seconds


def roofline_pct(run, span: str):
    """100 x (the least time the span's bytes take at the card's peak
    bandwidth) / (the device time of the kernels launched inside the span),
    over every such span of the traced window; None where the trace linked
    no device time to it."""
    w = run.traced
    if w is None:
        return None
    dev = w.trace.span_device_s.get(span, 0.0)
    nbytes = w.spans.bytes.get(span, 0)
    if dev <= 0 or nbytes <= 0:
        return None
    return 100.0 * bound_seconds(nbytes) / dev
