"""idle_pct: the share of the traced window in which no kernel, copy or
fill ran on the card, in %."""


def read(run):
    if run.traced is None or run.traced.trace.window_s <= 0:
        return None
    s = run.traced.trace
    return 100.0 * (1.0 - s.busy_s / s.window_s)
