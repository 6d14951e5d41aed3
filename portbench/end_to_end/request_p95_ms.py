"""request_p95_ms: the nearest-rank 95th percentile of the latency of every
request in the window (host ms from its first call into the port to the
end of its synchronisation)."""
import math


def read(run):
    s = sorted(run.host.latencies_ms)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
