"""enqueue_ms: the median host ms from a request's first call into the
port to the return of its last one, before the synchronisation, over the
untraced part of the window (the profiler's own cost on the host stays
out of it)."""
import statistics


def read(run):
    w = run.host
    return statistics.median(w.enqueue_ms) if w.enqueue_ms else None
