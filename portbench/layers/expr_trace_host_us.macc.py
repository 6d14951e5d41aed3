"""expr_trace_host_us.macc: host us a call of the port's Expr tracing: the
inclusive host ns of the port's "nfl.expr_trace" span (ops/expr_program.py
`from_expr`, an Expr tree traced into E1's programs) over its calls
(nfllib_tpu_torch.profiling.counters()), read after the window, so over
the whole run (set-up's warm-up requests, the untraced part and the
profiled part).  In the macc cell that is one 3-leaf muladd tree a term.
None for a port without the span."""


def read(run):
    from nfllib_tpu_torch import profiling
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    calls, ns = counters().get("nfl.expr_trace", (0, 0))
    return ns / calls / 1e3 if calls > 0 and ns > 0 else None
