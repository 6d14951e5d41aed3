"""sampler_host_us.lwe: host us a call of the port's device samplers: the
inclusive host ns of the port's "nfl.sampler" span over its calls
(nfllib_tpu_torch.profiling.counters()), read after the window, so over
the whole run (set-up's warm-up requests, the untraced part and the
profiled part).  In cell 4 that is S3's host path: the Python above the
wrapper, the wrapper and the launch.  None for a port without the span."""


def read(run):
    from nfllib_tpu_torch import profiling
    counters = getattr(profiling, "counters", None)
    if counters is None:
        return None
    calls, ns = counters().get("nfl.sampler", (0, 0))
    return ns / calls / 1e3 if calls > 0 and ns > 0 else None
