"""launch_host_us: host us a launch of the port's kernel wrappers, from the
stream's lookup to the return of the error check around the C entry point:
the sum of _kernels.KERNELS[*].host_ns over the sum of their launches, read
after the window, so over the whole run (set-up's warm-up requests, the
untraced part and the profiled part).  None where nothing launched or the
port keeps no host ns."""


def read(run):
    from nfllib_tpu_torch import _kernels
    launches = sum(k.launches for k in _kernels.KERNELS)
    ns = sum(getattr(k, "host_ns", 0) for k in _kernels.KERNELS)
    return ns / launches / 1e3 if launches > 0 and ns > 0 else None
