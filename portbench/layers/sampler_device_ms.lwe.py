"""sampler_device_ms.lwe: device ms a request of the kernels launched
inside the "sampler" spans (the port's device Gaussians, S3; the harness's
join of their outputs is in a span of its own) over the traced window."""


def read(run):
    w = run.traced
    if w is None or not w.requests:
        return None
    dev = w.trace.span_device_s.get("sampler", 0.0)
    return dev * 1e3 / w.requests if dev > 0 else None
