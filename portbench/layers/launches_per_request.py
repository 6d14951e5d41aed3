"""launches_per_request: launches of the port's kernel wrappers
(_kernels.KERNELS[*].launches, one a launch or chunk) in the untraced
window over its requests."""


def read(run):
    w = run.host
    return w.launches / w.requests if w.requests else None
