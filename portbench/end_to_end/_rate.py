"""Work units completed in the untraced window over its length."""


def rate(run):
    w = run.host
    return w.requests * run.units_per_request / w.seconds
