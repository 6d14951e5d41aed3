"""setup_s: seconds from the harness's first line to the first timed
request (import, the card's context, the library, inputs, the port's
set-up, the warm-up requests)."""


def read(run):
    return run.setup_s
