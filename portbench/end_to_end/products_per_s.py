"""products_per_s: ring products (a polynomial pair of the batch each)
completed in the untraced window, over its length."""
from portbench.end_to_end._rate import rate


def read(run):
    return rate(run)
