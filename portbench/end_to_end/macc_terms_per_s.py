"""macc_terms_per_s: multiply-accumulate terms (a polynomial product
added into the sum each: batch x terms a request) completed in the
untraced window, over its length."""
from portbench.end_to_end._rate import rate


def read(run):
    return rate(run)
