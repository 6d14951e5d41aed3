"""lwe_pairs_per_s: encryptions of zero with their decryptions (the
batch a request) completed in the untraced window, over its length."""
from portbench.end_to_end._rate import rate


def read(run):
    return rate(run)
