"""ntt_roofline.macc: the bandwidth bound's share of the device time of the
"ntt" spans (bounds.py counts each input read and each output written
once)."""
from portbench.layers._roofline import roofline_pct


def read(run):
    return roofline_pct(run, "ntt")
