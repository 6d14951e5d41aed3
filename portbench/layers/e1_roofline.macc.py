"""e1_roofline.macc: the bandwidth bound's share of the device time of the
"e1" spans (bounds.py counts each input read and each output written
once)."""
from portbench.layers._roofline import roofline_pct


def read(run):
    return roofline_pct(run, "e1")
