"""lwe_graph_roofline.lwe: the bandwidth bound's share of the device time of the
"lwe_graph" spans (bounds.py counts each input read and each output written
once)."""
from portbench.layers._roofline import roofline_pct


def read(run):
    return roofline_pct(run, "lwe_graph")
