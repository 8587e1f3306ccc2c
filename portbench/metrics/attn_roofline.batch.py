"""The attention (kernel class ATT): bound time over device time, traced
window; the bound is the family's, operations at the f32 peak or q, k, v
and out moved once."""
from portbench.measures import roofline_percent


def read(run):
    return roofline_percent(run, "ATT")
