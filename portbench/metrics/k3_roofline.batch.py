"""K3 w4a4_conv2d: bound time over device time, traced window."""
from portbench.measures import roofline_percent


def read(run):
    return roofline_percent(run, "K3")
