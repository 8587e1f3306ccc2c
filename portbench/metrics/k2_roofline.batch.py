"""K2 w4a4_matmul: bound time over device time, traced window."""
from portbench.measures import roofline_percent


def read(run):
    return roofline_percent(run, "K2")
