"""Model FLOPs of the useful rows over the window and 989 TFLOP/s."""
from portbench.measures import mfu_percent


def read(run):
    return mfu_percent(run)
