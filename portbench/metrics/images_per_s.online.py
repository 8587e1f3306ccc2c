"""Images completed per second in the open-loop cell past its knee."""
from portbench.measures import images_per_s


def read(run):
    return images_per_s(run)
