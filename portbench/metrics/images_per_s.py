"""Images completed per second in the offline cell."""
from portbench.measures import images_per_s


def read(run):
    return images_per_s(run)
