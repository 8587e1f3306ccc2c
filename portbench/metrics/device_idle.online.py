"""Share of the traced window with nothing running on the device."""
from portbench.measures import idle_percent


def read(run):
    return idle_percent(run)
