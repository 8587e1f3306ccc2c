"""Evals per forward over the window (engine counters)."""


def read(run):
    return run.evals / run.forwards if run.forwards else None
