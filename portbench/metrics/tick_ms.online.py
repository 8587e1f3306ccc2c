"""Mean wall of one engine.tick() in the window, on the host clock
around the call (each tick ends in the engine's synchronise)."""


def read(run):
    return 1e3 * sum(run.tick_s) / len(run.tick_s) if run.tick_s else None
