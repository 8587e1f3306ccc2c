"""Process start to the window's start: imports, CUDA and kernel
load (and build, in a fresh checkout), the weight draw, every segment's
merge and pack, one warm forward per batch bucket."""


def read(run):
    return run.setup_s
