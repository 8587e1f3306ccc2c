"""Set-up's builds of every routing segment (TALoRA merge + FP4
pack), on the host clock, ending in a synchronise."""


def read(run):
    return run.bank_build_s
