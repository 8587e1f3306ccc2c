"""The attention's products and softmax (kernel class ATT): device ms per
forward, over the traced window's forwards."""


def read(run):
    if run.trace is None or not run.trace.kernel_s.get("ATT"):
        return None
    forwards = sum(run.traced_buckets.values())
    return 1e3 * run.trace.kernel_s["ATT"] / forwards if forwards else None
