"""idle_share.train: the share of the traced window in which no kernel ran on the
card, 1 - (union of the kernels' intervals) / window, in %."""


def read(r):
    if r.trace.window_s <= 0 or not r.trace.kernels:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
