"""mfu.train: the window's model FLOPs (the field MLPs' multiply-adds and the
encode's interpolation at the configuration's widths, forward and backward
in training, counted from the cell's shapes) over the traced window at the
card's f32 peak outside the tensor cores, in %."""

from perfbench.frozen.bounds import F32_FLOPS


def read(r):
    flops = r.work.get("flops")
    if not flops or r.trace.window_s <= 0:
        return None
    return 100.0 * flops / (r.trace.window_s * F32_FLOPS)
