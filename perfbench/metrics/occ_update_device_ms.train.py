"""occ_update_device_ms.train: the occupancy updates' device time in ms a
step of the traced window, from the port's own device marks
(lsenerf_tpu_torch/engine/spans.py): the CUDA events each update records at
its start and at the end of "layer:occupancy update", summed and divided by
the window's train steps. Set beside occ_update_ms.train (the same updates
timed from outside, launches included), it shows the updates' launch gaps.
The port's store records only while a profiler runs, so its first run is
the traced window; None where it holds none (the CPU, a port without the
module)."""


def read(r):
    try:
        from lsenerf_tpu_torch.engine import spans
    except ImportError:
        return None
    runs = spans.snapshot()
    if not runs:
        return None
    steps = runs[0]["counters"].get("steps")
    ms = runs[0]["device_ms"].get("occupancy update")
    return ms / steps if steps and ms is not None else None
