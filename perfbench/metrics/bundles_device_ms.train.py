"""bundles_device_ms.train: the bundles layer's (the camera spline and the rays') device time in ms a step of the traced
window, from the port's own device marks (lsenerf_tpu_torch/engine/spans.py):
the CUDA events the replayed graph records at the end of "layer:bundles" and
of the work before it, summed over the marked steps and divided by their
count. The port's store records only while a profiler runs, so its first
run is the traced window; None where it holds none (the CPU, a port without
the module)."""


def read(r):
    try:
        from lsenerf_tpu_torch.engine import spans
    except ImportError:
        return None
    runs = spans.snapshot()
    if not runs:
        return None
    steps = runs[0]["counters"].get("marked_steps")
    ms = runs[0]["device_ms"].get("bundles")
    return ms / steps if steps and ms is not None else None
