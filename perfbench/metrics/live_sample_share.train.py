"""live_sample_share.train: the share of the march's sample slots that hold
a live sample, in %: the port's own tallies (lsenerf_tpu_torch/engine/spans.py)
"live_samples" (the march's mask summed on the device) over "sample_slots"
(rays x slots a ray), both of the marked steps of the traced window. The
field and its backward run on every slot, so the rest is work on dead
slots. The port's store records only while a profiler runs, so its first
run is the traced window; None where it holds no such tallies (the CPU's
device-less run, a port without them)."""


def read(r):
    try:
        from lsenerf_tpu_torch.engine import spans
    except ImportError:
        return None
    runs = spans.snapshot()
    if not runs:
        return None
    c = runs[0]["counters"]
    live, slots = c.get("live_samples"), c.get("sample_slots")
    return 100.0 * live / slots if slots and live is not None else None
