"""stage_host_ms.train: the host's ms a step of the traced window spent
drawing and staging the chunks' inputs: the port's own spans
(lsenerf_tpu_torch/engine/spans.py) "chunk.draw" (the batches),
"chunk.stage" (the staging buffer and its copy to the card, the wait for
the previous copy included) and "chunk.refresh_occ" (the grid into the
graph's own), summed and divided by the window's train steps. The port's
store records only while a profiler runs, so its first run is the traced
window; None where it holds none (the CPU, a port without the module)."""

NAMES = ("chunk.draw", "chunk.stage", "chunk.refresh_occ")


def read(r):
    try:
        from lsenerf_tpu_torch.engine import spans
    except ImportError:
        return None
    runs = spans.snapshot()
    if not runs:
        return None
    steps = runs[0]["counters"].get("steps")
    got = [s["end_ns"] - s["start_ns"] for s in runs[0]["spans"] if s["name"] in NAMES]
    return sum(got) / 1e6 / steps if steps and got else None
