"""occ_update_ms.train: the benchmark's own spans (CUDA events) around
each Trainer.occ_update the loop ran in the traced window, summed and
divided by the window's train steps, in ms a step."""


def read(r):
    spans = r.work.get("occ_update_ms") or []
    if not spans or any(s is None for s in spans) or not r.work.get("steps"):
        return None
    return sum(spans) / r.work["steps"]
