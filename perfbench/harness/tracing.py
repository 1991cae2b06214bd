"""A traced window: torch.profiler over the card (and, for labels, the
host), reduced to the device's kernels (name, start, end), the host's ops
and the window's bounds on the profiler's clock.

The measured window is traced on the card alone: recording every host op
slows the host by half or more, which opens gaps on the card that an
untraced run does not have. One more unit of work (a chunk, a frame) is
then traced with the host's ops, to say what the host was doing in the
card's longest idle gaps."""

from __future__ import annotations

import time

from perfbench.frozen import timeline

WINDOW = "perfbench_window"


class Trace:
    """What a traced window left: kernels [(name, start_us, end_us)], host
    ops [(name, start_us, end_us)], the window (start_us, end_us) and its
    length in s by the host's clock."""

    def __init__(self, kernels, host_ops, start_us, end_us, window_s):
        self.kernels, self.host_ops = kernels, host_ops
        self.start_us, self.end_us, self.window_s = start_us, end_us, window_s

    def spans(self):
        return [(s, e) for _, s, e in self.kernels]

    def busy_s(self) -> float:
        return timeline.busy_s(self.spans())

    def time_s(self, match) -> float:
        """Summed device time in s of the kernels whose name `match` takes."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """The kernels that took most device time: [[name, s]]."""
        by = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        return [[n[:160], t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest idle gaps of the card, each by the innermost host op
        open in its middle: [[op, s]]."""
        gaps = sorted(timeline.gaps(self.spans(), self.start_us, self.end_us),
                      key=lambda g: g[0] - g[1])[:top]
        return [[timeline.open_host_op(self.host_ops, 0.5 * (a + b)), (b - a) / 1e6]
                for a, b in gaps]


def measured(window, one_more, device):
    """Trace `window()` on the card alone, then `one_more()` with the
    host's ops; returns (the window's Trace, its breakdown: the window's
    top kernels and the labelled pass's longest idle gaps)."""
    _, trace = traced(window, device, host=False)
    _, labelled = traced(one_more, device, host=True)
    return trace, {"device_ops": trace.device_ops(), "idle_gaps": labelled.idle_gaps()}


def traced(body, device, host: bool = True):
    """Run body() under the profiler; returns (body's result, Trace). The
    window's length is the host's clock from before body to the card's end
    of it; with `host` the host's ops are recorded too and the window's
    bounds on the profiler's clock are its range (else the first kernel's
    start and the last one's end)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = device.type == "cuda"
    acts = ([ProfilerActivity.CPU] if host or not on_card else []) + \
        ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with record_function(WINDOW):
            out = body()
            if on_card:
                torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    kernels, host = [], []
    start = end = None
    for e in prof.events():
        tr = e.time_range
        if e.name == WINDOW:
            start, end = tr.start, tr.end
        elif e.device_type.name == "CUDA":
            kernels.append((e.name, tr.start, tr.end))
        else:
            host.append((e.name, tr.start, tr.end))
    if start is None:
        if ProfilerActivity.CPU in acts:
            raise RuntimeError("the profiler's trace holds no window range")
        start = min((k[1] for k in kernels), default=0.0)
        end = max((k[2] for k in kernels), default=0.0)
    kernels = [k for k in kernels if k[2] > start and k[1] < end]
    return out, Trace(kernels, host, start, end, window_s)
