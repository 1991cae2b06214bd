"""Timers for the port's kernels on the card, three ways:

- time_ms: the median of single calls, each between CUDA events. A call's
  host time before its launch lies inside the interval, so for anything
  under ~0.05 ms this reads the wrapper's host cost more than the kernel.
- device_ms: the card alone. `calls` calls are captured in one CUDA graph,
  so that no host time lies between them, and the graph is replayed between
  CUDA events. Each captured call runs its wrapper's Python once, at
  capture; a replay runs no Python and counts no launch.
- cold_ms: the card alone with a cold L2: the median of single calls, each
  after a 128 MiB buffer was written (more than the H100's 50 MB L2), the
  CUDA events around the call alone, and a spin kernel ahead of the
  write, so that the host has enqueued the call before the card reaches it.
- host_us: the host's cost per call, `calls` calls enqueued back to back
  with no synchronise between them, then one synchronise (not timed). Keep
  `calls` times the launches per call well below what the card's launch
  queue holds (about a thousand), so that the host never waits for the card.
"""

from __future__ import annotations

import time

import torch


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over reps, each between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """The card's own milliseconds per call of fn: the median of `replays`
    replays of a CUDA graph holding `calls` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(replays):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    torch.cuda.synchronize()
    return sorted(times)[replays // 2]


FLUSH_BYTES = 128 << 20  # cold_ms's writes: more than the H100's 50 MB L2
SPIN_CYCLES = 2_000_000  # ~1 ms of the card: the host enqueues what follows meanwhile


def cold_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of fn() after FLUSH_BYTES of writes, between CUDA
    events around fn() alone."""
    buf = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    fn()
    times = []
    for i in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        buf.fill_(float(i))
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del buf
    times.sort()
    return times[len(times) // 2]


def host_us(fn, calls: int = 400) -> float:
    """The host's microseconds per call of fn."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6
