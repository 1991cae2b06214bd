"""What the same-call comparisons of a kernel against other builds of its
C entry share (k3_compare, k5_compare): the card's line, building other
sources beside the package's, timing builds in turns (ABBA), and timing
two wrappers' host cost in turns.

Two versions are compared only within one call, on one card, in turns, so
that a drift of the card's clocks or of its shared host touches each
alike (PERF.md §2)."""

from __future__ import annotations

import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

from lsenerf_tpu_torch.ops import cuda_build
from lsenerf_tpu_torch.timing import cold_ms, device_ms, host_us


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def build(srcs: dict) -> dict:
    """{label: ctypes.CDLL} of each {label: source path}, built with
    cuda_build's flags into a library of its own, all nvcc processes
    started together; prints each build's registers and spills."""
    built = cuda_build.build_all(list(srcs.values()))
    libs = {}
    for label, path in srcs.items():
        for line in built[path][1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {label}: {line.strip()}")
        libs[label] = ctypes.CDLL(str(built[path][0]))
    return libs


def abba(fns: dict, shapes: dict, card: str, title) -> dict:
    """{shape: {label: {"warm": [ms, ms], "cold": [ms, ms]}}}: each fn(*args)
    timed at each shape warm (`timing.device_ms`: 20 calls in one replayed
    CUDA graph) and with a cold L2 (`timing.cold_ms`), the labels in order
    and then in reverse order. Prints a line a shape and label, headed by
    title(label, shape name, args), with the card's line."""
    res = {}
    order = list(fns) + list(fns)[::-1]
    for name, a in shapes.items():
        r = res[name] = {label: {"warm": [], "cold": []} for label in fns}
        for label in order:
            call = lambda fn=fns[label]: fn(*a)  # noqa: E731
            r[label]["warm"].append(device_ms(call))
            r[label]["cold"].append(cold_ms(call))
        for label, t in r.items():
            print(f"{title(label, name, a)}: device ms warm {t['warm']}, cold L2 {t['cold']}; "
                  f"{card}")
    return res


def host_turns(this, old, shapes: dict, card: str, kernel: str, rounds: int = 3) -> dict:
    """{shape: {"this" or "old": [us, ...]}}: the host's microseconds a call
    of the package's wrapper and of an earlier one, one timing.host_us run
    (400 calls) a reading, in turns (this, old, old, this) `rounds` times."""
    fns = {"this": this, "old": old}
    res = {}
    for name, a in shapes.items():
        r = res[name] = {"this": [], "old": []}
        for _ in range(rounds):
            for label in ("this", "old", "old", "this"):
                r[label].append(host_us(lambda fn=fns[label]: fn(*a)))  # noqa: E731
        print(f"{kernel} host us a call at {name}: this wrapper {r['this']} (median "
              f"{statistics.median(r['this'])}), the old one {r['old']} (median "
              f"{statistics.median(r['old'])}); {card}")
    return res


def load_module(path, name: str):
    """The module at path (an earlier commit's file), registered under name
    first: its dataclasses look their module up."""
    spec = importlib.util.spec_from_file_location(name, Path(path).resolve())
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
