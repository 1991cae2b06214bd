"""The port's own tracing: host spans of the training loop and of a step's
layers, counters of the work a run does, and device marks that time the
layers on the card, also inside a replayed CUDA graph.

On and off. Spans, counters and marks outside a capture are recorded
while a torch profiler runs (torch.autograd._profiler_enabled(): the
benchmark's traced runs, the CLI's LSENERF_PROFILE_DIR, profile_step.py);
with none running a call site costs one check and allocates nothing.
Device marks inside a CUDA-graph capture are recorded always: a replay runs
no Python, so a mark has to be a node of the graph, which every replay
records again.

Spans. `span(name)` records the name, the host's start and end
(time.perf_counter_ns), the enclosing open span (its parent), and the step
its chunk starts at, in the run it belongs to: one call of
engine.loop.run_training_loop (or of `run()`); spans outside any run go to
run 0. It also opens a torch.profiler.record_function range of the same
name, so every profiler trace holds the spans on the profiler's clock, the
clock of its device trace. `layer(name)` is the span "layer:<name>" that
also marks the device where it ends.

Device marks. A mark is a CUDA timing event recorded on the current stream
at a layer's end, or named "other" where work of no layer ends (a step's
background draw, its metrics). The device time from one mark to the next is
the layer of the later mark, so the layers and "other" partition the marked
time exactly. Marks come in groups (`open_marks` / `close_marks`): the
marked steps of a chunk's graph, whose events each replay records again (a
replay's group is read before the next replay: `read_pending`), or an eager
step or occupancy update on the card. A group's first mark starts it.

Tallies. `tally(mask)` counts the march's slots (`mask`'s elements) and
its live samples (`mask`'s true elements) of a train step that carries a
group of marks: a chunk's marked step, replayed or eager, or a traced
eager step. The live count is a reduction on the device (in a graph a
node of it, which every replay runs again) that the group keeps; where the
group is handed to its run (a traced replay, an eager group's close) it is
added on the current stream into the run's device total, which is read
once, where the run ends, so that no read holds the host or the card
between steps. On the CPU, which has no marks, a tally counts every traced
train step.

Counters, a run's: "steps" (train steps run; a replay's counted as its k
steps), "marked_steps" (steps whose device marks were read), "replays",
"captures" and "eager_steps" (by reason), "occ_updates", "staged_bytes"
(host to device), "launches" (each kernel's launches, a replay's counted
as the kernels its graph holds); the tallies
"sample_slots" (the march's slots, rays x slots a ray) and "live_samples"
(the slots the march kept for the field; on the card read where the run
ends).

The store is process-wide and bounded (MAX_RUNS runs, MAX_SPANS spans a
run; what does not fit is counted as dropped), so it outlives the Trainer:
`snapshot()` returns it, `reset()` empties it.
"""

from __future__ import annotations

import time

import torch

MAX_RUNS = 32
MAX_SPANS = 100_000

_enabled = torch._C._autograd._profiler_enabled
# a profiler range in C++ (torch's own low-cost record_function), where
# this torch has it
_range = getattr(torch._C._profiler, "_RecordFunctionFast", torch.profiler.record_function)

_runs = {}  # run id -> its record, oldest first
_dropped_runs = 0
_dropped_id = None  # the last run not recorded
_next_id = 1
_run_id = 0  # the open run; 0 outside any
_open = []  # the open spans' records, innermost last
_group = None  # the open group of device marks
_capturing = None  # the groups closed in the capture under way, or None
_pending = []  # (run record, group) to read


def tracing() -> bool:
    """Is a torch profiler running (and so this module recording)?"""
    return _enabled()


class _Null:
    """What a call site gets while nothing is recorded."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Record:
    __slots__ = ("id", "spans", "dropped_spans", "device_ms", "counters", "step", "live")

    def __init__(self, run_id: int):
        self.id, self.spans, self.dropped_spans, self.step = run_id, [], 0, None
        self.live = None  # the device's total of the live samples tallied
        self.device_ms = {}
        self.counters = {"steps": 0, "marked_steps": 0, "replays": 0, "captures": {},
                         "eager_steps": {}, "occ_updates": 0, "staged_bytes": 0,
                         "launches": {}, "sample_slots": 0, "live_samples": 0}


def _record():
    """The open run's record, made at its first use; None once the store
    is full."""
    global _dropped_runs, _dropped_id
    rec = _runs.get(_run_id)
    if rec is None:
        if len(_runs) >= MAX_RUNS:
            if _dropped_id != _run_id:
                _dropped_runs, _dropped_id = _dropped_runs + 1, _run_id
            return None
        rec = _runs[_run_id] = _Record(_run_id)
    return rec


class run:
    """One run: every span, counter and mark recorded inside it is the
    run's (engine.loop.run_training_loop opens one a call). Its pending
    device marks are read, waiting for the card, where it ends."""

    def __enter__(self):
        global _run_id, _next_id
        self.outer, _run_id = _run_id, _next_id
        _next_id += 1
        return _run_id

    def __exit__(self, *exc):
        global _run_id, _group
        _group = None  # a group an exception left open
        try:
            if _pending:
                read_pending(wait=True)
            rec = _runs.get(_run_id)
            if rec is not None:
                _read_live(rec)
        finally:
            _run_id = self.outer
        return False


class _Span:
    __slots__ = ("rec", "entry", "rf")

    def __init__(self, name: str, step):
        self.rec = rec = _record()
        parent = _open[-1] if _open else None
        if step is None:
            step = parent.entry[4] if parent is not None and parent.rec is rec else (
                rec.step if rec is not None else None)
        elif rec is not None:
            rec.step = step
        pidx = parent.entry[5] if parent is not None and parent.rec is rec else None
        self.entry = [name, 0, 0, pidx, step, None]
        self.rf = _range(name)

    def __enter__(self):
        rec = self.rec
        if rec is not None:
            if len(rec.spans) < MAX_SPANS:
                self.entry[5] = len(rec.spans)
                rec.spans.append(self.entry)
            else:
                rec.dropped_spans += 1
        _open.append(self)
        self.rf.__enter__()
        self.entry[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.entry[2] = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _open.pop()
        return False


def span(name: str, step=None):
    """A host span (module doc); `step` sets the step of the chunk it opens."""
    if not _enabled():
        return _NULL
    return _Span(name, step)


class _Layer:
    """A layer: its span where tracing is on, its mark where it ends."""

    __slots__ = ("name", "span")

    def __init__(self, name: str, traced: bool):
        self.name = name
        self.span = _Span("layer:" + name, None) if traced else None

    def __enter__(self):
        if self.span is not None:
            self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if _group is not None:
            _group.add(self.name)
        if self.span is not None:
            self.span.__exit__(*exc)
        return False


def layer(name: str):
    """The span "layer:<name>", and a device mark of the layer at its end
    where a group of marks is open (module doc)."""
    traced = _enabled()
    if not traced and _group is None:
        return _NULL
    return _Layer(name, traced)


# -- device marks ---------------------------------------------------------------


class _Group:
    __slots__ = ("marks", "steps", "reused", "live", "slots")

    def __init__(self, steps: int, reused: bool):
        self.marks, self.steps, self.reused = [], steps, reused
        self.live, self.slots = [], 0  # the tallies' device sums, their slots

    def add(self, name) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=self.reused)
        ev.record()
        self.marks.append((name, ev))


def open_marks(device, steps: int):
    """Open a group of device marks for the work that follows on `device`
    (`steps` train steps of it), its first mark recorded: inside a CUDA-graph
    capture always, else while tracing is on; none on the CPU or inside an
    open group. Returns the group, or None where none was opened."""
    global _group
    if _group is not None or device.type != "cuda":
        return None
    if _capturing is None and not _enabled():
        return None
    _group = _Group(steps, _capturing is not None)
    _group.add(None)
    return _group


def mark(name: str) -> None:
    """A device mark of `name` ("other" for work of no layer) in the open group."""
    if _group is not None:
        _group.add(name)


def tally(mask: torch.Tensor) -> None:
    """The march's `mask` of a train step: its true elements to
    "live_samples", all of them to "sample_slots" (module doc)."""
    if _group is not None:
        _group.live.append(mask.sum())
        _group.slots += mask.numel()
    elif _capturing is None and mask.device.type == "cpu" and _enabled():
        count("live_samples", int(mask.sum()))
        count("sample_slots", mask.numel())


def _read_live(rec) -> None:
    """The run's device total of live samples into its counter (a wait
    for the card)."""
    if rec.live is not None:
        rec.counters["live_samples"] += int(rec.live)
        rec.live = None


def _hand(rec, g) -> None:
    """Group `g` to be read into run `rec`, its tallies added to the run's."""
    _pending.append((rec, g))
    if g.live:
        rec.counters["sample_slots"] += g.slots
        if rec.live is None:
            rec.live = torch.zeros((), dtype=torch.int64, device=g.live[0].device)
        for v in g.live:
            rec.live.add_(v)


def close_marks(group) -> None:
    """Close a group from open_marks: in a capture it is kept for the
    graph's replays (`capture`), else it is read once its work is done."""
    global _group
    if group is None:
        return
    _group = None
    if group.reused:
        _capturing.append(group)
    else:
        rec = _record()
        if rec is not None:
            _hand(rec, group)


class capture:
    """Around a CUDA-graph capture: every group of marks closed inside it
    is a node of the graph. Entered, it gives the list of those groups,
    which the owner of the graph keeps as long as the graph (`replayed`)."""

    def __enter__(self):
        global _capturing
        self.outer, _capturing = _capturing, []
        return _capturing

    def __exit__(self, *exc):
        global _capturing, _group
        _capturing, _group = self.outer, None
        return False


def replayed(groups, launches) -> None:
    """One replay of a graph with these groups of marks and these kernel
    launches ({name: count}): counted, and the groups read before the
    graph's next replay, while tracing is on."""
    if not _enabled():
        return
    rec = _record()
    if rec is None:
        return
    c = rec.counters
    c["replays"] += 1
    for name, n in (launches or {}).items():
        c["launches"][name] = c["launches"].get(name, 0) + n
    for g in groups:
        _hand(rec, g)


def read_pending(wait: bool = False) -> None:
    """Read the groups of marks waiting: a replay's always, waiting for its
    last mark (its events are recorded again by the next replay); an eager
    group where its work is done, or with `wait` in any case."""
    global _pending
    if not _pending:
        return
    keep = []
    for rec, g in _pending:
        last = g.marks[-1][1]
        if not (wait or g.reused or last.query()):
            keep.append((rec, g))
            continue
        last.synchronize()
        dev = rec.device_ms
        for (_, a), (name, b) in zip(g.marks, g.marks[1:]):
            dev[name] = dev.get(name, 0.0) + a.elapsed_time(b)
        rec.counters["marked_steps"] += g.steps
    _pending = keep


# -- counters --------------------------------------------------------------------


def count(name: str, n: int = 1, key=None) -> None:
    """Add n to the open run's counter `name` (its entry `key` where the
    counter is by reason or by kernel), while tracing is on."""
    if not _enabled():
        return
    rec = _record()
    if rec is None:
        return
    c = rec.counters
    if key is None:
        c[name] += n
    else:
        c[name][key] = c[name].get(key, 0) + n


def launched(name: str) -> None:
    """One launch of kernel `name` outside a capture (a replay's launches
    are counted by `replayed`), while tracing is on."""
    if _capturing is None and _enabled():
        count("launches", 1, name)


# -- the store -------------------------------------------------------------------


def snapshot() -> list:
    """The store, the runs oldest first, each a dict: "id", "spans" (each
    {"name", "start_ns", "end_ns", "parent" (index in the run's spans, or
    None), "step"}), "dropped_spans", "device_ms" ({layer or "other": ms}
    of the marks read) and "counters"; pending marks and the tallies'
    totals are read first, waiting for the card."""
    read_pending(wait=True)
    out = []
    for rec in _runs.values():
        _read_live(rec)
        out.append({
            "id": rec.id,
            "spans": [{"name": e[0], "start_ns": e[1], "end_ns": e[2], "parent": e[3],
                       "step": e[4]} for e in rec.spans],
            "dropped_spans": rec.dropped_spans,
            "device_ms": dict(rec.device_ms),
            "counters": {k: dict(v) if isinstance(v, dict) else v
                         for k, v in rec.counters.items()},
        })
    return out


def dropped_runs() -> int:
    """Runs not recorded since the store was full."""
    return _dropped_runs


def reset() -> None:
    """Empty the store (the runs, their pending marks and the dropped count)."""
    global _dropped_runs, _dropped_id, _pending
    _runs.clear()
    _pending = []
    _dropped_runs, _dropped_id = 0, None
