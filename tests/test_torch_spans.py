"""The port's own tracing (lsenerf_tpu_torch/engine/spans.py) and the
benchmark's readers of it (perfbench/metrics/*_device_ms.train.py,
stage_host_ms.train.py, live_sample_share.train.py):
  - with no profiler running nothing is recorded, and a call site gets one
    shared object (it allocates nothing);
  - spans nest, each with its parent, the step its chunk starts at and one
    run a call of the training loop;
  - every span is also a torch.profiler range of the same name and
    nesting, each span inside its range on one clock;
  - a loop of a tiny trainer at scan_steps 3, its chunks through
    ChunkGraph's body on the CPU (a stand-in for the CUDA graph runs the
    body at the capture and at each replay): the layer ranges in order in
    every step, the chunk spans in every chunk, and the counters of each
    way a loop runs its steps;
  - the store's bound, and each reader's None on an empty store;
  - on the card (`cuda`): a replayed chunk's layers plus "other" partition
    its marked span and match the profiler's busy time, set_rng_state
    counts a second capture, and the replay-aware launch count.

This file imports neither JAX nor the JAX package, so the card's machine
runs it alone:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py -q
"""

import contextlib
import importlib.util
import os
import statistics

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import synthetic as tsyn
from lsenerf_tpu_torch.engine import chunk_graph, spans
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.engine.loop import run_training_loop
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import occupancy as tocc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ["layer:bundles", "layer:march", "layer:field", "layer:composite", "layer:losses",
          "layer:backward", "layer:adam"]
READERS = ["bundles_device_ms.train", "march_device_ms.train", "field_device_ms.train",
           "composite_device_ms.train", "losses_device_ms.train", "backward_device_ms.train",
           "adam_device_ms.train", "occ_update_device_ms.train", "stage_host_ms.train",
           "live_sample_share.train"]


@pytest.fixture(autouse=True)
def _empty_store():
    spans.reset()
    yield
    spans.reset()


def _trainer(device="cpu", rays=64, levels=4, max_res=32, rows_log2=8, grid=16):
    """A tiny trainer: RGB and events, SO3xR3 deltas, a random background
    and the occupancy update every 4 steps."""
    col, evs = tsyn.make_synthetic_scene(n_cams=4, h=16, w=16, focal=20.0)
    dm = tdm.MultiCamDataManager(tdm.DataManagerConfig(train_num_rays_per_batch=rays), col, evs,
                                 seed=3)
    mcfg = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=the.HashEncodingConfig(
            num_levels=levels, base_res=4, max_res=max_res, layout="blocked",
            blocked_rows_log2=rows_log2)),
        grid=tocc.OccGridConfig(resolution=grid, levels=1, update_interval=4),
        max_samples=16, max_candidates=64, hierarchical_march=False)
    cfg = ttr.TrainerConfig(col_cam_opt=ttr.CameraOptConfig(mode="SO3xR3"),
                            evs_cam_opt=ttr.CameraOptConfig(mode="SO3xR3"))
    tr = ttr.Trainer(cfg, mcfg, dm, device=device)
    tr.setup()
    return tr


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


class _CpuGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: the body runs where
    the card would record it (the capture) and again at each replay."""

    def __init__(self, tr):
        self.tr = tr

    def register_generator_state(self, gen):
        pass

    def replay(self):
        for cg in self.tr._chunks.values():
            if cg.graph is self:
                cg.body()


def _graphs_on_the_cpu(monkeypatch, tr):
    """Route the trainer's chunks through ChunkGraph on the CPU."""
    monkeypatch.setattr(tr, "_eager_chunk_reason", lambda: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: _CpuGraph(tr))
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())


def _children(run, idx):
    return [i for i, s in enumerate(run["spans"]) if s["parent"] == idx]


def _descendants(run, idx):
    out = []
    for i in _children(run, idx):
        out.append(i)
        out += _descendants(run, i)
    return sorted(out)


def test_nothing_is_recorded_without_a_profiler():
    tr = _trainer()
    assert not spans.tracing()
    run_training_loop(tr, num_steps=6, scan_steps=3)
    assert spans.snapshot() == [] and spans.dropped_runs() == 0
    # one shared object a call site, and no group of device marks
    assert spans.span("a") is spans.span("b") is spans.layer("march")
    assert spans.open_marks(torch.device("cpu"), 1) is None


def test_spans_nest_with_parents_steps_and_one_run_a_loop():
    tr = _trainer()
    with _cpu_profile():
        run_training_loop(tr, num_steps=6, scan_steps=3)
        run_training_loop(tr, num_steps=3, scan_steps=3)
    first, second = spans.snapshot()
    assert first["id"] != second["id"]
    for run, starts in ((first, [0, 3]), (second, [6])):
        names = [s["name"] for s in run["spans"]]
        assert names[0] == "loop" and run["spans"][0]["parent"] is None
        assert names.count("loop") == 1
        # every other span lies inside the loop's, and inside its parent's
        for s in run["spans"][1:]:
            p = run["spans"][s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
        chunks = [i for i, n in enumerate(names) if n == "chunk"]
        assert [run["spans"][i]["step"] for i in chunks] == starts
        for i in chunks:
            assert run["spans"][i]["parent"] == 0
            assert all(run["spans"][j]["step"] == run["spans"][i]["step"]
                       for j in _descendants(run, i))
        occ = [i for i, n in enumerate(names) if n == "occ_update"]
        assert all(names[j] == "layer:occupancy update" for i in occ for j in _children(run, i))


def test_spans_are_profiler_ranges_on_its_clock():
    """Each span is a profiler range of its name: the same names in the
    same order and nesting, and each span inside its own range on one
    clock. The two clocks count from other epochs, so one offset c (the
    store's time less the profiler's) has to put every span inside its
    range: c at most each start's offset and at least each end's, up to a
    margin the test measures, the median of what a range holds beyond its
    span (the range's own entry and exit). A host preemption only widens a
    range around its span, so it cannot fail the test; another clock, whose
    offset drifts over the run, does."""
    tr = _trainer()
    with _cpu_profile() as prof:
        # a profiler's first range pays its own set-up
        with torch.profiler.record_function("first"):
            pass
        run_training_loop(tr, num_steps=6, scan_steps=3)
    run, = spans.snapshot()
    names = {s["name"] for s in run["spans"]}
    events = sorted((e for e in prof.events() if e.name in names and e.device_type.name == "CPU"),
                    key=lambda e: (e.time_range.start, -e.time_range.end))
    assert [e.name for e in events] == [s["name"] for s in run["spans"]]
    for e, s in zip(events, run["spans"]):
        if s["parent"] is not None:
            p = events[s["parent"]]
            assert p.time_range.start <= e.time_range.start and e.time_range.end <= p.time_range.end
    # the offsets in us: c <= starts[i] and c >= ends[i] for every span i
    starts = [s["start_ns"] / 1e3 - e.time_range.start for e, s in zip(events, run["spans"])]
    ends = [s["end_ns"] / 1e3 - e.time_range.end for e, s in zip(events, run["spans"])]
    margin = statistics.median(a - b for a, b in zip(starts, ends))
    assert max(ends) - min(starts) <= margin, (max(ends) - min(starts), margin)


def test_chunk_graph_loop_on_the_cpu_records_layers_and_chunks(monkeypatch):
    """Four chunks of 3 steps through ChunkGraph (the eager warm-up, the
    capture and its replay, two replays): the layers in order in every
    step, the chunk spans in every chunk."""
    tr = _trainer()
    _graphs_on_the_cpu(monkeypatch, tr)
    with _cpu_profile():
        run_training_loop(tr, num_steps=12, scan_steps=3)
    run, = spans.snapshot()
    names = [s["name"] for s in run["spans"]]
    chunks = [i for i, n in enumerate(names) if n == "chunk"]
    assert len(chunks) == 4
    for c, i in enumerate(chunks):
        kids = [names[j] for j in _children(run, i)]
        want = ["chunk.draw", "chunk.stage", "chunk.refresh_occ"]
        want += [] if c == 0 else (["chunk.capture"] if c == 1 else []) + ["chunk.launch"]
        assert [n for n in kids if n.startswith("chunk.")] == want, (c, kids)
        layers = [names[j] for j in _descendants(run, i) if names[j].startswith("layer:")]
        # the capture's stand-in runs the body once more
        assert layers == LAYERS * (3 * (2 if c == 1 else 1)), c
    stage = [i for i, n in enumerate(names) if n == "chunk.stage"]
    # the CPU's staging buffer is its device buffer: no copy to wait for
    assert not any(names[j] == "chunk.stage.wait" for i in stage for j in _children(run, i))


def _ways(monkeypatch, tr, way):
    """(num_steps, scan_steps, the counters expected) of a way to run steps."""
    nbytes = None
    if way == "graph":
        _graphs_on_the_cpu(monkeypatch, tr)
        st = tr.dm.next_train_stack(0, 3)
        nbytes = chunk_graph.ChunkGraph(tr, 3, st).host.numel()
        return 12, 3, dict(steps=12, eager_steps={"warm-up": 3}, captures={"first": 1}, replays=3,
                           occ_updates=3), nbytes * 4
    if way == "eager chunks":
        return 6, 3, dict(steps=6, eager_steps={"no CUDA device": 6}, captures={}, replays=0,
                          occ_updates=2), None
    if way == "trimmed":
        return 5, 3, dict(steps=5, eager_steps={"no CUDA device": 3, "trimmed chunk": 2},
                          captures={}, replays=0, occ_updates=2), None
    return 5, 1, dict(steps=5, eager_steps={"scan_steps 1": 5}, captures={}, replays=0,
                      occ_updates=2), None


@pytest.mark.parametrize("way", ["graph", "eager chunks", "trimmed", "scan_steps 1"])
def test_counters_of_each_way_to_run_steps(monkeypatch, way):
    tr = _trainer()
    num, k, want, staged = _ways(monkeypatch, tr, way)
    with _cpu_profile():
        run_training_loop(tr, num_steps=num, scan_steps=k)
    run, = spans.snapshot()
    c = run["counters"]
    for key, v in want.items():
        assert c[key] == v, (key, c)
    assert c["marked_steps"] == 0 and run["device_ms"] == {}  # no marks on the CPU
    assert not any(c["launches"].values())  # the CPU runs the plain versions
    if staged is None:
        # the eager steps' batches, as Trainer.batch_to_device hands them over
        b = tr.batch_to_device(tr.dm.next_train(0))
        staged = num * sum(v.numel() * v.element_size() for v in b.values())
    assert c["staged_bytes"] == staged


def test_the_store_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RUNS", 2)
    monkeypatch.setattr(spans, "MAX_SPANS", 5)
    with _cpu_profile():
        for _ in range(3):
            with spans.run():
                for i in range(8):
                    with spans.span(f"s{i}"):
                        spans.count("steps")
    runs = spans.snapshot()
    assert len(runs) == 2 and spans.dropped_runs() == 1
    for run in runs:
        assert [s["name"] for s in run["spans"]] == [f"s{i}" for i in range(5)]
        assert run["dropped_spans"] == 3 and run["counters"]["steps"] == 8
    spans.reset()
    assert spans.snapshot() == [] and spans.dropped_runs() == 0


def _reader(name):
    path = os.path.join(ROOT, "perfbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("reader_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", READERS)
def test_reader_is_none_on_an_empty_store(name):
    assert spans.snapshot() == []
    assert _reader(name).read(None) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_of_a_cpu_loop(name):
    """On the CPU the store holds spans and counters but no device marks:
    the host's staging and the march's tallies (a plain sum every traced
    step) read, the device readers give None."""
    tr = _trainer()
    with _cpu_profile():
        run_training_loop(tr, num_steps=6, scan_steps=3)
    got = _reader(name).read(None)
    run, = spans.snapshot()
    if name == "stage_host_ms.train":
        draws = [s for s in run["spans"] if s["name"] == "chunk.draw"]
        assert got == pytest.approx(sum(s["end_ns"] - s["start_ns"] for s in draws) / 1e6 / 6)
    elif name == "live_sample_share.train":
        c = run["counters"]
        # 6 steps of all the batch's rays (RGB, prev and next event) x 16 slots
        rays = tr.num_rays(tr.batch_to_device(tr.dm.next_train(0)))
        assert c["sample_slots"] == 6 * rays * 16
        assert 0 < c["live_samples"] <= c["sample_slots"]
        assert got == pytest.approx(100.0 * c["live_samples"] / c["sample_slots"])
    else:
        assert got is None


# -- on the card -----------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device marks are CUDA events")
    return torch.device("cuda")


def _card_trainer(dev):
    """Kernels long beside the profiler's own gap a kernel (~1 us)."""
    return _trainer(dev, rays=32768, levels=8, max_res=256, rows_log2=14, grid=32)


@pytest.mark.cuda
def test_replayed_layers_partition_the_marked_span_on_card(monkeypatch):
    """A replayed chunk with every step marked: the layers plus "other"
    sum to the marks' span (within 5%) and to the profiler's busy time of
    the replay (within 10%)."""
    dev = _card()
    k = 4
    monkeypatch.setattr(chunk_graph.ChunkGraph, "marked_steps", lambda self: tuple(range(self.k)))
    tr = _card_trainer(dev)
    fn = tr.make_train_step_multi(k)
    for c in range(2):
        fn(tr.dm.next_train_stack(c * k, k))
    st = tr.dm.next_train_stack(2 * k, k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof, spans.run():
        fn(st)
        torch.cuda.synchronize()
    run, = spans.snapshot()
    cg = tr._chunks[k]
    assert len(cg.marks) == k
    span_ms = sum(g.marks[0][1].elapsed_time(g.marks[-1][1]) for g in cg.marks)
    dev_ms = run["device_ms"]
    assert set(dev_ms) == {n[len("layer:"):] for n in LAYERS} | {"other"}
    assert run["counters"]["marked_steps"] == k and run["counters"]["replays"] == 1
    assert sum(dev_ms.values()) == pytest.approx(span_ms, rel=0.05)
    kernels = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                     if e.device_type.name == "CUDA" and not e.name.startswith("Memcpy"))
    busy, end = 0.0, float("-inf")
    for a, b in kernels:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    print(f"marked {sum(dev_ms.values()):.4f} ms, span {span_ms:.4f} ms, busy {busy / 1e3:.4f} ms; "
          + ", ".join(f"{n} {v:.4f}" for n, v in dev_ms.items()))
    assert sum(dev_ms.values()) == pytest.approx(busy / 1e3, rel=0.10)


@pytest.mark.cuda
def test_set_rng_state_counts_a_second_capture_on_card():
    dev = _card()
    k = 2
    tr = _trainer(dev)
    fn = tr.make_train_step_multi(k)
    with _cpu_profile(), spans.run():
        for c in range(2):  # the warm-up, the first capture
            fn(tr.dm.next_train_stack(c * k, k))
        tr.set_rng_state(tr.rng_state())
        for c in range(2, 4):  # a warm-up again, the second capture
            fn(tr.dm.next_train_stack(c * k, k))
    run, = spans.snapshot()
    assert run["counters"]["captures"] == {"first": 1, "set_rng_state": 1}
    assert run["counters"]["eager_steps"] == {"warm-up": 2 * k}
    assert run["counters"]["replays"] == 2


@pytest.mark.cuda
def test_launch_count_sees_the_replays_on_card():
    """Three replays and no eager launch: each kernel's count is the
    graph's launches times three; Kernel.launches sees no replay."""
    dev = _card()
    k = 2
    tr = _trainer(dev)
    fn = tr.make_train_step_multi(k)
    for c in range(2):
        fn(tr.dm.next_train_stack(c * k, k))
    cg = tr._chunks[k]
    before = {kn.name: kn.launches for kn in chunk_graph.path_kernels()}
    with profile(activities=[ProfilerActivity.CUDA]), spans.run():
        for c in range(2, 5):
            fn(tr.dm.next_train_stack(c * k, k))
    run, = spans.snapshot()
    got = {n: v for n, v in run["counters"]["launches"].items() if v}
    assert got and got == {n: 3 * v for n, v in cg.launches.items() if v}
    assert {kn.name: kn.launches for kn in chunk_graph.path_kernels()} == before
