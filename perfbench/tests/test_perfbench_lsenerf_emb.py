"""The lsenerf_emb.train cell beside the two first cells: the reference
against the port at a tiny size on the CPU, its control and planted fault
against the cell's limits, and on the card the control at the cell's own
widths (test_perfbench_reference.py's two tests, called with this cell);
a tiny run's result line; and its per-layer reader of the march's tallies,
live_sample_share.train."""

from __future__ import annotations

import pytest
import torch

from test_perfbench_reference import \
    test_control_is_not_correct_on_card as _control_is_not_correct_on_card
from test_perfbench_reference import \
    test_reference_steps_are_the_ports_on_the_cpu as _reference_steps_are_the_ports

CELL = "lsenerf_emb.train"


def test_reference_steps_are_the_ports_on_the_cpu(tiny):
    _reference_steps_are_the_ports(tiny, CELL)


@pytest.mark.cuda
def test_control_is_not_correct_on_card():
    _control_is_not_correct_on_card(CELL)


def test_train_result_line(run_tiny):
    got = run_tiny(CELL)
    assert got["correct"] is True and got["attempted"] > 0 and got["failed"] == 0
    assert set(got["metrics"]) == {"step_ms", "setup_s"}
    assert set(got["checks"]) == {"loss_gap", "grad_gap", "change_gap", "replay_change_gap",
                                 "batches"}


def test_live_sample_share_reads_the_tallies(tiny, monkeypatch):
    """live_sample_share.train: None on an empty store and on one whose run
    has no tallies (a port without them); after a traced tiny loop of the
    cell on the CPU, the share of the march's slots that its masks kept,
    as the masks themselves sum."""
    from torch.profiler import ProfilerActivity, profile

    from lsenerf_tpu_torch.engine import spans
    from lsenerf_tpu_torch.models import lsenerf as tmodel
    from perfbench.harness import manifest, program

    reader = manifest.metric_reader("live_sample_share.train")
    spans.reset()
    assert reader.read(None) is None
    with monkeypatch.context() as m:
        m.setattr(spans, "snapshot", lambda: [{"counters": {"steps": 4, "marked_steps": 0}}])
        assert reader.read(None) is None

    cfg, tr = tiny(CELL)
    dev = torch.device("cpu")
    sc = program.scene_for(cfg, dev)
    ref = program.reference(cfg, sc, dev)
    t = program.trainer(cfg, sc, 2**31 + 9, program.draw_params(ref, 2**31 + 9), dev)
    masks, real = [], tmodel.march.march_rays

    def watched(*a, **kw):
        out = real(*a, **kw)
        masks.append(out.mask)
        return out

    monkeypatch.setattr(tmodel.march, "march_rays", watched)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            program.train_chunks(t, tr["scan_steps"], tr["scan_steps"])
        got = reader.read(None)
    finally:
        spans.reset()
    assert len(masks) == tr["scan_steps"] and all(mk.shape[1] == 48 for mk in masks)
    live, slots = sum(int(mk.sum()) for mk in masks), sum(mk.numel() for mk in masks)
    assert 0 < live < slots
    assert got == pytest.approx(100.0 * live / slots)
