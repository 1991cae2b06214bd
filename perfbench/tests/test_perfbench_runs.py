"""Whole runs of the harness on the CPU at a tiny size (the look for a card
skipped): the result line's keys, the way back to a trainer's start, and
`correct` coming out false with the timed path broken underneath, once
for each fault a cell can have."""

from __future__ import annotations

import json
import sys
import types

import pytest
import torch

from perfbench.harness import core


def test_train_result_line(run_tiny):
    got = run_tiny("lsenerf.train")
    assert list(got) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert got["correct"] is True and got["attempted"] > 0 and got["failed"] == 0
    assert set(got["metrics"]) == {"step_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in got["metrics"].values())
    assert set(got["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(got["checks"]) == {"loss_gap", "grad_gap", "change_gap", "replay_change_gap",
                                 "batches"}
    assert all(set(c) == {"value", "limit"} for c in got["checks"].values())
    json.dumps(got)


def test_traced_train_result_line(run_tiny):
    got = run_tiny("badnerf_ngp_f32.train", trace=1)
    assert list(got)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(got)[-1] == "checks" and {"device", "breakdown"} <= set(got)
    assert got["correct"] is True and got["attempted"] == 4
    # the CPU reports no device metric
    assert got["metrics"] == {}
    assert {"busy_s", "window_s"} <= set(got["device"])
    assert set(got["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(got["checks"]) == {"loss_gap", "grad_gap", "change_gap", "replay_change_gap",
                                 "batches"}


def test_a_state_left_unchanged_is_not_correct(run_tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a, **k: None)
    got = run_tiny("badnerf_ngp_f32.train")
    assert got["correct"] is False
    assert got["checks"]["change_gap"]["value"] > got["checks"]["change_gap"]["limit"]


def test_half_the_batch_left_out_is_not_correct(run_tiny, monkeypatch):
    from lsenerf_tpu_torch.engine.trainer import Trainer

    real = Trainer.loss_fn

    def half(self, params, occ, batch, step, bg_color=None, gates=None):
        cut = {k: v[: max(1, len(v) // 2)] for k, v in batch.items()}
        bg = None if bg_color is None else bg_color[: self.num_rays(cut)]
        return real(self, params, occ, cut, step, bg, gates)

    monkeypatch.setattr(Trainer, "loss_fn", half)
    got = run_tiny("lsenerf.train")
    assert got["correct"] is False


def test_restart_returns_the_trainer_to_its_start(tiny):
    """A chunk run after program.restart (with the sampler's draws set back
    too) repeats the first chunk's losses bit for bit: weights, Adam's
    moments and counts, the generators, the grid and the step all went
    back."""
    from perfbench.harness import program

    cfg, tr = tiny("lsenerf.train")
    dev = torch.device("cpu")
    sc = program.scene_for(cfg, dev)
    ref = program.reference(cfg, sc, dev)
    params0 = program.draw_params(ref, 2**31 + 3)
    t = program.trainer(cfg, sc, 2**31 + 3, params0, dev)
    start, draws = program.start_of(t), t.dm.rng.bit_generator.state
    k = tr["scan_steps"]
    program.train_chunks(t, 2 * k, k)
    first = [float(x) for x in t.chunk_losses]
    program.restart(t, params0, start)
    t.dm.rng.bit_generator.state = draws
    program.train_chunks(t, k, k)
    program.train_chunks(t, k, k)
    assert [float(x) for x in t.chunk_losses] == first and t.step_count == 2 * k


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    rc = core.main(["--workload", "lsenerf.train", "--seed", "1", "--seconds", "1"])
    assert rc == 2 and capsys.readouterr().out == ""


def test_a_loaded_jax_withholds_the_result(monkeypatch, capsys):
    monkeypatch.setattr(core, "run_cell", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = core.main(["--workload", "lsenerf.train", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "jax" in out.err
