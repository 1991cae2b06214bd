"""The reference against the port's plain path at a tiny size on the CPU
(the same numbers, to Adam's rounding), its control (one step below the configuration's
precision) against the cell's limits, and the same control on the card at
the cell's own widths, on a scene cut in frames."""

from __future__ import annotations

import pytest
import torch

from perfbench import readings
from perfbench.harness import manifest, program

SEED = 2**31 + 5


def _limits_failed(cell: str, numbers: dict) -> list:
    lim = manifest.limits(cell)
    return [n for n, v in numbers.items() if n in lim and not v <= lim[n]["limit"]]


@pytest.mark.parametrize("cell", ["lsenerf.train", "badnerf_ngp_f32.train"])
def test_reference_steps_are_the_ports_on_the_cpu(tiny, cell):
    cfg, tr = tiny(cell)
    dev = torch.device("cpu")
    sc = program.scene_for(cfg, dev)
    got = readings.train_readings(cfg, tr, dev, SEED, sc, control=cfg["control"] == "fp8",
                                  faults=True)
    # the first loss is the same bits; Adam's own rounding then moves the
    # next ones by ~1e-7
    assert got["losses"]["program"][0] == got["losses"]["reference"][0]
    assert got["sound"]["loss_gap"] < 1e-6
    assert not _limits_failed(cell, got["sound"])
    assert _limits_failed(cell, got["fault_half_batch"])
    if "control" in got:
        assert _limits_failed(cell, got["control"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["lsenerf.train", "badnerf_ngp_f32.train"])
def test_control_is_not_correct_on_card(cell):
    """The cell's configuration at its own widths and ray budget on 24
    frames of the real-scale profile: the program passes its limits and the
    control (fp8 or tf32) fails one of them, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    man = manifest.manifest()
    w = manifest.cell(cell, man)
    cfg = manifest.config(w["config"], man)
    cfg = dict(cfg, scene=dict(cfg["scene"], n_cams=24, n_val=2))
    tr = manifest.traffic(w["traffic"])
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    program.build_kernels(dev)
    sc = program.scene_for(cfg, dev)
    for seed in (SEED, SEED + 1, SEED + 2):
        got = readings.train_readings(cfg, tr, dev, seed, sc, control=True, faults=False)
        assert not _limits_failed(cell, got["sound"]), got
        assert _limits_failed(cell, got["control"]), got
