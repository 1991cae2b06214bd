"""The lsenerf_emb preset's train step (one 32-wide appearance code a frame,
`evs_emb`, and no proposal, so 48 march slots a ray) against the
benchmark's plain reference, `perfbench/frozen/ref`'s Step, at a tiny
size on the CPU: the benchmark's own configuration file
(perfbench/configs/lsenerf_emb.json) at its widths, on a 32x24 scene of 48
frames with 64 rays a step, from weights drawn from a seed, the same
occupancy update and the same batch.

Compared: the loss; every leaf's gradient, the per-frame table's too,
whose rows the batch does not name get exactly zero on both sides; and
the port's tallies (engine/spans.py) of the march, "live_samples" and
"sample_slots", against the reference's mask summed and its rays x 48.
A planted fault (the shared code in place of the per-frame one, or the
proposal's 16 samples a ray) fails the same comparison.

This file imports neither JAX nor the JAX package.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lsenerf_tpu_torch import flagship
from lsenerf_tpu_torch.engine import spans
from lsenerf_tpu_torch.models import embeddings as emb_lib
from perfbench.frozen.ref.ops import march as ref_march
from perfbench.harness import checks, manifest, program

SEED = 2**31 + 7
SCENE = dict(n_cams=48, h=24, w=32, focal=0.9 * 32, texture_freq=24.0, n_val=2)
RAYS = 64
SLOTS = 48  # the march's slots a ray with no proposal (max_samples)

# The first loss: both sides run the same f32 ops in the same order on the
# CPU (it comes out the same bits); 1e-5 leaves room for a reordered sum,
# under the planted faults' 1.9e-2 (shared code) and 1.8e-5 (F = 16).
LOSS_RTOL = 1e-5
# Gradients, as the port's parity tests hold them: the bf16 table gather
# and MLP inputs round the same on both sides, and what is left is the
# order of the backward's f32 sums (scatter-adds into the tables).
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-6


@pytest.fixture(autouse=True)
def _empty_store():
    spans.reset()
    yield
    spans.reset()


def _config() -> dict:
    man = manifest.manifest()
    cfg = manifest.config(manifest.cell("lsenerf_emb.train", man)["config"], man)
    return dict(cfg, rays_per_batch=RAYS, scene=SCENE)


def _touched_rows(batch: dict, num_embd: int) -> set:
    """The table rows the batch names: each RGB pixel's frame and its
    deblur neighbours (-2..+1, clamped), each event ray's frame."""
    col = np.asarray(batch["col_app_id"]).reshape(-1)
    rows = np.clip(col[:, None] + np.arange(-2, 2)[None], 0, num_embd - 1)
    return set(rows.reshape(-1).tolist()) | set(np.asarray(batch["evs_app_id"]).reshape(-1).tolist())


def _sides(monkeypatch, fault: str = ""):
    """One step of each side from the seed's weights and start: the port's
    loss, gradients and tallies, the reference's loss, gradients, live
    slots and slots, and the rows the batch names."""
    cfg = _config()
    dev = torch.device("cpu")
    sc = program.scene_for(cfg, dev)
    ref = program.reference(cfg, sc, dev)
    params0 = program.draw_params(ref, SEED)

    if fault == "shared code":
        real = emb_lib.apply_embedding

        def shared(params, config, ids, train=True):
            return real(params, config, torch.zeros_like(ids), train)

        monkeypatch.setattr(emb_lib, "apply_embedding", shared)
    elif fault == "F=16":
        real_cfgs = flagship.preset_configs

        def proposal(*a, **kw):
            tcfg, mcfg, dmc = real_cfgs(*a, **kw)
            return tcfg, dataclasses.replace(mcfg, proposal_samples=16), dmc

        monkeypatch.setattr(flagship, "preset_configs", proposal)

    t = program.trainer(cfg, sc, SEED, params0, dev)
    t.occ_update()
    batch = t.dm.next_train(0)
    with profile(activities=[ProfilerActivity.CPU]), spans.run():
        loss, _, grads = t.grads(t.batch_to_device(batch))
    counters = spans.snapshot()[-1]["counters"]
    port = {"loss": float(loss.detach()), "grads": {p: g.detach() for p, g in grads.items()},
            "live": counters["live_samples"], "slots": counters["sample_slots"]}

    masks = []
    real_march = ref_march.march_rays

    def watched(*a, **kw):
        out = real_march(*a, **kw)
        masks.append(out.mask)
        return out

    monkeypatch.setattr(ref_march, "march_rays", watched)
    ref.start(params0, SEED)
    ref.occ_update()
    got = ref.step(checks.batch_tensors({k: np.asarray(v)[None] for k, v in batch.items()}, 0,
                                        dev))
    mask, = masks
    want = {"loss": got["loss"], "grads": got["grads"], "live": int(mask.sum()),
            "slots": ref.num_rays() * SLOTS}
    return port, want, _touched_rows(batch, ref.num_embd), ref.num_embd


def _mismatches(port: dict, want: dict) -> list:
    """What differs beyond the tolerances (module doc)."""
    out = []
    if not port["loss"] == pytest.approx(want["loss"], rel=LOSS_RTOL):
        out.append(f"loss {port['loss']} / {want['loss']}")
    for path, g in want["grads"].items():
        p = port["grads"][path]
        g = torch.zeros_like(p) if g is None else g
        if not torch.allclose(p, g, rtol=GRAD_RTOL, atol=GRAD_ATOL):
            out.append(f"{path}: largest gap {float((p - g).abs().max()):.3e}")
    for key in ("live", "slots"):
        if port[key] != want[key]:
            out.append(f"{key} {port[key]} / {want[key]}")
    return out


def test_lsenerf_emb_step_is_the_references(monkeypatch):
    port, want, touched, rows = _sides(monkeypatch)
    assert _mismatches(port, want) == []
    # the batch names some of the frames and not all
    assert 0 < len(touched) < rows
    for side in (port["grads"], want["grads"]):
        table = side["model/field/appearance/table"]
        assert table.shape == (rows, 32)
        nonzero = set(torch.nonzero(table.abs().sum(1)).reshape(-1).tolist())
        assert nonzero == touched
    # 11 RGB pixels x 4 deblur rays + 2 x 10 event rays, 48 slots each
    assert want["slots"] == 64 * SLOTS
    # dead slots: the march keeps fewer than all of them, and some
    assert 0 < port["live"] < port["slots"]


@pytest.mark.parametrize("fault", ["shared code", "F=16"])
def test_a_planted_fault_fails_the_comparison(monkeypatch, fault):
    port, want, _, _ = _sides(monkeypatch, fault)
    got = _mismatches(port, want)
    assert got
    if fault == "shared code":
        assert any(m.startswith("model/field/appearance/table") for m in got), got
    else:
        assert any(m.startswith("slots") for m in got), got
