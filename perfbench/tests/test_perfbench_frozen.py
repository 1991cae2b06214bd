"""The yardstick's frozen pieces on hand-worked shapes: the bound rule,
the model FLOPs, the timeline arithmetic, the scene against the port's
generator, and the reference against the port's plain path at a tiny
size on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.frozen import bounds, presets, timeline
from perfbench.frozen.ref.ops import hash_encoding as he
from perfbench.frozen.scene import make_scene
from perfbench.harness import session


def test_bound_is_the_larger_of_bytes_and_operations():
    assert bounds.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert bounds.bound_s(0, 67e12) == pytest.approx(1.0)
    assert bounds.bound_s(3.35e9, 67e12) == pytest.approx(1.0)


def test_blocked_encode_bound_by_hand():
    """One sample in two dense 4^3 levels touches one row a level; its bytes
    are the position, each row's 27 F values and the outputs; the backward
    adds dpos and the whole f32 gradient table."""
    cfg = he.HashEncodingConfig(num_levels=2, base_res=4, max_res=4, layout="blocked")
    lv = he.levels_for(cfg, torch.device("cpu"))
    pos = torch.tensor([[0.1, 0.1, 0.1]])
    fwd, bwd = bounds.blocked_encode(pos, lv, 4)
    F = lv.F
    fwd_bytes = 12 + 2 * 27 * F * 4 + 2 * F * 4
    fwd_ops = 2 * (3 * 4 + 9 + 27 + 27 * F * 2)
    assert fwd == pytest.approx(max(fwd_bytes / 3.35e12, fwd_ops / 67e12))
    bwd_bytes = fwd_bytes + 12 + lv.total_rows * lv.row_width * 4
    assert bwd == pytest.approx(bwd_bytes / 3.35e12)
    # the same sample twice touches the same rows: the table counts once
    fwd2, _ = bounds.blocked_encode(pos.repeat(2, 1), lv, 4)
    assert fwd2 * 3.35e12 == pytest.approx(fwd_bytes + 12 + 2 * F * 4)


def test_ngp_encode_bound_by_hand():
    """A sample strictly inside a cell of two dense levels touches 8 entries a level."""
    cfg = he.HashEncodingConfig(num_levels=2, base_res=4, max_res=4, layout="ngp")
    lv = he.levels_for(cfg, torch.device("cpu"))
    pos = torch.tensor([[0.3, 0.3, 0.3]])
    fwd, _ = bounds.ngp_encode(pos, lv, 2, 4)
    assert fwd * 3.35e12 == pytest.approx(12 + 2 * 8 * 2 * 4 + 2 * 2 * 4)


def test_model_flops_of_the_configurations():
    """~68 kFLOP a sample forward and backward at the CLI's widths: density
    32 -> 64 -> 16, colour 63 -> 64 -> 64 -> 3, and 16 levels x 8 corners x
    F 2 of interpolation."""
    from perfbench.frozen.ref.models import field as field_lib

    mcfg = presets.model_config("lsenerf")
    gen = torch.Generator().manual_seed(0)
    fp = field_lib.init_field(gen, mcfg.field, 4)
    assert session.mlp_flops(fp, density_only=True) == 2 * (32 * 64 + 64 * 16)
    assert session.mlp_flops(fp) == 2 * (32 * 64 + 64 * 16 + 63 * 64 + 64 * 64 + 64 * 3)
    assert session.encode_flops(mcfg.field.hash) == 16 * 2 * 8 * 2
    assert 3 * (session.mlp_flops(fp) + session.encode_flops(mcfg.field.hash)) == 69888


def test_ray_budget_matches_the_paper():
    assert presets.ray_budget("lsenerf") == (579, 597)
    assert presets.ray_budget("badnerf") == (878, 0)


def test_timeline_union_and_gaps():
    spans = [(0, 10), (5, 20), (30, 40)]
    assert timeline.busy_s(spans) == pytest.approx(30e-6)
    assert timeline.gaps(spans, 0, 50) == [(20, 30), (40, 50)]
    host = [("outer", 0, 100), ("inner", 18, 35)]
    assert timeline.open_host_op(host, 25) == "inner"
    assert timeline.open_host_op(host, 45) == "outer"
    assert timeline.open_host_op(host, 150) == "idle"


def test_scene_matches_the_ports_generator():
    """The torch scene is the port's make_synthetic_scene read back as the
    CLI reads it: 8-bit frames (to one quantum) and the same event counts."""
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene

    sc = make_scene(8, 24, 32, 0.9 * 32, 24.0, 2, device="cpu")
    col, evs = make_synthetic_scene(n_cams=8, h=24, w=32, focal=0.9 * 32, texture_freq=24.0)
    img8 = np.clip(col.images * 255 + 0.5, 0, 255).astype(np.uint8) / 255.0
    assert sc.images.shape == (5, 24, 32, 3)
    assert np.abs(sc.images - img8[:5]).max() <= 1 / 255 + 1e-7
    counts = np.rint(np.asarray(evs.eimgs)[..., 0] * 0.2 / sc.e_thresh)
    assert np.array_equal(sc.eimgs[..., 0], counts)
    np.testing.assert_array_equal(sc.c2ws, col.cameras.camera_to_worlds.numpy()[:5])
    assert sc.full_c2ws.shape == (16, 3, 4)
