"""The bundles layer's wrapper (lsenerf_tpu_torch/ops/bundles.py) on the
CPU, where it runs its plain version: for every camera-pose source a step's
bundles take (the spline with and without deblur, the event spline through
dM and its scale, SO3xR3 and SE3 deltas, prevnext's two delta sets, none)
and both values of the delayed-activation gate, the step's rays and the
gradient of every camera leaf equal those of the composition the trainer
had (tests/torch_bundle_cases.today); the parts a trainer builds for each
optimizer; the wrapper's refusals; and one call of the wrapper a train
step."""

import ctypes
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_bundle_cases as cases
from lsenerf_tpu_torch.engine import spans
from lsenerf_tpu_torch.engine.loop import run_training_loop
from lsenerf_tpu_torch.ops import bundles


def _rays(inputs, gates, fn):
    """(bundle, camera leaf gradients) of fn(cam_params, batch, gates) under
    a fixed linear loss, from fresh copies of the step's leaves."""
    _, cam_params, batch = cases.on_device(inputs, "cpu")[:3]
    big = fn(cam_params, batch, gates)
    loss = cases.loss_of(big, cases.cotangents(len(big)))
    if loss.requires_grad:  # with no camera leaf ("none") nothing does
        loss.backward()
    return big, cases.leaf_grads(cam_params)


@pytest.mark.parametrize("gate", [1.0, 0.0])
@pytest.mark.parametrize("case", list(cases.CASES))
def test_plain_matches_the_composition(case, gate):
    tr = cases.case_trainer(case)

    def wrapper(cam_params, batch, gates):
        return bundles.step_rays(tr._parts(), cam_params, batch, gates, tr.col_spline_static,
                                 tr.rgb_ts, tr.dm.num_embd)[0]

    def composition(cam_params, batch, gates):
        return cases.today(tr, cam_params, batch, gates)

    inputs = cases.step_inputs(tr)
    got, g_got = _rays(inputs, (gate, gate), wrapper)
    want, g_want = _rays(inputs, (gate, gate), composition)
    for name in cases.FIELDS:
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0, atol=0,
                                   msg=name)
    torch.testing.assert_close(got.metadata["appearance_id"], want.metadata["appearance_id"],
                               rtol=0, atol=0)
    assert g_got.keys() == g_want.keys()
    for path, g in g_want.items():
        if g is None:
            assert g_got[path] is None, path
            continue
        torch.testing.assert_close(g_got[path], g, rtol=0, atol=0, msg=path)
        if gate == 0.0:
            assert not g.any(), path
    assert any(g is not None and g.any() for g in g_want.values()) == (gate == 1.0
                                                                       and case != "none")


@pytest.mark.parametrize("case", list(cases.CASES))
def test_step_bundles_sizes_and_targets(case):
    """The trainer's _step_bundles: the sizes of its parts, in order, sum
    to the bundle's rays and to num_rays; the denerf shortcut drops the
    next event bundle."""
    tr = cases.case_trainer(case)
    batch = tr.batch_to_device(tr.dm.next_train(0))
    big, sizes, col_batch, evs_batch = tr._step_bundles(tr.params["camera_opt"], batch, 0)
    assert sizes == tr.bundle_sizes(batch) and sum(sizes) == len(big) == tr.num_rays(batch)
    assert col_batch is not None and evs_batch is not None
    parts = tr._make_parts(tr.model_config.rgb_loss_type == "deblur", True)
    assert len(parts) == 2 and parts[:2] == tr._parts()[:2]
    want = cases.today(tr, tr.params["camera_opt"], batch, (1.0, 1.0), denerf=True)
    got, _ = bundles.step_rays(parts, tr.params["camera_opt"], batch, (1.0, 1.0),
                               tr.col_spline_static, tr.rgb_ts, tr.dm.num_embd)
    torch.testing.assert_close(got.origins, want.origins, rtol=0, atol=0)


# each case's parts: (pose, table) of RGB, prev and next
PARTS = {
    "spline": [(bundles.SPLINE, ("col",)), (bundles.SO3XR3, ("evs",)), (bundles.SO3XR3, ("evs",))],
    "spline_deblur": [(bundles.SPLINE, ("col",)), (bundles.SO3XR3, ("evs",)),
                      (bundles.SO3XR3, ("evs",))],
    "event_spline": [(bundles.SPLINE, ("col",)), (bundles.SPLINE_EVS, ("col",)),
                     (bundles.SPLINE_EVS, ("col",))],
    "so3xr3": [(bundles.SO3XR3, ("col",)), (bundles.SO3XR3, ("evs",)), (bundles.SO3XR3, ("evs",))],
    "se3": [(bundles.SE3, ("col",)), (bundles.SE3, ("evs",)), (bundles.SE3, ("evs",))],
    "prevnext": [(bundles.SPLINE, ("col",)), (bundles.SO3XR3, ("evs", "prev")),
                 (bundles.SO3XR3, ("evs", "next"))],
    "none": [(bundles.FIXED, ()), (bundles.FIXED, ()), (bundles.FIXED, ())],
}


@pytest.mark.parametrize("case", list(cases.CASES))
def test_parts_of_each_optimizer(case):
    tr = cases.case_trainer(case)
    parts = tr._parts()
    assert [(p.pose, p.table) for p in parts] == PARTS[case]
    deblur = cases.CASES[case].get("deblur", False)
    assert parts[0].rep == (4 if deblur else 1) and parts[0].app_deblur == deblur
    assert [p.gate for p in parts] == [0, 1, 1] and [p.snap for p in parts] == [False, True, True]
    next_offset = 0 if cases.CASES[case].get("prevnext") else 1
    assert [p.cam_offset for p in parts] == [0, 0, next_offset]
    assert tr._parts() is parts  # built once a model config


def test_rgb_only_run_has_one_part():
    tr = cases.case_trainer("spline_deblur", rgb_only=True)
    assert [(p.pose, p.rows) for p in tr._parts()] == [(bundles.SPLINE, "col_indices")]
    batch = tr.batch_to_device(tr.dm.next_train(0))
    big, sizes = bundles.step_rays(tr._parts(), tr.params["camera_opt"], batch, (1.0, 1.0),
                                   tr.col_spline_static, tr.rgb_ts, tr.dm.num_embd)
    want = cases.today(tr, tr.params["camera_opt"], batch, (1.0, 1.0))
    assert sizes == [len(want)]
    torch.testing.assert_close(big.directions, want.directions, rtol=0, atol=0)


def test_the_gate_as_a_device_value():
    """A 0-dim tensor gate (a replayed graph's) gives the float gate's rays
    and gradients."""
    tr = cases.case_trainer("event_spline")

    def fn(cam_params, batch, gates):
        return bundles.step_rays(tr._parts(), cam_params, batch, gates, tr.col_spline_static,
                                 tr.rgb_ts, tr.dm.num_embd)[0]

    inputs = cases.step_inputs(tr)
    a, ga = _rays(inputs, (1.0, 1.0), fn)
    b, gb = _rays(inputs, (torch.tensor(1.0), torch.tensor(1.0)), fn)
    torch.testing.assert_close(a.origins, b.origins, rtol=0, atol=0)
    for path in ga:
        torch.testing.assert_close(ga[path], gb[path], rtol=0, atol=0, msg=path)


def test_fixed_rays_refuses_the_cpu_and_a_pose_gradient():
    tr = cases.case_trainer("none")
    cams = tr.col_cams
    idx = torch.zeros(4, dtype=torch.long)
    coords = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        bundles.fixed_rays(cams, idx, coords)
    c2w = cams.camera_to_worlds[:1].clone().requires_grad_(True)
    # the CPU's generate_rays is the plain version, which differentiates
    assert cases.tcams.generate_rays(cams, idx, coords, c2w=c2w.expand(4, 3, 4)).origins.requires_grad


def _c_fields(src: str, struct: str) -> list:
    """The field names of a C struct in csrc/bundles.cu, in order."""
    body = src[src.index(f"struct {struct} {{") + len(struct) + 9:]
    body = body[:body.index("};")]
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = re.sub(r"\[[^]]*\]", "", decl).strip()
        if decl:
            first, *rest = decl.split(",")
            names += [first.split()[-1].lstrip("*")] + [r.strip() for r in rest]
    return names


def test_the_structs_mirror_the_kernel():
    """The ctypes mirrors of csrc/bundles.cu's structs: the same fields in
    the same order; a Part is 9 pointers, 5 floats and 9 ints (128 bytes), a
    Target a pointer and 4 ints, RaysArgs MAX_PARTS of each, 17 pointers, 2
    floats and 7 ints."""
    src = bundles.SOURCE.read_text()
    for c, py in (("Part", bundles._Part), ("Target", bundles._Target),
                  ("RaysArgs", bundles._RaysArgs)):
        assert _c_fields(src, c) == [f for f, _ in py._fields_], c
    assert f"#define MAX_PARTS {bundles.MAX_PARTS}" in src
    assert ctypes.sizeof(bundles._Part) == 128 and ctypes.sizeof(bundles._Target) == 24
    assert ctypes.sizeof(bundles._RaysArgs) == (128 + 24) * bundles.MAX_PARTS + 17 * 8 + 2 * 4 \
        + 7 * 4 + 4


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_bundle_kernel_steps_counts_every_step(monkeypatch, scan_steps):
    """Every train step's rays come from one call of step_rays (eager
    steps, and chunks of eager steps on the CPU), which on the CPU runs
    its plain version and launches no kernel."""
    tr = cases.case_trainer("spline_deblur")
    calls, real = [], bundles.step_rays

    def counted(*a, **kw):
        calls.append(tr.step_count)
        return real(*a, **kw)

    monkeypatch.setattr(bundles, "step_rays", counted)
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        run_training_loop(tr, num_steps=6, scan_steps=scan_steps)
    run, = spans.snapshot()
    spans.reset()
    c = run["counters"]
    assert c["steps"] == 6 and calls == list(range(6))
    assert not c["launches"].get("rays_fwd") and not c["launches"].get("rays_bwd")
