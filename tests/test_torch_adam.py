"""The port's Adam (lsenerf_tpu_torch/engine/trainer.py::build_optimizer):
torch's fused update, one pass over each leaf, on the CPU as on the card.
  - build_optimizer gives a fused torch.optim.Adam over dense f32 leaves in
    every run mode that trains, and names a leaf that is not dense;
  - Trainer.step's updates are the fused Adam's, every group fused, and
    the steps are counted while a profiler runs; a leaf without a gradient
    keeps its value and gets no state;
  - the fused update is the foreach update it replaced to f32 rounding;
  - a checkpoint written by the foreach Adam (its step counts on the CPU,
    in f32, or in f64 as a float64 default dtype left them) loads: the
    counts go beside the leaves in f32, and the next step is the foreach
    Adam's to rounding.

This file imports neither JAX nor the JAX package.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lsenerf_tpu_torch.data import datamanager as tdm
from lsenerf_tpu_torch.data import synthetic as tsyn
from lsenerf_tpu_torch.engine import checkpoints as ckpt
from lsenerf_tpu_torch.engine import spans
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops import hash_encoding as the
from lsenerf_tpu_torch.ops import occupancy as tocc


@pytest.fixture(autouse=True)
def _empty_store():
    spans.reset()
    yield
    spans.reset()


def _trainer(mode=ttr.RunMode.TRAIN, seed=0):
    """A tiny CPU trainer: RGB and events, SO3xR3 deltas, the occupancy
    update every 4 steps."""
    col, evs = tsyn.make_synthetic_scene(n_cams=4, h=16, w=16, focal=20.0)
    dm = tdm.MultiCamDataManager(tdm.DataManagerConfig(train_num_rays_per_batch=64), col, evs,
                                 seed=3)
    mcfg = tmodel.ModelConfig(
        field=tfield.FieldConfig(hash=the.HashEncodingConfig(num_levels=4, base_res=4, max_res=32,
                                                              layout="blocked", blocked_rows_log2=8)),
        grid=tocc.OccGridConfig(resolution=16, levels=1, update_interval=4),
        max_samples=16, max_candidates=64, hierarchical_march=False)
    cfg = ttr.TrainerConfig(mode=mode, seed=seed,
                            col_cam_opt=ttr.CameraOptConfig(mode="SO3xR3"),
                            evs_cam_opt=ttr.CameraOptConfig(mode="SO3xR3"))
    tr = ttr.Trainer(cfg, mcfg, dm, device="cpu")
    tr.setup()
    return tr


def _foreach_adam(optimizer):
    """The Adam build_optimizer made before its update was fused: the same
    groups, lrs and eps, capturable where this one is, the foreach update."""
    groups = [{k: v for k, v in g.items() if k in ("params", "lr", "eps", "name")}
              for g in optimizer.param_groups]
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), foreach=True,
                           capturable=optimizer.param_groups[0]["capturable"])
    opt._warned_capturable_if_run_uncaptured = True
    return opt


@pytest.mark.parametrize("mode", [ttr.RunMode.TRAIN, ttr.RunMode.EVAL])
def test_build_optimizer_is_fused_over_dense_f32_leaves(mode):
    tr = _trainer(mode)
    opt = tr.optimizer
    assert type(opt) is torch.optim.Adam
    assert [g["name"] for g in opt.param_groups] == (
        ["model", "camera_opt"] if mode == ttr.RunMode.TRAIN else ["camera_opt"])
    for g in opt.param_groups:
        assert g["fused"] and not g["foreach"] and not g["capturable"]
        assert isinstance(g["lr"], float) and g["eps"] == 1e-15
        for p in g["params"]:
            assert p.dtype == torch.float32 and p.is_contiguous()


def test_a_leaf_that_is_not_dense_is_named():
    params = {"model": {"field": {"w": torch.zeros(8, 4).t()}},
              "camera_opt": {"col": {"pose_adjustment": torch.zeros(3, 6)}}}
    with pytest.raises(ValueError, match="model/field/w"):
        ttr.build_optimizer(ttr.TrainerConfig(), params)
    params["model"]["field"]["w"] = params["model"]["field"]["w"].contiguous()
    opt, _, paths = ttr.build_optimizer(ttr.TrainerConfig(), params)
    assert paths == [["model/field/w"], ["camera_opt/col/pose_adjustment"]]
    assert all(g["fused"] for g in opt.param_groups)


def test_steps_count_their_fused_updates_while_traced():
    tr = _trainer()
    batches = [tr.dm.next_train(i) for i in range(4)]
    tr.step(batches[0])  # untraced: nothing recorded
    assert spans.snapshot() == []
    with profile(activities=[ProfilerActivity.CPU]), spans.run():
        for b in batches[1:]:
            tr.step(b)
    run, = spans.snapshot()
    assert run["counters"]["steps"] == 3
    assert tr.optimizer.param_groups and all(g["fused"] for g in tr.optimizer.param_groups)


def test_a_leaf_without_a_gradient_is_skipped():
    tr = _trainer()
    tr.step(tr.dm.next_train(0))
    leaves = dict(tree_leaves(tr.params))
    before = {p: t.detach().clone() for p, t in leaves.items()}
    state = {p: {k: v.clone() for k, v in tr.optimizer.state[t].items()}
             for p, t in leaves.items() if t in tr.optimizer.state}
    skipped = "model/field/hash_table"
    for p, t in leaves.items():
        t.grad = None if p == skipped else torch.ones_like(t)
    tr.optimizer.step()
    assert torch.equal(leaves[skipped], before[skipped])
    assert all(torch.equal(v, state[skipped][k])
               for k, v in tr.optimizer.state[leaves[skipped]].items())
    moved = [p for p, t in leaves.items() if p in state and not torch.equal(t, before[p])]
    assert moved and skipped not in moved


def test_fused_update_is_the_foreach_update_to_rounding():
    """16 updates of both on the same gradients, a quarter of the table's
    rows with zero gradient (rows no sample touched) and the rest spanning
    six decades: per leaf, the gap between the two parameters' changes
    over the foreach change, both by norm, stays at f32 rounding."""
    g = torch.Generator().manual_seed(0)
    shapes = {"model/table": (4096, 2), "model/w": (64, 64), "model/b": (64,),
              "camera_opt/pose": (3, 6)}
    init = {p: torch.randn(s, generator=g) * 1e-2 for p, s in shapes.items()}

    def params():
        out = {"model": {}, "camera_opt": {}}
        for p, v in init.items():
            top, name = p.split("/")
            out[top][name] = v.clone().requires_grad_(True)
        return out

    fused_params, foreach_params = params(), params()
    fused, schedules, paths = ttr.build_optimizer(ttr.TrainerConfig(), fused_params)
    foreach = _foreach_adam(ttr.build_optimizer(ttr.TrainerConfig(), foreach_params)[0])
    for step in range(16):
        grads = {}
        for p, s in shapes.items():
            v = torch.randn(s, generator=g) * 10.0 ** torch.randint(-6, 0, s, generator=g)
            if p == "model/table":
                v[torch.rand(s[0], generator=g) < 0.25] = 0.0
            grads[p] = v
        for opt, tree in ((fused, fused_params), (foreach, foreach_params)):
            for p, t in tree_leaves(tree):
                t.grad = grads[p].clone()
            ttr.set_lrs(opt, schedules, step)
            opt.step()
    a = {p: t.detach() for p, t in tree_leaves(fused_params)}
    b = {p: t.detach() for p, t in tree_leaves(foreach_params)}
    gaps = {p: float((a[p] - b[p]).norm() / (b[p] - init[p]).norm()) for p in shapes}
    assert max(gaps.values()) < 1e-6, gaps
    st = fused.state[fused_params["model"]["table"]]
    assert float(st["step"]) == 16.0 and st["step"].dtype == torch.float32


@pytest.mark.parametrize("step_dtype", [torch.float32, torch.float64])
def test_a_foreach_checkpoint_loads_into_the_fused_adam(tmp_path, step_dtype):
    old = _trainer()
    old.optimizer = _foreach_adam(old.optimizer)
    batches = [old.dm.next_train(i) for i in range(5)]
    for b in batches[:4]:
        old.step(b)
    d = str(tmp_path / "ckpts")
    ckpt.save_checkpoint(d, 3, old)
    step, params, occ, opt, rng = ckpt.load_checkpoint_full(d)
    for st in opt["adam"].values():
        assert st["step"].device.type == "cpu" and float(st["step"]) == 4.0
        st["step"] = st["step"].to(step_dtype)
    new = _trainer(seed=7)
    assert ckpt.restore_into_state(new, params, occ, step, opt=opt, rng=rng)
    assert all(g["fused"] for g in new.optimizer.param_groups) and new.opt_count == 4
    for p, t in tree_leaves(new.params):
        st = new.optimizer.state.get(t)
        if st is None:
            continue
        assert st["step"].device == t.device and st["step"].dtype == torch.float32, p
        assert st["step"] is not opt["adam"][p]["step"]
    # one step on: the same gradients, the two updates' rounding apart
    old.step(batches[4])
    new.step(batches[4])
    sa, sb = old.adam_state(), new.adam_state()
    assert set(sa) == set(sb)
    for p in sa:
        assert float(sb[p]["step"]) == 5.0
    for (p, t), (_, u) in zip(tree_leaves(old.params), tree_leaves(new.params)):
        torch.testing.assert_close(u, t, rtol=1e-5, atol=1e-6, msg=p)


def test_profile_steps_layer_table_lists_each_layers_kernels():
    """profile_step.py's layer table puts a kernel in the outermost layer
    range open when its op started, and lists each layer's kernels by
    device time (how a kernel row of a trace is tied to Adam)."""
    from types import SimpleNamespace as NS

    from lsenerf_tpu_torch import profile_step

    def ev(name, start, end, kernels=()):
        return NS(name=name, device_type=NS(name="CPU"), time_range=NS(start=start, end=end),
                  kernels=[NS(name=k, duration=d) for k, d in kernels])

    events = [ev("layer:backward", 0, 100), ev("layer:adam", 100, 200),
              ev("aten::mul", 10, 20, [("mul_kernel", 30.0)]),
              ev("aten::_fused_adam_", 110, 120, [("FusedAdamMathFunctor", 50.0)]),
              ev("aten::div_", 130, 140, [("div_kernel", 20.0), ("div_kernel", 20.0)]),
              ev("aten::copy_", 210, 220, [("copy_kernel", 1.0)])]
    table = profile_step.layer_table(events, steps=2)
    assert table["adam"] == (1.5, 0.045, 0.05) and table["backward"] == (0.5, 0.015, 0.05)
    assert table["other"][:2] == (0.5, 0.0005)
    kernels = profile_step.layer_kernels(events, steps=2)
    assert kernels["adam"] == [("FusedAdamMathFunctor", 0.025, 0.5), ("div_kernel", 0.02, 1.0)]
    assert kernels["backward"] == [("mul_kernel", 0.015, 0.5)]
