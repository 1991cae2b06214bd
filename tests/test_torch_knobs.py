"""The off-default knobs of the port against the JAX package, on the small
parity configuration (tests/torch_parity.py) with JAX's params carried
across: compact_chunk (the field on the live chunks of the validity-sorted
samples; mirrors tests/test_march_composite.py's compact test and
tests/test_field.py's exclusion of coarse_stride), and
proposal_warmup_steps (the CLI's two phases: the proposal off, then at F;
the repo's train.py)."""

import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.models import field as jfield
from lsenerf_tpu.models import lsenerf as jmodel
from lsenerf_tpu_torch import train
from lsenerf_tpu_torch.data.synthetic import write_reference_scene
from lsenerf_tpu_torch.engine import trainer as ttr
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import field as tfield
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.ops.fast_gather import permute

import torch_parity
from test_torch_cli import TINY_MODEL
from test_torch_config import train_argv


def _jax_step(jt, state, batch, seed=5):
    """JAX's loss, metrics and gradients of one step, and the background
    its render_rgb draws."""
    rng = jax.random.PRNGKey(seed)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    probe = jt.make_overflow_probe()
    # JAX's hashed-level table gradient is exact only without window overflow
    assert int(probe(state.params, state.occ, jb, jnp.int32(0))) == 0
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jt._build_loss_fn(), has_aux=True))(
        state.params, state.occ, jb, jnp.int32(0), rng)
    return loss, metrics, dict(tree_leaves(jax.tree.map(np.asarray, grads))), rng


def _match_jax(tt, batch, jax_step):
    """The port's step at the same batch and background against JAX's:
    loss within 1e-5, gradients as tests/test_torch_train_step.py holds
    them (rtol 1e-3, atol 1e-6)."""
    loss, metrics, jg, rng = jax_step
    tb = tt.batch_to_device(batch)
    bg = torch.from_numpy(np.asarray(jax.random.uniform(rng, (tt.num_rays(tb), 3))))
    tloss, tmetrics, tgrads = tt.grads(tb, bg_color=bg)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    np.testing.assert_allclose(float(tmetrics["num_samples_per_ray"]),
                               float(metrics["num_samples_per_ray"]), rtol=1e-5)
    assert set(jg) == set(tgrads)
    for path, g in jg.items():
        np.testing.assert_allclose(tgrads[path].numpy(), g, rtol=1e-3, atol=1e-6, err_msg=path)
    return float(tloss.detach()), {k: v.clone() for k, v in tgrads.items()}


def test_permute_and_its_gather_backward():
    x = torch.randn(10, 3, dtype=torch.float64, requires_grad=True)
    order = torch.randperm(10, generator=torch.Generator().manual_seed(0))
    inv = torch.argsort(order)
    y = permute(x, order, inv)
    assert torch.equal(y, x[order])
    g = torch.randn(10, 3, dtype=torch.float64)
    (y * g).sum().backward()
    assert torch.equal(x.grad, g[inv])
    assert torch.autograd.gradcheck(lambda v: permute(v, order, inv), (x.detach().requires_grad_(),))


@pytest.fixture(scope="module")
def compact_pair():
    """JAX and port trainers at compact_chunk 64 (the step renders 96
    rays x 8 samples, so 12 chunks, most of them dead on the sparse grid),
    one batch, and JAX's step on it."""
    jt, state, tt = torch_parity.trainers(model=dict(compact_chunk=64))
    batch = jt.dm.next_train(0)
    return jt, state, tt, batch, _jax_step(jt, state, batch)


def test_compact_matches_jax_compact(compact_pair):
    jt, state, tt, batch, jax_step = compact_pair
    assert jt.model_config.compact_chunk == tt.model_config.compact_chunk == 64
    _match_jax(tt, batch, jax_step)


def test_compact_equals_dense(compact_pair):
    """The port's compact path against its dense one on the same batch and
    background: loss, outputs and every gradient within 1e-5."""
    _, _, tt, batch, _ = compact_pair
    tb = tt.batch_to_device(batch)
    bg = torch.rand((tt.num_rays(tb), 3), generator=torch.Generator().manual_seed(3))
    lc, _, gc = tt.grads(tb, bg_color=bg)
    gc = {k: v.clone() for k, v in gc.items()}
    with tt.model_override(compact_chunk=0):
        ld, _, gd = tt.grads(tb, bg_color=bg)
    np.testing.assert_allclose(float(lc.detach()), float(ld.detach()), rtol=1e-5)
    for path in gd:
        np.testing.assert_allclose(gc[path].numpy(), gd[path].numpy(), atol=1e-5, err_msg=path)
    # the rendered outputs themselves, in eval mode
    bundle = tt._step_bundles(tt.params["camera_opt"], tb, 0)[0]
    outs = []
    for chunk in (64, 0):
        with tt.model_override(compact_chunk=chunk):
            outs.append(tmodel.render_bundle(tt.params["model"], bundle, tt.occ, tt.model_config,
                                             train=False))
    for k in ("rgb", "depth", "accumulation"):
        np.testing.assert_allclose(outs[0][k].detach().numpy(), outs[1][k].detach().numpy(),
                                   atol=1e-5, err_msg=k)


def test_compact_with_no_valid_sample():
    """An empty grid: no chunk is live, the field is never evaluated, and
    the render is the dense one (nothing accumulates)."""
    _, _, tt = torch_parity.trainers(model=dict(compact_chunk=64))
    tt.occ.binaries.zero_()
    tb = tt.batch_to_device(tt.dm.next_train(0))
    bundle = tt._step_bundles(tt.params["camera_opt"], tb, 0)[0]
    out = tmodel.render_bundle(tt.params["model"], bundle, tt.occ, tt.model_config, train=False)
    assert float(out["accumulation"].abs().max()) == 0.0


def test_compact_excludes_coarse_stride():
    """Both packages refuse compact_chunk with coarse_stride > 1."""
    with pytest.raises(ValueError, match="mutually exclusive"):
        jmodel.ModelConfig(field=jfield.FieldConfig(coarse_stride=2), compact_chunk=64)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tmodel.ModelConfig(field=tfield.FieldConfig(coarse_stride=2), compact_chunk=64)
    tmodel.ModelConfig(field=tfield.FieldConfig(coarse_stride=2))
    tmodel.ModelConfig(compact_chunk=64)


def test_warmup_phases_match_jax():
    """The warmup's phase 1 is the F trainer with proposal_samples=0 for
    the duration: its step equals JAX's proposal_samples=0 trainer's on
    the same batch; phase 2 (the override left) equals JAX's F trainer's.
    Both JAX trainers start from the same params (one seed)."""
    j0, s0, _ = torch_parity.trainers(model=dict(proposal_samples=0))
    jf, sf, tt = torch_parity.trainers()
    assert tt.model_config.proposal_samples == 8 and j0.model_config.proposal_samples == 0
    batch = jf.dm.next_train(0)
    with tt.model_override(proposal_samples=0):
        assert tt.model_config.proposal_samples == 0
        l0, _ = _match_jax(tt, batch, _jax_step(j0, s0, batch))
    assert tt.model_config.proposal_samples == 8
    lf, _ = _match_jax(tt, batch, _jax_step(jf, sf, batch))
    assert l0 != lf


def test_warmup_cli_crosses_the_switch(tmp_path, monkeypatch):
    """--pipeline.model.proposal-warmup-steps 5 over 9 steps: steps 0-4
    render without the proposal, 5-8 at F, on one trainer whose step and
    Adam count run on across the switch. A run that starts past the warmup
    (a resume) takes none."""
    data = str(tmp_path / "scene")
    write_reference_scene(data, n_cams=8, h=16, w=16, focal=20.0, n_val=2, with_prevnext=True,
                          with_full_camera=True, texture_freq=3.0)
    seen = []
    real_step = ttr.Trainer.step

    def step(self, batch, *a, **k):
        seen.append((self.step_count, self.opt_count, self.model_config.proposal_samples))
        return real_step(self, batch, *a, **k)

    monkeypatch.setattr(ttr.Trainer, "step", step)
    argv = train_argv("lsenerf", data) + [
        "--max-num-iterations", "9", "--steps-per-save", "100", "--steps-per-eval-batch", "100",
        "--steps-per-eval-image", "100", "--steps-per-eval-all-images", "100",
        "--output-dir", str(tmp_path / "out"), "--pipeline.model.proposal-samples", "8",
        "--pipeline.model.proposal-warmup-steps", "5"] + TINY_MODEL + ["--device", "cpu"]
    run = train.main(argv)
    assert [s[2] for s in seen] == [0] * 5 + [8] * 4
    assert [s[0] for s in seen] == list(range(9)) == [s[1] for s in seen]
    # a resume from step 5 of a run of 9 starts past the warmup: F throughout
    seen.clear()
    assert sorted(os.listdir(osp.join(run, "checkpoints"))) == ["step-000000004", "step-000000008"]
    train.main(argv[:] + ["--load-checkpoint", osp.join(run, "checkpoints", "step-000000004")])
    assert [s[2] for s in seen] == [8] * 9 and seen[0][0] == 5


@pytest.mark.parametrize("knob", ["use_native", "compact_chunk"])
def test_cli_runs_with_knob(knob, tmp_path, monkeypatch):
    """A 6-step CLI run on the CPU with the knob on goes through it: the
    native prefetcher gives every batch, or the compact field evaluation
    every render (the tiny model's 4,096 samples a step in chunks of
    512)."""
    from lsenerf_tpu_torch.data import native_loader

    data = str(tmp_path / "scene")
    write_reference_scene(data, n_cams=8, h=16, w=16, focal=20.0, n_val=2, with_prevnext=True,
                          with_full_camera=True, texture_freq=3.0)
    calls = []
    if knob == "use_native":
        target, name, flags = native_loader.NativePrefetcher, "next", [
            "--pipeline.datamanager.use-native", "True"]
    else:
        target, name, flags = tmodel, "_compact_field_eval", ["--pipeline.model.compact-chunk", "512"]
    real = getattr(target, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(target, name, spy)
    train.main(train_argv("lsenerf", data) + [
        "--max-num-iterations", "6", "--steps-per-save", "100", "--steps-per-eval-batch", "100",
        "--steps-per-eval-image", "100", "--steps-per-eval-all-images", "100",
        "--output-dir", str(tmp_path / "out")] + flags + TINY_MODEL + ["--device", "cpu"])
    assert len(calls) >= 6


def test_compact_config_lowers_from_the_cli():
    from lsenerf_tpu_torch.engine import config as tcfg

    cfg = tcfg.modify_config(tcfg.parse_cli(["lsenerf", "--pipeline.model.compact-chunk", "4096"]))
    assert tcfg.build_runtime_configs(cfg)[1].compact_chunk == 4096
    cfg = tcfg.modify_config(tcfg.parse_cli(["lsenerf", "--pipeline.model.compact-chunk", "4096",
                                             "--pipeline.model.coarse-stride", "2"]))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tcfg.build_runtime_configs(cfg)
