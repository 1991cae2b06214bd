"""The port's train step (lsenerf_tpu_torch/engine/trainer.py) against the
JAX package's, on a small configuration that takes the flagship's branches
(tests/torch_parity.py), in f32. Params, batch, random background and
occupancy state are moved across as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lsenerf_tpu_torch.engine.trainer import tree_leaves

import torch_parity


@pytest.fixture(scope="module")
def setup():
    """Both trainers, one batch, and the JAX step's loss, metrics and
    gradients at step 0 (computed once: one jit of the JAX loss)."""
    jt, state, tt = torch_parity.trainers()
    batch = jt.dm.next_train(0)
    np.testing.assert_array_equal(tt.dm.next_train(0)["col_indices"], batch["col_indices"])
    rng = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(jt._build_loss_fn(), has_aux=True)
    )(state.params, state.occ, jb, jnp.int32(0), rng)
    return jt, state, tt, batch, (loss, metrics, grads, rng)


def _flat(tree):
    return dict(tree_leaves(jax.tree.map(np.asarray, tree)))


def test_one_step_loss_and_grads_match_jax(setup):
    jt, state, tt, batch, (loss, metrics, grads, rng) = setup
    # the JAX hashed-level table gradient is exact only without window
    # overflow; hold the port to it on a batch where it is
    probe = jt.make_overflow_probe()
    assert int(probe(state.params, state.occ, {k: jnp.asarray(v) for k, v in batch.items()},
                     jnp.int32(0))) == 0

    tb = tt.batch_to_device(batch)
    bg = jax.random.uniform(rng, (tt.num_rays(tb), 3))  # what render_rgb draws
    tloss, tmetrics, tgrads = tt.grads(tb, bg_color=torch.from_numpy(np.asarray(bg)))

    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    for k in ("rgb_loss", "event_loss", "psnr", "num_samples_per_ray"):
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(metrics[k]), rtol=1e-5)
    # the march sparsified the rays and the background was blended in
    assert 1.0 < float(metrics["num_samples_per_ray"])

    jg = _flat(grads)
    assert set(jg) == set(tgrads)
    for path, g in jg.items():
        np.testing.assert_allclose(
            tgrads[path].numpy(), g, rtol=1e-3, atol=1e-6, err_msg=path
        )
        if path.endswith("hash_table") or path.endswith("pose_adjustment"):
            assert np.abs(g).max() > 0, path


def test_adam_on_jax_gradients_matches_optax(setup):
    """Adam with eps 1e-15 turns a near-zero gradient into a whole-lr step,
    so the optimizer is checked on JAX's own gradients: two updates, which
    also checks the bias correction and the schedule's step index."""
    jt, state, tt, _, (_, _, grads, _) = setup
    params, opt_state = state.params, state.opt_state
    # a fresh optimizer on a copy of the starting params
    tt.setup(params=jax.tree.map(np.asarray, params), occ=tt.occ)
    tleaves = dict(tree_leaves(tt.params))
    for k in range(2):
        g = jax.tree.map(lambda x: x * (1.0 + 0.5 * k), grads)
        updates, opt_state = jt._tx.update(g, opt_state, params)
        params = optax.apply_updates(params, updates)
        for path, gv in _flat(g).items():
            tleaves[path].grad = torch.from_numpy(gv.copy())
        for group, sched in zip(tt.optimizer.param_groups, tt.schedules):
            group["lr"] = sched(k)
        tt.optimizer.step()
    # the updates are ~lr = 1e-2; f32 rounding of the two Adam formulas
    # differs by ~1e-7, so atol is 1e-4 of lr
    for path, want in _flat(params).items():
        np.testing.assert_allclose(
            tleaves[path].detach().numpy(), want, rtol=1e-5, atol=1e-6, err_msg=path
        )


def test_port_trains_on_cpu(setup):
    """Several port steps, an occupancy update included, stay finite and
    lower the loss."""
    tt = setup[2]
    tt.setup(params=tt.params, occ=tt.occ)
    losses = []
    for i in range(18):
        m = tt.step(tt.dm.next_train(i))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert tt.step_count == 18
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_step_encode_inputs_watches_one_step(monkeypatch):
    """The capture of K2's arguments from one train step (used by
    chip_smoke.py), on a tiny trainer in place of the flagship's: one call,
    and the wrapper restored after it."""
    from lsenerf_tpu_torch import flagship
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
    from lsenerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from lsenerf_tpu_torch.models import field as field_lib
    from lsenerf_tpu_torch.models.lsenerf import ModelConfig
    from lsenerf_tpu_torch.ops import combine
    from lsenerf_tpu_torch.ops import hash_encoding as the
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    hcfg = the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, layout="blocked",
                                 blocked_rows_log2=10)

    def tiny(device=None):
        col, evs = make_synthetic_scene(n_cams=3, h=8, w=8)
        dm = MultiCamDataManager(DataManagerConfig(train_num_rays_per_batch=16), col, evs)
        mcfg = ModelConfig(field=field_lib.FieldConfig(hash=hcfg),
                           grid=occ_lib.OccGridConfig(resolution=32, levels=2),
                           max_samples=16, max_candidates=256, proposal_samples=8)
        trainer = Trainer(TrainerConfig(), mcfg, dm, device=device)
        trainer.setup()
        return trainer

    monkeypatch.setattr(flagship, "flagship_trainer", tiny)
    real = combine.encode_bwd
    pos, table, gfeat, levels = flagship.step_encode_inputs("cpu")
    assert combine.encode_bwd is real
    n = pos.shape[0]
    assert n > 0 and pos.shape == (n, 3) and gfeat.shape == (n, 2 * levels.num)
    assert table.shape == (hcfg.total_rows, 64) and levels.num == 5


def test_ngp_encode_calls_watches_a_step_and_an_eval_chunk():
    """The capture of K7a's and K7b's arguments (used by chip_smoke.py) on a
    tiny ngp trainer: one K7a call a density chunk of the occupancy update,
    one in the step, one in the eval chunk (48 samples a ray, as many rays
    as the view has); K7b once; both wrappers and occ_update restored."""
    from lsenerf_tpu_torch import flagship
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
    from lsenerf_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from lsenerf_tpu_torch.models import field as field_lib
    from lsenerf_tpu_torch.models.lsenerf import ModelConfig
    from lsenerf_tpu_torch.ops import hash_encoding as the
    from lsenerf_tpu_torch.ops import ngp
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    hcfg = the.HashEncodingConfig(num_levels=5, base_res=4, max_res=64, log2_hashmap_size=10)
    col, evs = make_synthetic_scene(n_cams=3, h=8, w=8)
    dm = MultiCamDataManager(DataManagerConfig(train_num_rays_per_batch=16), col, evs)
    mcfg = ModelConfig(field=field_lib.FieldConfig(hash=hcfg),
                       grid=occ_lib.OccGridConfig(resolution=32, levels=2),
                       max_samples=16, max_candidates=256, proposal_samples=8)
    trainer = Trainer(TrainerConfig(), mcfg, dm, device="cpu")
    trainer.setup()
    real = ngp.encode_fwd, ngp.encode_bwd
    calls = flagship.ngp_encode_calls(trainer=trainer)
    assert (ngp.encode_fwd, ngp.encode_bwd) == real and "occ_update" not in vars(trainer)
    cells = occ_lib.num_update_cells(mcfg.grid) * mcfg.grid.levels
    assert sum(c[0].shape[0] for c in calls["occupancy"]) == cells
    pos, table, gfeat, lv = calls["step"]
    assert pos.shape[0] > 0 and gfeat.shape == (pos.shape[0], 2 * lv.num)
    assert table.shape == hcfg.table_shape
    epos, etable, elv = calls["eval_chunk"]
    assert epos.shape == (8 * 8 * mcfg.max_samples, 3) and elv.num == 5
    assert not torch.equal(etable, table), "the eval chunk reads the table after the step"
