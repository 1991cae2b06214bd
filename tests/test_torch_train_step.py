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
