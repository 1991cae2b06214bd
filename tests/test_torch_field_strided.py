"""The port's strided coarse-level field, its aabb field and the ngp layout
in a train step, against the JAX package on the CPU:

- `contract_positions` with and without the scene contraction;
- `field_apply_strided` (coarse levels anchored every S samples and lerped
  in t, fine levels at every sample) in both hash layouts, on rays that
  leave the aabb so that the lerp weight snaps to the valid anchor, with
  invalid trailing slots at t = 0;
- one train step's loss and gradients (tests/torch_parity.py's small
  configuration) for the badnerf preset with the ngp layout in f32 (the
  `real_scale_badnerf_ngpf32` golden's model), for the flagship's model with
  coarse_stride 2, and for ngp + coarse_stride 2 + the aabb field: loss
  rtol 1e-5, gradients rtol 1e-3 / atol 1e-6 (PERF.md §2);
- an exact resume of an ngp trainer, bit for bit.

Tolerances: the field's values and gradients take the MLPs' f32 matmuls
and the encode's sums in another order than XLA's, as in
test_torch_field_composite.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.models import field as jfield
from lsenerf_tpu_torch import convert
from lsenerf_tpu_torch.engine import checkpoints as ckpt
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import field as tfield

import torch_parity


@pytest.mark.parametrize("contract", [True, False])
def test_contract_positions_matches_jax(contract):
    jm, tm = torch_parity.model_configs(field=dict(use_contraction=contract, aabb_scale=1.5))
    rng = np.random.default_rng(0)
    pos = rng.uniform(-2.5, 2.5, (500, 3)).astype(np.float32)
    pos[:3] = [[1.5, 0.0, 0.0], [-1.5, 0.2, 0.1], [0.0, 0.0, 0.0]]  # the box's faces
    pos[3:6] *= 1e8  # contracted onto the cube's surface: out of bounds
    ju, js = jfield.contract_positions(jnp.asarray(pos), jm.field)
    tu, ts = tfield.contract_positions(torch.from_numpy(pos), tm.field)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-7)
    assert 0 < ts.float().mean() < 1


def _rays(n=24, k=16, seed=3):
    """(n, k, 3) positions along rays from inside the box [-1, 1]^3 that
    leave it, their t midpoints (n, k), and the last 1-5 slots of each ray
    invalid: t = 0, at the origin, as the march leaves them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.7, 0.7, (n, 1, 3))
    d = rng.standard_normal((n, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ts = np.sort(rng.uniform(0.05, 1.8, (n, k)), axis=1)
    valid = k - rng.integers(1, 6, n)
    ts[np.arange(k)[None, :] >= valid[:, None]] = 0.0
    pos = o + ts[..., None] * d
    return pos.astype(np.float32), ts.astype(np.float32)


@pytest.mark.parametrize("stride", [2, 4])
@pytest.mark.parametrize("layout", ["ngp", "blocked"])
def test_field_apply_strided_matches_jax(layout, stride):
    """density and rgb and the gradients of a probe loss with respect to
    every field parameter and the positions, on the aabb field (where an
    anchor outside the box makes the lerp snap)."""
    jm, tm = torch_parity.model_configs(
        layout=layout, field=dict(coarse_stride=stride, coarse_levels=2, use_contraction=False))
    jp = jfield.init_field(jax.random.PRNGKey(1), jm.field)
    pos, ts = _rays()
    n, k, _ = pos.shape
    rng = np.random.default_rng(4)
    dirs = rng.standard_normal((n * k, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    wd = rng.standard_normal((n * k, 1)).astype(np.float32)
    wr = rng.standard_normal((n * k, 3)).astype(np.float32)

    # the snap is exercised: some anchor pair has exactly one anchor in the box
    sel = np.asarray(jfield.contract_positions(jnp.asarray(pos.reshape(-1, 3)), jm.field)[1])
    anchors = np.r_[np.arange(0, k, stride), k - 1] if (k - 1) % stride else np.arange(0, k, stride)
    sa = sel.reshape(n, k)[:, anchors]
    assert (sa[:, 1:] != sa[:, :-1]).any()

    app = np.zeros(n * k, np.int32)

    def jloss(p, x):
        d, c = jfield.field_apply_strided(p, x, jnp.asarray(ts), jnp.asarray(dirs),
                                          jnp.asarray(app), jm.field)
        return (d * wd).sum() + (c * wr).sum(), (d, c)

    (_, (jd, jc)), (jgp, jgx) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(pos))

    tp = convert.params_from_numpy({"field": jax.tree.map(np.asarray, jp)}, {},
                                   hash_layout=layout)["model"]["field"]
    leaves = dict(tree_leaves(tp))
    for t in leaves.values():
        t.requires_grad_(True)
    tx = torch.from_numpy(pos).requires_grad_(True)
    td, tc = tfield.field_apply_strided(tp, tx, torch.from_numpy(ts), torch.from_numpy(dirs),
                                        torch.zeros(n, dtype=torch.int32), tm.field)
    ((td * torch.from_numpy(wd)).sum() + (tc * torch.from_numpy(wr)).sum()).backward()

    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tc.detach().numpy(), np.asarray(jc), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-3, atol=1e-5)
    for path, g in tree_leaves(jax.tree.map(np.asarray, jgp)):
        if path == "hash_table" and layout == "ngp":
            g = convert.ngp_table_from_jax(g)
        np.testing.assert_allclose(leaves[path].grad.numpy(), g, rtol=1e-3, atol=1e-6,
                                   err_msg=path)
    assert np.abs(np.asarray(jgp["hash_table"])).max() > 0


def test_coarse_stride_checks_its_levels_as_jax():
    _, th = torch_parity.hash_configs()
    for bad in (0, th.num_levels):
        with pytest.raises(ValueError, match="coarse_levels"):
            tfield.FieldConfig(hash=th, coarse_stride=2, coarse_levels=bad)
    tfield.FieldConfig(hash=th, coarse_stride=1, coarse_levels=0)


SPLINE = dict(mode="SO3xR3", optim_type="spline")
NO_MAP = dict(use_mapping=False, mapping_method="identity", map_mode="None",
              evs_mapping_method="None")
STEP_CASES = {
    # the real_scale_badnerf_ngpf32 golden's model: badnerf (RGB only, no
    # mapping, spline + deblur x4) with the ngp layout, f32
    "badnerf_ngp_f32": dict(col_cam=SPLINE, deblur=True, rgb_frac=1.0, model=NO_MAP,
                            layout="ngp"),
    # the flagship's model (blocked layout) with the strided coarse levels
    "flagship_coarse_stride_2": dict(field=dict(coarse_stride=2, coarse_levels=2)),
    # ngp, strided, and the aabb field in place of the contraction
    "ngp_coarse_stride_2_aabb": dict(layout="ngp", field=dict(
        coarse_stride=2, coarse_levels=3, use_contraction=False)),
}


@functools.lru_cache(maxsize=None)
def _step_case(name):
    jt, state, tt = torch_parity.trainers(**STEP_CASES[name])
    batch = jt.dm.next_train(0)
    rng = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(jt._build_loss_fn(), has_aux=True))(
        state.params, state.occ, jb, jnp.int32(0), rng)
    overflow = 0
    if jt.model_config.field.hash.layout == "blocked":
        overflow = int(jt.make_overflow_probe()(state.params, state.occ, jb, jnp.int32(0)))
    return jt, tt, batch, (loss, metrics, grads, rng, overflow)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_train_step_matches_jax(name, monkeypatch):
    jt, tt, batch, (loss, metrics, grads, rng, overflow) = _step_case(name)
    # the JAX blocked table gradient is exact only without window overflow
    assert overflow == 0
    strided = []
    real = tfield.field_apply_strided
    monkeypatch.setattr(tfield, "field_apply_strided",
                        lambda *a, **k: strided.append(1) or real(*a, **k))
    tb = tt.batch_to_device(batch)
    bg = torch.from_numpy(np.array(jax.random.uniform(rng, (tt.num_rays(tb), 3))))
    tloss, tmetrics, tgrads = tt.grads(tb, bg_color=bg)
    # every bundle of the step went through the strided field, or none
    assert bool(strided) == (tt.model_config.field.coarse_stride > 1)
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert set(tmetrics) == set(metrics)
    jg = dict(tree_leaves(jax.tree.map(np.asarray, grads)))
    assert set(jg) == set(tgrads)
    layout = tt.model_config.field.hash.layout
    for path, g in jg.items():
        if path == "model/field/hash_table" and layout == "ngp":
            g = convert.ngp_table_from_jax(g)
        np.testing.assert_allclose(tgrads[path].numpy(), g, rtol=1e-3, atol=1e-6, err_msg=path)
    assert np.abs(jg["model/field/hash_table"]).max() > 0
    assert tt.params["model"]["field"]["hash_table"].shape == tt.model_config.field.hash.table_shape


def _ngp_trainer(seed=0):
    _, tm = torch_parity.model_configs(layout="ngp", field=dict(coarse_stride=2, coarse_levels=2))
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
    from lsenerf_tpu_torch.engine.trainer import CameraOptConfig, Trainer, TrainerConfig

    col, evs = make_synthetic_scene(n_cams=4, h=16, w=16, focal=20.0)
    dm = MultiCamDataManager(DataManagerConfig(train_num_rays_per_batch=64), col, evs, seed=3)
    tr = Trainer(TrainerConfig(seed=seed, col_cam_opt=CameraOptConfig(mode="SO3xR3")), tm, dm,
                 device="cpu")
    tr.setup()
    return tr


def test_ngp_resume_is_bit_for_bit(tmp_path):
    """6 steps straight equal 3 steps, a save, a load into a trainer of
    another seed and 3 more, bit for bit, with the ngp table and its Adam
    moments in the checkpoint."""
    straight = _ngp_trainer()
    batches = [straight.dm.next_train(i) for i in range(6)]
    for b in batches:
        straight.step(b)
    half = _ngp_trainer()
    for b in batches[:3]:
        half.step(b)
    d = str(tmp_path / "ckpts")
    ckpt.save_checkpoint(d, 2, half)
    saved = torch.load(f"{d}/step-000000002", weights_only=True)
    assert saved["params"]["model"]["field"]["hash_table"].shape == \
        straight.model_config.field.hash.table_shape
    resumed = _ngp_trainer(seed=99)
    step, params, occ, opt, rng = ckpt.load_checkpoint_full(d)
    ckpt.restore_into_state(resumed, params, occ, step, opt=opt, rng=rng)
    for b in batches[3:]:
        resumed.step(b)
    a, b = dict(tree_leaves(straight.params)), dict(tree_leaves(resumed.params))
    assert set(a) == set(b)
    for p in a:
        assert torch.equal(a[p], b[p]), p
    sa, sb = straight.adam_state(), resumed.adam_state()
    assert "model/field/hash_table" in sa
    for p in sa:
        for k in sa[p]:
            assert torch.equal(sa[p][k], sb[p][k]), (p, k)
    assert torch.equal(straight.occ.occs, resumed.occ.occs)
