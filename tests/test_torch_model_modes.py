"""The port's train step against the JAX package's for the models beyond
the flagship's: the presets lsenerf_emb (per-frame embedding, F=0) and
badnerf (RGB only, no mapping), both under the production protocol
(RGB spline + deblur x4); the CLI's default model at the tiny golden's
settings (flat march, white background, learned reducer left unread);
evs_rgb with an `rgb_mlp` mapper, the learned reducer and enerf_norm_loss;
rgb_evs with `rgb_mlp`; co_map with an `mlp` event mapper and the learned
reducer; and the denerf shortcut. Small configuration of
tests/torch_parity.py, f32; params (JAX's pretrained mappers included),
batch, background and grid move across as numpy arrays."""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsenerf_tpu.models import embeddings as jemb
from lsenerf_tpu.models import lsenerf as jmodel
from lsenerf_tpu_torch import convert
from lsenerf_tpu_torch.engine.trainer import tree_leaves
from lsenerf_tpu_torch.models import lsenerf as tmodel
from lsenerf_tpu_torch.models import mappers as tmapper

import torch_parity

SPLINE = dict(mode="SO3xR3", optim_type="spline")
OFF = dict(mode="off")
# engine/config.py's ModelCLI defaults
CLI = dict(use_mapping=False, mapping_method="mlp", map_mode="evs_rgb", evs_mapping_method=None,
           ev_one_dim="learned")
NO_MAP = dict(use_mapping=False, mapping_method="identity", map_mode="None",
              evs_mapping_method="None")
CASES = {
    "lsenerf_emb": dict(col_cam=SPLINE, deblur=True, emb="evs_emb",
                        model=dict(proposal_samples=0)),
    "badnerf": dict(col_cam=SPLINE, deblur=True, rgb_frac=1.0, model=NO_MAP),
    # scripts/parity.py --tiny: 4 levels res 8..64, 16^3 x 1 grid, 64
    # candidates, 16 samples, white background; no camera optimizer. The 64
    # candidates span ~0.2 past the grid's entry, short of the sparse
    # grid's ball, so the step runs on the fresh grid, as the golden's first
    "cli_defaults": dict(
        col_cam=OFF, evs_cam=OFF, hash=dict(num_levels=4, base_res=8, max_res=64,
                                            blocked_rows_log2=14),
        grid=dict(resolution=16, levels=1), fresh_grid=True,
        model=dict(CLI, max_samples=16, max_candidates=64, proposal_samples=16,
                   background_color="white")),
    # a 1->1 `mlp` RGB mapper cannot take evs_rgb's three channels (JAX
    # fails there too, test_evs_rgb_mlp_fails_where_jax_fails): 3->3
    "evs_rgb_rgb_mlp_enerf": dict(model=dict(CLI, use_mapping=True, mapping_method="rgb_mlp",
                                             event_loss_type="enerf_norm_loss")),
    "rgb_evs_rgb_mlp": dict(model=dict(use_mapping=True, map_mode="rgb_evs",
                                       mapping_method="rgb_mlp", ev_one_dim=None)),
    "co_map_mlp_learned": dict(model=dict(evs_mapping_method="mlp", ev_one_dim="learned")),
    "denerf": dict(model=dict(event_loss_type="denerf", background_color="last_sample")),
}
# leaves each case must give a non-zero gradient, and leaves it must not
# read (zero gradient)
LIVE = {
    "lsenerf_emb": ["model/field/appearance/table", "model/evs_mapper/pow_coeff",
                    "camera_opt/col/ctrl_tangents"],
    "badnerf": ["model/field/hash_table", "camera_opt/col/ctrl_tangents"],
    "cli_defaults": ["model/field/hash_table"],
    "evs_rgb_rgb_mlp_enerf": ["model/rgb_mapper/mlp/w0", "model/rgb_to_one/weights"],
    "rgb_evs_rgb_mlp": ["model/rgb_mapper/mlp/w3"],
    "co_map_mlp_learned": ["model/evs_mapper/mlp/w0", "model/rgb_to_one/weights"],
    "denerf": ["model/field/hash_table"],
}
DEAD = {"cli_defaults": ["model/rgb_to_one/weights"], "denerf": ["model/evs_mapper/pow_coeff"]}


@functools.lru_cache(maxsize=None)
def _case(name):
    """Both trainers, one batch, and the JAX step's loss, metrics and
    gradients at step 0 (one jit of the JAX loss per case)."""
    jt, state, tt = torch_parity.trainers(**CASES[name])
    batch = jt.dm.next_train(0)
    tbatch = tt.dm.next_train(0)
    assert set(tbatch) == set(batch)
    for k in batch:
        np.testing.assert_array_equal(tbatch[k], batch[k], err_msg=k)
    rng = jax.random.PRNGKey(5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(jt._build_loss_fn(), has_aux=True)
    )(state.params, state.occ, jb, jnp.int32(0), rng)
    overflow = int(jt.make_overflow_probe()(state.params, state.occ, jb, jnp.int32(0)))
    return jt, state, tt, batch, (loss, metrics, grads, rng, overflow)


@pytest.mark.parametrize("name", list(CASES))
def test_model_mode_loss_and_grads_match_jax(name):
    jt, state, tt, batch, (loss, metrics, grads, rng, overflow) = _case(name)
    # the JAX hashed-level table gradient is exact only without window
    # overflow; hold the port to it on a batch where it is
    assert overflow == 0

    tb = tt.batch_to_device(batch)
    bg = None
    if tt.model_config.background_color == "random":
        bg = torch.from_numpy(np.array(jax.random.uniform(rng, (tt.num_rays(tb), 3))))
    tloss, tmetrics, tgrads = tt.grads(tb, bg_color=bg)

    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    assert set(tmetrics) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(tmetrics[k].detach()), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    jg = dict(tree_leaves(jax.tree.map(np.asarray, grads)))
    assert set(jg) == set(tgrads)
    for path, g in jg.items():
        np.testing.assert_allclose(tgrads[path].numpy(), g, rtol=1e-3, atol=1e-6, err_msg=path)
    for path in LIVE[name]:
        assert np.abs(jg[path]).max() > 0, path
    for path in DEAD.get(name, []):
        assert not jg[path].any() and not tgrads[path].any(), path


def test_evs_rgb_mlp_fails_where_jax_fails():
    """evs_rgb maps the three-channel radiance through the RGB mapper, which
    a 1->1 `mlp` cannot take: both packages fail on the shapes. So does
    rgb_evs without use_mapping, which has no RGB mapper."""
    jm = jmodel.ModelConfig(use_mapping=True)
    tm = tmodel.ModelConfig(use_mapping=True)
    jp = jmodel.init_model(jax.random.PRNGKey(0), jm)
    tp = convert.tree_to_torch(jax.tree.map(np.asarray, jp))
    rgb = np.full((4, 3), 0.5, np.float32)
    with pytest.raises(TypeError):
        jmodel.postprocess_outputs(jp, {"rgb": jnp.asarray(rgb)}, jm)
    with pytest.raises(RuntimeError):
        tmodel.postprocess_outputs(tp, {"rgb": torch.from_numpy(rgb)}, tm)
    jm, tm = (m.ModelConfig(map_mode="rgb_evs") for m in (jmodel, tmodel))
    with pytest.raises(KeyError):
        jmodel.postprocess_outputs({}, {"rgb": jnp.asarray(rgb)}, jm, ev_out=True)
    with pytest.raises(KeyError):
        tmodel.postprocess_outputs({}, {"rgb": torch.from_numpy(rgb)}, tm, ev_out=True)


def test_convert_carries_pretrained_mappers_reducer_and_table(monkeypatch):
    """JAX's pretrained `rgb_mlp` and `mlp` mappers (from two cases above),
    its learned reducer and a 12-row evs_emb table carry across convert.py
    unchanged, and the port's own init_model builds the same tree of the
    same shapes."""
    rgb_mapper = _case("evs_rgb_rgb_mlp_enerf")[1].params["model"]["rgb_mapper"]
    model = dict(_case("co_map_mlp_learned")[1].params["model"], rgb_mapper=rgb_mapper)
    model["field"] = dict(model["field"], appearance=jemb.init_embedding(
        jax.random.PRNGKey(2), jemb.EmbeddingConfig(embedding_type="evs_emb"), 12))
    jp = jax.tree.map(np.asarray, model)
    tp = convert.params_from_numpy(jp, {})["model"]
    jl, tl = dict(tree_leaves(jp)), dict(tree_leaves(tp))
    assert set(tl) == set(jl)
    for path in ("rgb_mapper/mlp/w0", "evs_mapper/mlp/b3", "rgb_to_one/weights",
                 "field/appearance/table"):
        assert path in tl
    assert tl["field/appearance/table"].shape == (12, 32)
    for path, v in jl.items():
        assert tl[path].dtype == torch.float32
        np.testing.assert_array_equal(tl[path].numpy(), v, err_msg=path)
    # the same model from the port's own init (a short pretrain: only the
    # tree and shapes are compared)
    monkeypatch.setattr(tmapper, "PRETRAIN_STEPS", 2)
    kw = dict(use_mapping=True, map_mode="co_map", mapping_method="rgb_mlp",
              evs_mapping_method="mlp", ev_one_dim="learned")
    _, tm = torch_parity.model_configs(model=kw, emb="evs_emb")
    own = dict(tree_leaves(tmodel.init_model(torch.Generator().manual_seed(0), tm, num_imgs=12)))
    assert {p: tuple(v.shape) for p, v in own.items()} == {p: v.shape for p, v in jl.items()}


@pytest.mark.parametrize("name", ["cli_defaults", "badnerf"])
def test_mode_trains_on_cpu(name):
    """Eight port steps, an occupancy update included, stay finite; Adam
    moves the hash table and leaves a leaf the step does not read (the
    CLI default's learned reducer) as it was."""
    tt = _case(name)[2]
    tt.setup(params=tt.params, occ=tt.occ)
    before = {p: t.detach().clone() for p, t in tree_leaves(tt.params)}
    losses = [float(tt.step(tt.dm.next_train(i))["loss"]) for i in range(8)]
    assert all(np.isfinite(losses))
    after = dict(tree_leaves(tt.params))
    assert not torch.equal(after["model/field/hash_table"].detach(), before["model/field/hash_table"])
    for path in DEAD.get(name, []):
        assert torch.equal(after[path].detach(), before[path]), path


def test_denerf_renders_no_next_bundle():
    """Under denerf a step renders the RGB rays and one event bundle."""
    jt, state, tt, batch, _ = _case("denerf")
    n_col, n_evs = len(batch["col_indices"]), len(batch["evs_indices"])
    assert tt.num_rays(tt.batch_to_device(batch)) == n_col + n_evs
    assert tt.model_config.background_color == "last_sample"


def _script_argv(preset):
    """train.py's flags as scripts/train_lse_data.sh passes them for
    configs/<preset>.sh: the variables of both files substituted into the
    script's `--flag $var` lines (those naming paths or cadences dropped)."""
    root = Path(__file__).resolve().parent.parent
    values = {}
    for path in (root / "configs" / f"{preset}.sh", root / "scripts" / "train_lse_data.sh"):
        for line in path.read_text().splitlines():
            m = re.match(r"^(\w+)=(\S+)", line)
            if m:
                values[m[1]] = m[2]
    argv = []
    for flag, val in re.findall(r"(--[\w.-]+) (\S+)", (root / "scripts" / "train_lse_data.sh").read_text()):
        val = values.get(val[1:], None) if val.startswith("$") else val
        if val is not None and not val.startswith('"'):
            argv += [flag, val]
    return argv


@pytest.mark.parametrize("preset", ["lsenerf", "lsenerf_emb", "badnerf", "badnerf_emb"])
def test_preset_configs_match_the_cli(preset):
    """flagship.preset_configs against the JAX CLI's lowering of the same
    preset under train_lse_data.sh (engine/config.py parse_cli,
    modify_config, build_runtime_configs): model modes, proposal F,
    march, widths, camera optimizers and ray budget. Only the configs are
    built, no trainer."""
    from lsenerf_tpu.engine import config as jcfg

    from lsenerf_tpu_torch import flagship

    jt, jm, jd, _ = jcfg.build_runtime_configs(jcfg.modify_config(jcfg.parse_cli(_script_argv(preset))))
    tt, tm, td = flagship.preset_configs(preset)
    for f in ("use_mapping", "mapping_method", "map_mode", "evs_mapping_method", "ev_one_dim",
              "event_loss_type", "rgb_loss_type", "proposal_samples", "background_color",
              "max_samples", "max_candidates", "hierarchical_march", "packed_phase2",
              "coarse_factor", "max_coarse_segments", "evs_loss_weight", "render_step_size"):
        assert getattr(tm, f) == getattr(jm, f), f
    assert tm.field.embedding.embedding_type == jm.field.embedding.embedding_type
    assert tm.field.compute_dtype == jm.field.compute_dtype
    for f in ("num_levels", "base_res", "max_res", "gather_dtype", "blocked_rows_log2"):
        assert getattr(tm.field.hash, f) == getattr(jm.field.hash, f), f
    for f in ("resolution", "levels", "sample_fraction", "update_interval"):
        assert getattr(tm.grid, f) == getattr(jm.grid, f), f
    for f in ("train_num_rays_per_batch", "rgb_frac", "rgb_loss_mode",
              "train_num_col_rays_per_batch", "train_num_evs_rays_per_batch"):
        assert getattr(td, f) == getattr(jd, f), f
    for cam in ("col_cam_opt", "evs_cam_opt"):
        for f in ("mode", "optim_type", "exp_t", "scheme"):
            assert getattr(getattr(tt, cam), f) == getattr(getattr(jt, cam), f), (cam, f)
    assert tt.fields_optimizer.lr == jt.fields_optimizer.lr
