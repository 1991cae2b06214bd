"""The flagship training configurations, the port's counterparts of
`__graft_entry__._flagship(tiny=False, production=False)` and of its
production protocol (`production=True`), and the paper's four model
presets on the same scene and widths.

The flagship: a 16-level blocked bf16 hash grid (2^14 rows per hashed
level), bf16-rounded MLP inputs, a 128^3 x 4 occupancy grid, the
hierarchical march with the packed phase-2 rule, proposal resampling to 16
samples per ray, co_map with an identity RGB mapper and a powpow event
mapper, SO3xR3 `ns` camera deltas for both cameras, and 3512-ray batches
(2318 RGB + 2 x 597 event) on the 12-camera 64x64 synthetic scene.

The production protocol keeps that model and scene and changes the RGB
camera: its poses come from the continuous-time spline (12 knots), and
each RGB pixel is the mean of 4 rays across its exposure (deblur x4). The
3512-ray budget then gives 579 RGB pixels x 4 + 2 x 597 event rays =
3510 rays, 56,160 field samples a step.

The presets (`preset_trainer`) are `configs/{lsenerf,lsenerf_emb,badnerf,
badnerf_emb}.sh` under `scripts/train_lse_data.sh`'s protocol (deblur x4,
the RGB spline with exposure 30,000, event `ns` SO3xR3 deltas,
ev_one_dim gt, event weight 1, lr 1e-2), with the CLI's other defaults
(random background, proposal F=16 except F=0 under evs_emb,
engine/config.py:444-455) at the flagship's widths and scene:
  lsenerf      the production trainer above;
  lsenerf_emb  one appearance row per image (12) and F=0: 3510 rays x 48
               samples = 168,480 field samples a step;
  badnerf      RGB only (rgb_frac 1.0, no event dataset), no mapping:
               878 pixels x 4 = 3512 rays, 56,192 samples;
  badnerf_emb  badnerf with one appearance row per image and F=0.
All keep the trainer's seed 42 (the script passes 96), so `lsenerf` is
the production trainer exactly."""

from __future__ import annotations

import dataclasses

from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
from lsenerf_tpu_torch.engine.trainer import CameraOptConfig, Trainer, TrainerConfig
from lsenerf_tpu_torch.models import embeddings as emb_lib
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import lsenerf as model_lib
from lsenerf_tpu_torch.ops import combine
from lsenerf_tpu_torch.ops import hash_encoding as he

# configs/*.sh: rgb_frac, use_map, mapping_method, map_mode,
# evs_mapping_method, emb_type (each runs evs_loss_fn=log_loss)
PRESETS = {
    "lsenerf": (0.66, True, "identity", "co_map", "powpow", "global_emb"),
    "lsenerf_emb": (0.66, True, "identity", "co_map", "powpow", "evs_emb"),
    "badnerf": (1.0, False, "identity", "None", "None", "global_emb"),
    "badnerf_emb": (1.0, False, "identity", "None", "None", "evs_emb"),
}


def flagship_model_config() -> model_lib.ModelConfig:
    return model_lib.ModelConfig(
        field=field_lib.FieldConfig(
            compute_dtype="bfloat16",
            hash=he.HashEncodingConfig(gather_dtype="bfloat16"),
        ),
        proposal_samples=16,
        use_mapping=True,
        mapping_method="identity",
        evs_mapping_method="powpow",
        map_mode="co_map",
        ev_one_dim="gt",
    )


def preset_model_config(preset: str, production: bool = True) -> model_lib.ModelConfig:
    """The preset's model at the flagship's widths; with `production`,
    deblur x4 RGB rays."""
    _, use_map, mapping, map_mode, evs_mapping, emb_type = PRESETS[preset]
    base = flagship_model_config()
    return dataclasses.replace(
        base,
        field=dataclasses.replace(base.field, embedding=emb_lib.EmbeddingConfig(emb_type)),
        proposal_samples=0 if emb_type == "evs_emb" else 16,
        use_mapping=use_map, mapping_method=mapping, map_mode=map_mode,
        evs_mapping_method=evs_mapping,
        rgb_loss_type="deblur" if production else "linspace",
    ).normalized()


def preset_configs(preset: str, production: bool = True):
    """(TrainerConfig, ModelConfig, DataManagerConfig) of a preset: with
    `production` under train_lse_data.sh's protocol (RGB spline + deblur
    x4, event `ns` deltas), else with `ns` deltas for both cameras and one
    ray an RGB pixel, as the flagship."""
    cfg = TrainerConfig(
        col_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="spline" if production else "ns"),
        evs_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="ns"),
    )
    dmc = DataManagerConfig(train_num_rays_per_batch=3512, rgb_frac=PRESETS[preset][0],
                            rgb_loss_mode="deblur" if production else "mse")
    return cfg, preset_model_config(preset, production), dmc


def preset_trainer(preset: str, production: bool = True, device=None, dm_seed: int = 0) -> Trainer:
    """A preset's trainer (preset_configs) on the flagship's scene, set up
    with fresh parameters from its seed."""
    cfg, mcfg, dmc = preset_configs(preset, production)
    col, evs = make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
    if dmc.rgb_frac >= 1.0:
        evs = None  # train.py parses no event data for an RGB-only run
    trainer = Trainer(cfg, mcfg, MultiCamDataManager(dmc, col, evs, seed=dm_seed), device=device)
    trainer.setup()
    return trainer


def flagship_trainer(device=None, dm_seed: int = 0, production: bool = False) -> Trainer:
    """The flagship trainer, or with `production` the production protocol's
    (the `lsenerf` preset: RGB spline + deblur x4, event `ns` deltas, 579
    RGB pixels x 4 + 2 x 597 event rays)."""
    return preset_trainer("lsenerf", production, device, dm_seed)


def step_encode_inputs(device=None, preset: str | None = None):
    """The arguments K2 (combine.encode_bwd) is given in one real train
    step: a fresh flagship trainer (or the preset's production trainer)
    takes its step 0 (the occupancy update, the march, the field and the
    backward) with K2's wrapper watched. Returns (positions, table,
    cotangent, levels); the positions come ray-major, as many samples a
    ray as the march gives (16 for the flagship, 48 under F=0)."""
    seen, real = [], combine.encode_bwd

    def watch(positions, table, gfeat, levels):
        seen.append((positions.clone(), table.clone(), gfeat.clone(), levels))
        return real(positions, table, gfeat, levels)

    trainer = flagship_trainer(device=device) if preset is None else preset_trainer(preset, device=device)
    combine.encode_bwd = watch
    try:
        trainer.step(trainer.dm.next_train(0))
    finally:
        combine.encode_bwd = real
    if len(seen) != 1:
        raise RuntimeError(f"one train step called K2 {len(seen)} times, not once")
    return seen[0]
