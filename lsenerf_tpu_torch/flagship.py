"""The flagship training configurations, the port's counterparts of
`__graft_entry__._flagship(tiny=False, production=False)` and of its
production protocol (`production=True`).

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
3510 rays, 56,160 field samples a step."""

from __future__ import annotations

import dataclasses

from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
from lsenerf_tpu_torch.engine.trainer import CameraOptConfig, Trainer, TrainerConfig
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import lsenerf as model_lib
from lsenerf_tpu_torch.ops import combine
from lsenerf_tpu_torch.ops import hash_encoding as he


def flagship_model_config() -> model_lib.ModelConfig:
    return model_lib.ModelConfig(
        field=field_lib.FieldConfig(
            compute_dtype="bfloat16",
            hash=he.HashEncodingConfig(gather_dtype="bfloat16"),
        ),
        proposal_samples=16,
        mapping_method="identity",
        evs_mapping_method="powpow",
        ev_one_dim="gt",
    )


def flagship_trainer(device=None, dm_seed: int = 0, production: bool = False) -> Trainer:
    """The flagship trainer, or with `production` the production protocol's
    (RGB spline + deblur x4, event `ns` deltas: 579 RGB pixels x 4 + 2 x
    597 event rays), set up with fresh parameters from its seed."""
    col, evs = make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
    dm = MultiCamDataManager(
        DataManagerConfig(train_num_rays_per_batch=3512, rgb_frac=0.66,
                          rgb_loss_mode="deblur" if production else "mse"),
        col, evs, seed=dm_seed,
    )
    cfg = TrainerConfig(
        col_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="spline" if production else "ns"),
        evs_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="ns"),
    )
    mcfg = flagship_model_config()
    if production:
        mcfg = dataclasses.replace(mcfg, rgb_loss_type="deblur")
    trainer = Trainer(cfg, mcfg, dm, device=device)
    trainer.setup()
    return trainer


def step_encode_inputs(device=None):
    """The arguments K2 (combine.encode_bwd) is given in one real flagship
    train step: a fresh flagship trainer takes its step 0 (the occupancy
    update, the march, the field and the backward) with K2's wrapper
    watched. Returns (positions, table, cotangent, levels); the positions
    come ray-major, 16 samples a ray, as the march gives them."""
    seen, real = [], combine.encode_bwd

    def watch(positions, table, gfeat, levels):
        seen.append((positions.clone(), table.clone(), gfeat.clone(), levels))
        return real(positions, table, gfeat, levels)

    trainer = flagship_trainer(device=device)
    combine.encode_bwd = watch
    try:
        trainer.step(trainer.dm.next_train(0))
    finally:
        combine.encode_bwd = real
    if len(seen) != 1:
        raise RuntimeError(f"one flagship step called K2 {len(seen)} times, not once")
    return seen[0]
