"""The flagship training configuration, the port's counterpart of
`__graft_entry__._flagship(tiny=False, production=False)`: a 16-level
blocked bf16 hash grid (2^14 rows per hashed level), bf16-rounded MLP
inputs, a 128^3 x 4 occupancy grid, the hierarchical march with the
packed phase-2 rule, proposal resampling to 16 samples per ray, co_map
with an identity RGB mapper and a powpow event mapper, SO3xR3 `ns` camera
deltas for both cameras, and 3512-ray batches (2318 RGB + 2 x 597 event)
on the 12-camera 64x64 synthetic scene."""

from __future__ import annotations

from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
from lsenerf_tpu_torch.engine.trainer import CameraOptConfig, Trainer, TrainerConfig
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import lsenerf as model_lib
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


def flagship_trainer(device=None, dm_seed: int = 0) -> Trainer:
    """The flagship trainer, set up with fresh parameters from its seed."""
    col, evs = make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
    dm = MultiCamDataManager(
        DataManagerConfig(train_num_rays_per_batch=3512, rgb_frac=0.66),
        col, evs, seed=dm_seed,
    )
    cfg = TrainerConfig(
        col_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="ns"),
        evs_cam_opt=CameraOptConfig(mode="SO3xR3", optim_type="ns"),
    )
    trainer = Trainer(cfg, flagship_model_config(), dm, device=device)
    trainer.setup()
    return trainer
