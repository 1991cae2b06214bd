"""The paper's presets as the reference builds them: a frozen copy of the
port's `flagship.preset_model_config` / `preset_configs` (configs/*.sh
under scripts/train_lse_data.sh's protocol, the CLI's other defaults) on
the frozen modules, and the ray budget of its DataManagerConfig."""

from __future__ import annotations

import dataclasses

from perfbench.frozen.ref.models import embeddings as emb_lib
from perfbench.frozen.ref.models import field as field_lib
from perfbench.frozen.ref.models import lsenerf as model_lib
from perfbench.frozen.ref.ops import hash_encoding as he
from perfbench.frozen.ref.trainer import CamOpt, Setting

# configs/*.sh: rgb_frac, use_map, mapping_method, map_mode,
# evs_mapping_method, emb_type
PRESETS = {
    "lsenerf": (0.66, True, "identity", "co_map", "powpow", "global_emb"),
    "lsenerf_emb": (0.66, True, "identity", "co_map", "powpow", "evs_emb"),
    "badnerf": (1.0, False, "identity", "None", "None", "global_emb"),
    "badnerf_emb": (1.0, False, "identity", "None", "None", "evs_emb"),
}


def model_config(preset: str, hash_layout: str = "blocked", compute_dtype: str = "bfloat16",
                 coarse_stride: int = 1, hash_fields: dict | None = None) -> model_lib.ModelConfig:
    """The preset's model under the production protocol (deblur x4)."""
    _, use_map, mapping, map_mode, evs_mapping, emb_type = PRESETS[preset]
    hash_cfg = he.HashEncodingConfig(layout=hash_layout, gather_dtype=compute_dtype,
                                     **(hash_fields or {}))
    field = field_lib.FieldConfig(embedding=emb_lib.EmbeddingConfig(emb_type), hash=hash_cfg,
                                  compute_dtype=compute_dtype, coarse_stride=coarse_stride)
    return dataclasses.replace(
        model_lib.ModelConfig(field=field, ev_one_dim="gt"),
        proposal_samples=0 if emb_type == "evs_emb" else 16,
        use_mapping=use_map, mapping_method=mapping, map_mode=map_mode,
        evs_mapping_method=evs_mapping, rgb_loss_type="deblur",
    ).normalized()


def ray_budget(preset: str, rays: int = 3512) -> tuple:
    """(RGB pixels, event rays of each of prev and next) a step: events
    (1 - rgb_frac) / 2 each, RGB the rest, a quarter of it under deblur."""
    rgb_frac = PRESETS[preset][0]
    n_evs = int((1 - rgb_frac) * rays * 0.5)
    return int((rays - 2 * n_evs) * 0.25), n_evs


def setting(preset: str, rays: int = 3512) -> Setting:
    """The train step's setting: the RGB spline (exposure 30,000) and the
    event cameras' SO3xR3 deltas, as prev/next pairs where the scene has
    events; the fields' and cameras' Adam schedules; the ray budget."""
    n_col, n_evs = ray_budget(preset, rays)
    return Setting(col_cam_opt=CamOpt(mode="SO3xR3", optim_type="spline", exp_t=30000.0),
                   evs_cam_opt=CamOpt(mode="SO3xR3", optim_type="prevnext"),
                   n_col=n_col, n_evs=n_evs)
