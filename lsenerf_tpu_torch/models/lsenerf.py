"""LSENeRF model: volume rendering, mapper routing and loss assembly.
Port of lsenerf_tpu/models/lsenerf.py (render_bundle, postprocess_outputs,
concat_bundles, slice_outputs, compute_losses)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dc_field
from typing import Optional

import torch

from lsenerf_tpu_torch.cameras.rays import RayBundle
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import losses as loss_lib
from lsenerf_tpu_torch.models import mappers as mapper_lib
from lsenerf_tpu_torch.ops import composite, march
from lsenerf_tpu_torch.ops import occupancy as occ_lib


@dataclass(frozen=True)
class ModelConfig:
    """The JAX ModelConfig's fields for the ported path. Mapping is always
    co_map (an RGB mapper and an event mapper on the shared linear
    radiance); the evs_rgb/rgb_evs modes are not ported yet."""

    field: field_lib.FieldConfig = dc_field(default_factory=field_lib.FieldConfig)
    grid: occ_lib.OccGridConfig = dc_field(default_factory=occ_lib.OccGridConfig)
    render_step_size: Optional[float] = None  # None -> scene diag / 1000
    near_plane: float = 0.05
    far_plane: float = 1e3
    cone_angle: float = 0.004
    alpha_thre: float = 0.01
    early_stop_eps: float = 1e-4
    max_samples: int = 48
    max_candidates: int = 1024
    coarse_factor: int = 8
    max_coarse_segments: int = 24
    proposal_samples: int = 0
    proposal_uniform_frac: float = 0.2
    evs_loss_weight: float = 1.0
    mapping_method: str = "identity"
    evs_mapping_method: str = "powpow"
    ev_one_dim: Optional[str] = "gt"  # RGB -> gray before the event mapper

    def march_config(self) -> march.MarchConfig:
        step = self.render_step_size
        if step is None:
            step = 2.0 * self.field.aabb_scale * (3.0**0.5) / 1000.0
        return march.MarchConfig(
            render_step_size=step,
            near_plane=self.near_plane,
            far_plane=self.far_plane,
            cone_angle=self.cone_angle,
            alpha_thre=self.alpha_thre,
            early_stop_eps=self.early_stop_eps,
            max_samples=self.max_samples,
            max_candidates=self.max_candidates,
            coarse_factor=self.coarse_factor,
            max_coarse_segments=self.max_coarse_segments,
            proposal_samples=self.proposal_samples,
            proposal_uniform_frac=self.proposal_uniform_frac,
        )


def init_model(generator: torch.Generator, config: ModelConfig, device="cpu") -> dict:
    """Model params: the field and the two mappers."""
    return {
        "field": field_lib.init_field(generator, config.field, device),
        "rgb_mapper": mapper_lib.init_mapper(config.mapping_method, device),
        "evs_mapper": mapper_lib.init_mapper(config.evs_mapping_method, device),
    }


def render_bundle(
    params: dict,
    bundle: RayBundle,
    occ_state: occ_lib.OccGridState,
    config: ModelConfig,
    train: bool = True,
    bg_color: Optional[torch.Tensor] = None,
) -> dict:
    """Volume-render a ray bundle. In training, `bg_color` (n, 3) is the
    per-ray random background blended into rgb (the JAX package draws it
    from its step rng; the caller draws it here)."""
    mcfg = config.march_config()
    if not train and mcfg.proposal_samples:
        mcfg = dataclasses.replace(mcfg, proposal_samples=0)
    samples = march.march_rays(bundle, occ_state, config.grid, mcfg)
    n, k = samples.mask.shape

    app_id = bundle.metadata.get("appearance_id")
    if app_id is None:
        app_id = bundle.camera_indices
    app_ids = app_id.reshape(n, 1).expand(n, k).reshape(-1)
    density, rgb = field_lib.field_apply(
        params["field"], samples.positions.reshape(-1, 3),
        samples.directions.reshape(-1, 3), app_ids, config.field,
    )
    density = density.reshape(n, k, 1)
    rgb = rgb.reshape(n, k, 3)

    alpha_thre = config.alpha_thre
    if alpha_thre > 0.0:
        alpha_thre = torch.clamp(occ_state.occs.mean(), max=alpha_thre)
    weights = composite.render_weights(samples, density, alpha_thre, config.early_stop_eps)
    return {
        "rgb": composite.render_rgb(weights, rgb, bg_color if train else None),
        "depth": composite.render_depth(weights, samples),
        "accumulation": composite.render_accumulation(weights),
        "num_samples_per_ray": samples.mask.sum(-1),
    }


def postprocess_outputs(
    params: dict, out: dict, config: ModelConfig, train: bool = True, ev_out: bool = False
) -> dict:
    """co_map routing on raw render outputs: the RGB mapper makes rgb; for
    event bundles (or eval) the clamped linear radiance, reduced to one
    channel by ev_one_dim, goes through the event mapper. Then the train
    clamp (min 1e-5) or the eval clamp [0, 1]."""
    out = dict(out)
    clamp_out = torch.clamp(out["rgb"], min=1e-5)
    out["rgb"] = mapper_lib.apply_mapper(config.mapping_method, params["rgb_mapper"], clamp_out)
    if ev_out or not train:
        ev_linear = loss_lib.apply_rgb_to_one(config.ev_one_dim, clamp_out)
        out["linear"] = clamp_out
        out["ev_linear"] = ev_linear
        out["ev_out"] = mapper_lib.apply_mapper(
            config.evs_mapping_method, params["evs_mapper"], ev_linear
        )
    if train:
        out["rgb"] = torch.clamp(out["rgb"], min=1e-5)
    else:
        out["rgb"] = torch.clamp(out["rgb"], 0.0, 1.0)
    return out


def concat_bundles(bundles) -> RayBundle:
    """Concatenate ray bundles along the ray axis (shared metadata keys)."""

    def cat(xs):
        return None if xs[0] is None else torch.cat(xs, 0)

    first = bundles[0]
    fields = {
        f.name: cat([getattr(b, f.name) for b in bundles])
        for f in dataclasses.fields(first) if f.name != "metadata"
    }
    meta = {k: cat([b.metadata[k] for b in bundles]) for k in first.metadata}
    return RayBundle(**fields, metadata=meta)


def slice_outputs(out: dict, start: int, stop: int) -> dict:
    return {k: v[start:stop] for k, v in out.items()}


def compute_losses(params, config: ModelConfig, col_out, prev_out, next_out,
                   col_batch, evs_batch) -> dict:
    loss_dict = {}
    if col_out is not None:
        loss_dict["rgb_loss"] = loss_lib.mse_loss(col_batch["image"], col_out["rgb"])
    if prev_out is not None:
        prev_in, next_in = prev_out["ev_out"], next_out["ev_out"]
        evs = evs_batch["image"]
        if prev_in.shape[-1] != 1:
            evs = torch.cat([evs] * 3, dim=-1)
        loss_dict["event_loss"] = config.evs_loss_weight * loss_lib.log_loss(
            evs, prev_in, next_in
        )
    return loss_dict
