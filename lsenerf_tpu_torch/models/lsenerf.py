"""LSENeRF model: volume rendering, mapper routing and loss assembly.
Port of lsenerf_tpu/models/lsenerf.py (ModelConfig with normalized(),
init_model, render_bundle, postprocess_outputs with the three map modes,
concat_bundles, slice_outputs, compute_losses, model_forward)."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dc_field
from typing import Optional

import torch

from lsenerf_tpu_torch.cameras.rays import RayBundle
from lsenerf_tpu_torch.engine import spans
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.models import losses as loss_lib
from lsenerf_tpu_torch.models import mappers as mapper_lib
from lsenerf_tpu_torch.ops import composite, march
from lsenerf_tpu_torch.ops import occupancy as occ_lib


def _norm_none(v):
    if isinstance(v, str) and v.lower() in ("none", "false"):
        return None
    return v


@dataclass(frozen=True)
class ModelConfig:
    """The JAX ModelConfig's fields, with its defaults (its
    supergrid_matmul is a TPU layout option the port does not take)."""

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
    hierarchical_march: bool = True
    coarse_factor: int = 8
    max_coarse_segments: int = 24
    packed_phase2: bool = True
    proposal_samples: int = 0
    proposal_uniform_frac: float = 0.2
    # evaluate the field only on the chunks of this many samples that hold
    # a valid one (the valid samples sorted first); 0 evaluates every slot
    compact_chunk: int = 0
    background_color: str = "random"  # random | black | white | last_sample
    evs_loss_weight: float = 1.0
    # log_loss | enerf_norm_loss; a name holding "denerf" renders no next
    # event bundle (the trainer's shortcut) and takes log_loss
    event_loss_type: str = "log_loss"
    # deblur: an RGB pixel is the mean of 4 rays across its exposure
    rgb_loss_type: str = "linspace"  # linspace | deblur
    use_mapping: bool = False
    mapping_method: str = "mlp"
    evs_mapping_method: Optional[str] = None
    map_mode: str = "evs_rgb"  # evs_rgb | rgb_evs | co_map
    ev_one_dim: Optional[str] = "learned"  # learned | gt | None: RGB -> gray before events
    # the blocked layout's train renders also return grad_overflow: the
    # table-gradient updates JAX's sorted windowed backward would drop
    grad_overflow_telemetry: bool = False

    def __post_init__(self):
        # compaction permutes the samples, and the strided coarse-level
        # encode needs each ray's samples in order
        if self.compact_chunk > 0 and self.field.coarse_stride > 1:
            raise ValueError(
                "compact_chunk > 0 and field.coarse_stride > 1 are mutually exclusive: sample "
                "compaction destroys the per-ray sample structure the strided coarse-level "
                "encode lerps over. Disable one of the two.")

    def normalized(self) -> "ModelConfig":
        """String "None"/"False"/"True" cleanup, as the CLI passes them."""
        map_mode = self.map_mode
        if isinstance(map_mode, str) and map_mode.lower() == "none":
            map_mode = "evs_rgb"
        ev = self.ev_one_dim
        if isinstance(ev, str):
            if ev.lower() in ("false", "none"):
                ev = None
            elif ev.lower() == "true":
                ev = "learned"
        rgb_loss = self.rgb_loss_type
        if isinstance(rgb_loss, str) and rgb_loss.lower() == "none":
            rgb_loss = "linspace"
        return dataclasses.replace(
            self, map_mode=map_mode, ev_one_dim=ev, rgb_loss_type=rgb_loss,
            evs_mapping_method=_norm_none(self.evs_mapping_method),
        )

    def march_config(self, train: bool = True) -> march.MarchConfig:
        """The march's configuration; with train False the eval renders',
        without the proposal. Each is built once a config and kept (the
        config is frozen; K3's wrapper finds its launch by these objects)."""
        cached = self.__dict__.get("_march_configs")
        if cached is not None:
            return cached[bool(train)]
        step = self.render_step_size
        if step is None:
            step = 2.0 * self.field.aabb_scale * (3.0**0.5) / 1000.0
        mcfg = march.MarchConfig(
            render_step_size=step,
            near_plane=self.near_plane,
            far_plane=self.far_plane,
            cone_angle=self.cone_angle,
            alpha_thre=self.alpha_thre,
            early_stop_eps=self.early_stop_eps,
            max_samples=self.max_samples,
            max_candidates=self.max_candidates,
            hierarchical=self.hierarchical_march,
            coarse_factor=self.coarse_factor,
            max_coarse_segments=self.max_coarse_segments,
            packed_phase2=self.packed_phase2,
            proposal_samples=self.proposal_samples,
            proposal_uniform_frac=self.proposal_uniform_frac,
        )
        cached = {True: mcfg, False: mcfg}
        if mcfg.proposal_samples:
            cached[False] = dataclasses.replace(mcfg, proposal_samples=0)
        object.__setattr__(self, "_march_configs", cached)
        return cached[bool(train)]


def init_model(generator: torch.Generator, config: ModelConfig, num_imgs: int = 1,
               device="cpu") -> dict:
    """Model params: the field (num_imgs appearance rows under evs_emb),
    the RGB mapper with use_mapping, the event mapper under co_map, and the
    learned RGB -> one reducer."""
    params = {"field": field_lib.init_field(generator, config.field, num_imgs, device)}
    if config.use_mapping:
        params["rgb_mapper"] = mapper_lib.init_mapper(config.mapping_method, generator, device)
    if config.evs_mapping_method is not None and config.map_mode == "co_map":
        params["evs_mapper"] = mapper_lib.init_mapper(config.evs_mapping_method, generator, device)
    if config.ev_one_dim == "learned":
        params["rgb_to_one"] = loss_lib.init_rgb_to_one("learned", device)
    return params


def render_bundle(
    params: dict,
    bundle: RayBundle,
    occ_state: occ_lib.OccGridState,
    config: ModelConfig,
    train: bool = True,
    bg_color: Optional[torch.Tensor] = None,
) -> dict:
    """Volume-render a ray bundle. In training the configured background
    is blended into rgb; for "random", `bg_color` (n, 3) holds its colours
    (the JAX package draws them from its step rng, the caller draws them
    here), and without them the render has none, as JAX's has without an
    rng. Eval renders have no background."""
    with spans.layer("march"):
        samples = march.march_rays(bundle, occ_state, config.grid, config.march_config(train))
    n, k = samples.mask.shape

    app_id = bundle.metadata.get("appearance_id")
    if app_id is None:
        app_id = bundle.camera_indices
    with spans.layer("field"):
        # one id a ray: the field repeats each ray's code over its k samples
        if config.compact_chunk and n * k > config.compact_chunk:
            density, rgb = _compact_field_eval(
                params["field"], samples.positions.reshape(-1, 3), samples.directions.reshape(-1, 3),
                app_id.reshape(n, 1).expand(n, k).reshape(-1), samples.mask.reshape(-1), config, train)
        elif config.field.coarse_stride > 1 and k > config.field.coarse_stride:
            # the strided coarse-level encode lerps along each ray's samples
            t_mid = 0.5 * (samples.t_starts + samples.t_ends)
            density, rgb = field_lib.field_apply_strided(
                params["field"], samples.positions, t_mid, samples.directions.reshape(-1, 3),
                app_id.reshape(n), config.field, train=train,
            )
        else:
            density, rgb = field_lib.field_apply(
                params["field"], samples.positions.reshape(-1, 3),
                samples.directions.reshape(-1, 3), app_id.reshape(n), config.field, train=train,
            )
    density = density.reshape(n, k, 1)
    rgb = rgb.reshape(n, k, 3)

    alpha_thre = config.alpha_thre
    if alpha_thre > 0.0:
        alpha_thre = torch.clamp(occ_state.occs.mean(), max=alpha_thre)
    background = config.background_color if train else "linear"
    if background == "random" and bg_color is None:
        background = "linear"
    with spans.layer("composite"):
        rgb_out, depth, acc = composite.composite(
            density, rgb, samples, alpha_thre, config.early_stop_eps,
            bg_color if background == "random" else None, background)
    out = {
        "rgb": rgb_out,
        "depth": depth,
        "accumulation": acc,
        "num_samples_per_ray": samples.mask.sum(-1),
    }
    if train and config.grad_overflow_telemetry and config.field.hash.layout == "blocked":
        out["grad_overflow"] = overflow_count(samples.positions.reshape(-1, 3), config)
    return out


def overflow_count(positions: torch.Tensor, config: ModelConfig) -> torch.Tensor:
    """The table-gradient updates the JAX package's sorted windowed backward
    would drop for these sample positions (hash_encoding.blocked_overflow_count
    of their contracted unit positions): the grad_overflow metric."""
    from lsenerf_tpu_torch.ops import hash_encoding as he

    with torch.no_grad():
        unit, _ = field_lib.contract_positions(positions.detach(), config.field)
        return he.blocked_overflow_count(unit, config.field.hash)


def _compact_field_eval(field_params: dict, positions, directions, app_ids, valid,
                        config: ModelConfig, train: bool):
    """The field on the chunks of compact_chunk samples that hold a valid
    sample, zeros on the rest. The valid samples are sorted first (a stable
    sort), so the live chunks are a prefix: its length is read from the
    device once, one host sync a call, and the prefix is evaluated in one
    field call (JAX skips each dead chunk with lax.cond instead). The
    permutations' backward is a gather (ops/fast_gather.permute)."""
    from lsenerf_tpu_torch.ops.fast_gather import permute

    nk = positions.shape[0]
    chunk = config.compact_chunk
    order = torch.argsort((~valid).to(torch.uint8), stable=True)  # valid samples first
    inv = torch.argsort(order)
    n_live = min(nk, -(-int(valid.sum()) // chunk) * chunk)  # the host sync
    density_s, rgb_s = positions.new_zeros((nk, 1)), positions.new_zeros((nk, 3))
    if n_live:
        density, rgb = field_lib.field_apply(
            field_params, permute(positions, order, inv)[:n_live],
            permute(directions, order, inv)[:n_live], app_ids[order[:n_live]], config.field,
            train=train)
        density_s = torch.cat([density, density_s[n_live:]])
        rgb_s = torch.cat([rgb, rgb_s[n_live:]])
    # back to ray-major order
    return permute(density_s, inv, order), permute(rgb_s, inv, order)


def _correct_evs_dim(params: dict, config: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if config.ev_one_dim:
        return loss_lib.apply_rgb_to_one(config.ev_one_dim, params.get("rgb_to_one", {}), x)
    return x


def _format_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x] * 3, dim=-1) if x.shape[-1] == 1 else x


def postprocess_outputs(
    params: dict, out: dict, config: ModelConfig, train: bool = True, ev_out: bool = False
) -> dict:
    """Mapper routing on raw render outputs, by map mode, where
    use_mapping is set or the mode is rgb_evs (without use_mapping
    rgb_evs has no RGB mapper and fails, as in JAX):
      evs_rgb: the reduced linear radiance is ev_out, the RGB mapper of the
        linear radiance is rgb;
      rgb_evs: for event bundles (or eval) the RGB mapper of the reduced
        radiance is ev_out;
      co_map: the RGB mapper makes rgb; for event bundles (or eval) the
        event mapper of the reduced radiance is ev_out.
    Under deblur an RGB bundle in training then averages each pixel's 4
    exposure rays (consecutive rows). Then the train clamp (min 1e-5) or
    the eval clamp [0, 1]."""
    out = dict(out)
    clamp_out = torch.clamp(out["rgb"], min=1e-5)
    if config.use_mapping or config.map_mode == "rgb_evs":
        if config.map_mode == "rgb_evs":
            if ev_out or not train:
                out["ev_out"] = mapper_lib.apply_mapper(
                    config.mapping_method, params["rgb_mapper"],
                    _correct_evs_dim(params, config, clamp_out),
                )
                out["linear"] = _format_linear(out["ev_out"])
        elif config.map_mode == "evs_rgb":
            out["ev_out"] = _correct_evs_dim(params, config, clamp_out)
            out["linear"] = clamp_out
            out["rgb"] = mapper_lib.apply_mapper(
                config.mapping_method, params["rgb_mapper"], clamp_out
            )
        elif config.map_mode == "co_map":
            out["rgb"] = mapper_lib.apply_mapper(
                config.mapping_method, params["rgb_mapper"], clamp_out
            )
            if ev_out or not train:
                ev_linear = _correct_evs_dim(params, config, clamp_out)
                out["linear"] = clamp_out
                out["ev_linear"] = ev_linear
                out["ev_out"] = mapper_lib.apply_mapper(
                    config.evs_mapping_method, params["evs_mapper"], ev_linear
                )
    if config.rgb_loss_type == "deblur" and train and not ev_out:
        out["rgb"] = out["rgb"].reshape(-1, 4, 3).mean(1)
    if train:
        out["rgb"] = torch.clamp(out["rgb"], min=1e-5)
    else:
        out["rgb"] = torch.clamp(out["rgb"], 0.0, 1.0)
    return out


def model_forward(params: dict, bundle: RayBundle, occ_state: occ_lib.OccGridState,
                  config: ModelConfig, train: bool = True, ev_out: bool = False,
                  bg_color: Optional[torch.Tensor] = None) -> dict:
    """Volume render and postprocess of a single bundle."""
    out = render_bundle(params, bundle, occ_state, config, train=train, bg_color=bg_color)
    return postprocess_outputs(params, out, config, train=train, ev_out=ev_out)


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
                   col_batch, evs_batch, batch_sum=None) -> dict:
    """rgb_loss (MSE) and the weighted event loss, which reads ev_out, or
    rgb where there is no mapping. Under data parallelism each loss is this
    rank's share of the global batch's: the means over rays average over
    the ranks, and enerf_norm_loss's norms over the batch take their sums
    of squares over every rank through `batch_sum`."""
    loss_dict = {}
    if col_out is not None:
        loss_dict["rgb_loss"] = loss_lib.mse_loss(col_batch["image"], col_out["rgb"])
    if prev_out is not None:
        ev_key = "ev_out" if config.use_mapping else "rgb"
        prev_in, next_in = prev_out[ev_key], next_out[ev_key]
        evs = evs_batch["image"]
        if prev_in.shape[-1] != 1:
            evs = torch.cat([evs] * 3, dim=-1)
        if config.event_loss_type == "enerf_norm_loss":
            ev_loss = loss_lib.enerf_norm_loss(evs, prev_in, next_in, evs_batch["e_thresh"],
                                               batch_sum=batch_sum)
        else:
            ev_loss = loss_lib.log_loss(evs, prev_in, next_in)
        loss_dict["event_loss"] = config.evs_loss_weight * ev_loss
    return loss_dict
