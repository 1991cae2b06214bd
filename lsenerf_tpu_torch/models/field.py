"""The LSE NeRF field: hash-grid density branch + SH-direction colour branch
with the appearance embedding. Port of lsenerf_tpu/models/field.py.

bf16 compute: the JAX field casts the MLP *input* to bf16 while the
weights stay f32, and `bf16 @ f32` promotes to f32 (field.py:146-147,
279-282). So the "bf16 MLPs" are f32 matmuls of bf16-rounded inputs, and
their backward rounds the input cotangent to bf16. The port does the same:
`x.to(bfloat16).float()` and an f32 matmul (a true bf16 matmul would be a
different function).
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

import torch

from lsenerf_tpu_torch.models import embeddings as emb_lib
from lsenerf_tpu_torch.models import mlp
from lsenerf_tpu_torch.ops import hash_encoding as he
from lsenerf_tpu_torch.ops import sh


class _TruncExp(torch.autograd.Function):
    """exp with a clamped-gradient backward (nerfstudio trunc_exp)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


@dataclass(frozen=True)
class FieldConfig:
    aabb_scale: float = 1.0  # sets the march's auto step (diag / 1000)
    num_layers: int = 2
    hidden_dim: int = 64
    geo_feat_dim: int = 15
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    appearance_embedding_dim: int = 32
    average_init_density: float = 1.0
    sh_levels: int = 4
    hash: he.HashEncodingConfig = dc_field(default_factory=he.HashEncodingConfig)
    embedding: emb_lib.EmbeddingConfig = dc_field(
        default_factory=emb_lib.EmbeddingConfig
    )
    compute_dtype: str = "float32"  # "bfloat16": bf16-rounded MLP inputs


def init_field(generator: torch.Generator, config: FieldConfig, device="cpu") -> dict:
    app_dim = config.embedding.emb_dim if config.appearance_embedding_dim > 0 else 0
    params = {
        "hash_table": he.init_hash_table(config.hash, generator, device),
        "base_mlp": mlp.init_mlp(
            generator, config.hash.out_dim, config.num_layers, config.hidden_dim,
            1 + config.geo_feat_dim, device,
        ),
        "color_mlp": mlp.init_mlp(
            generator, config.sh_levels**2 + config.geo_feat_dim + app_dim,
            config.num_layers_color, config.hidden_dim_color, 3, device,
        ),
    }
    if app_dim > 0:
        params["appearance"] = emb_lib.init_embedding(generator, config.embedding, device)
    return params


def _mlp_input(x: torch.Tensor, config: FieldConfig) -> torch.Tensor:
    if config.compute_dtype == "bfloat16":
        return x.to(torch.bfloat16).float()
    return x


def contract_positions(positions: torch.Tensor, config: FieldConfig):
    """World positions -> (unit-cube field inputs, in-bounds selector): the
    L-inf scene contraction into [-2, 2], then (x + 2) / 4. The aabb
    normalisation without contraction is not ported yet."""
    mag = torch.amax(torch.abs(positions), dim=-1, keepdim=True)
    contracted = torch.where(mag <= 1.0, positions, (2.0 - 1.0 / mag) * positions / mag)
    unit = (contracted + 2.0) / 4.0
    selector = torch.all((unit > 0.0) & (unit < 1.0), dim=-1)
    return unit * selector[..., None], selector


def field_density(params: dict, positions: torch.Tensor, config: FieldConfig):
    """(n, 3) world positions -> (density (n, 1), geo_feat (n, geo_feat_dim))."""
    unit, selector = contract_positions(positions, config)
    feats = he.hash_encode(params["hash_table"], unit, config.hash)
    h = mlp.apply_mlp(params["base_mlp"], _mlp_input(feats, config))
    density_before, geo = h[..., :1], h[..., 1:]
    density = config.average_init_density * trunc_exp(density_before)
    return density * selector[..., None], geo


def field_apply(
    params: dict,
    positions: torch.Tensor,
    directions: torch.Tensor,
    appearance_id: torch.Tensor,
    config: FieldConfig,
):
    """Full field evaluation -> (density (n, 1), rgb (n, 3))."""
    density, geo = field_density(params, positions, config)
    pieces = [sh.sh_encode(directions, config.sh_levels), geo]
    if "appearance" in params:
        pieces.append(emb_lib.apply_embedding(params["appearance"], appearance_id))
    h = torch.cat(pieces, dim=-1)
    rgb = mlp.apply_mlp(
        params["color_mlp"], _mlp_input(h, config), out_activation=torch.sigmoid
    )
    return density, rgb


def density_fn(params: dict, positions: torch.Tensor, config: FieldConfig) -> torch.Tensor:
    """Density only: the occupancy-grid update's closure."""
    return field_density(params, positions, config)[0]
