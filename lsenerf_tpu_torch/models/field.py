"""The LSE NeRF field: hash-grid density branch + SH-direction colour branch
with the appearance embedding. Port of lsenerf_tpu/models/field.py.

bf16 compute: the JAX field casts the MLP *input* to bf16 while the
weights stay f32, and `bf16 @ f32` promotes to f32 (field.py:146-147,
279-282). So the "bf16 MLPs" are f32 matmuls of bf16-rounded inputs, and
their backward rounds the input cotangent to bf16. The port does the same:
`x.to(bfloat16).float()` and an f32 matmul (a true bf16 matmul would be a
different function). Every path's MLP head, after the encode, is `head`:
the plain chain (`head_plain`) on CPU tensors, K9a/K9b
(ops/field_head.py) on CUDA tensors.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field as dc_field

import torch

from lsenerf_tpu_torch.models import embeddings as emb_lib
from lsenerf_tpu_torch.models import mlp
from lsenerf_tpu_torch.ops import field_head
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
    aabb_scale: float = 1.0  # scene box [-s, s]^3; sets the march's auto step (diag / 1000)
    use_contraction: bool = True  # the L-inf scene contraction, else the aabb
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
    # strided coarse-level sampling: the lowest coarse_levels levels are
    # encoded at every coarse_stride-th sample of a ray (and its last) and
    # lerped in t between these anchors; 1 is the plain path
    coarse_stride: int = 1
    coarse_levels: int = 4

    def __post_init__(self):
        # coarse_levels=0 would be the level_hi=0 "all levels" sentinel, and
        # coarse_levels >= num_levels leaves the fine encode no level
        if self.coarse_stride > 1 and not 0 < self.coarse_levels < self.hash.num_levels:
            raise ValueError(
                f"coarse_stride={self.coarse_stride} requires 0 < coarse_levels < num_levels "
                f"(got coarse_levels={self.coarse_levels}, num_levels={self.hash.num_levels})"
            )


@functools.lru_cache(maxsize=None)
def _anchors(k: int, S: int, device: torch.device) -> torch.Tensor:
    """Samples 0, S, 2S, ... and k - 1, made once a shape and device: a
    copy from the host inside a captured CUDA graph would fail."""
    idx = list(range(0, k, S))
    if idx[-1] != k - 1:
        idx.append(k - 1)
    return torch.tensor(idx, device=device)


def init_field(generator: torch.Generator, config: FieldConfig, num_imgs: int = 1,
               device="cpu") -> dict:
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
        params["appearance"] = emb_lib.init_embedding(
            generator, config.embedding, num_imgs, device
        )
    return params


def contract_positions(positions: torch.Tensor, config: FieldConfig):
    """World positions -> (unit-cube field inputs, in-bounds selector): the
    L-inf scene contraction into [-2, 2], then (x + 2) / 4; without
    contraction, (x + s) / 2s over the aabb [-s, s]^3. Out-of-range inputs
    are zeroed before they reach the (periodic) hash table."""
    if config.use_contraction:
        mag = torch.amax(torch.abs(positions), dim=-1, keepdim=True)
        contracted = torch.where(mag <= 1.0, positions, (2.0 - 1.0 / mag) * positions / mag)
        unit = (contracted + 2.0) / 4.0
    else:
        s = config.aabb_scale
        unit = (positions + s) / (2.0 * s)
    selector = torch.all((unit > 0.0) & (unit < 1.0), dim=-1)
    return unit * selector[..., None], selector


def _mlp_input(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x rounded to bf16 and back where bf16 (its cotangent is rounded too)."""
    return x.to(torch.bfloat16).float() if bf16 else x


def expand_codes(codes, n: int):
    """(m, E) codes, one a ray, repeated over each ray's n / m samples."""
    if codes is None or codes.shape[0] == n:
        return codes
    m = codes.shape[0]
    return codes[:, None, :].expand(m, n // m, codes.shape[1]).reshape(n, codes.shape[1])


def head_plain(base: dict, color, feats, selector, dirs, codes, aid: float, bf16: bool,
               sh_levels: int = 4):
    """head by torch ops: the base MLP on the features, density =
    aid * trunc_exp(h[0]) * selector, then (with directions) the colour MLP
    on [SH(dirs), geo = h[1:], the codes] and a sigmoid."""
    h = mlp.apply_mlp(base, _mlp_input(feats, bf16))
    density = aid * trunc_exp(h[..., :1]) * selector[..., None]
    if dirs is None:
        return density, None
    pieces = [sh.sh_encode(dirs, sh_levels), h[..., 1:]]
    if codes is not None:
        pieces.append(expand_codes(codes, feats.shape[0]))
    x = _mlp_input(torch.cat(pieces, dim=-1), bf16)
    return density, mlp.apply_mlp(color, x, out_activation=torch.sigmoid)


def _on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def head(base: dict, color, feats, selector, dirs, codes, aid: float, bf16: bool,
         sh_levels: int = 4):
    """(density (n, 1), rgb (n, 3); rgb None without directions) of the
    encode's features (n, L*F), the selector (n,), the directions (n, 3) or
    None (density alone), and the codes (m, E), one a ray of n / m samples,
    or None: head_plain on CPU tensors, K9a/K9b (field_head.head) on CUDA
    tensors, which raise ValueError for widths they do not take."""
    if not _on_card(feats):
        return head_plain(base, color, feats, selector, dirs, codes, aid, bf16, sh_levels)
    return field_head.head(base, color, feats, selector, dirs, codes, aid, bf16, sh_levels)


def _head(params: dict, feats: torch.Tensor, selector: torch.Tensor, directions, codes,
          config: FieldConfig):
    """The one head of every path."""
    color = params["color_mlp"] if directions is not None else None
    return head(params["base_mlp"], color, feats, selector, directions, codes,
                config.average_init_density, _bf16(config), config.sh_levels)


def _bf16(config: FieldConfig) -> bool:
    return config.compute_dtype == "bfloat16"


def _features(params: dict, positions: torch.Tensor, config: FieldConfig):
    unit, selector = contract_positions(positions, config)
    return he.hash_encode(params["hash_table"], unit, config.hash), selector


def _strided_encode(params: dict, unit: torch.Tensor, ts: torch.Tensor, config: FieldConfig,
                    selector: torch.Tensor) -> torch.Tensor:
    """Hash features with the coarse levels anchored at every
    coarse_stride-th sample (and the last) and lerped in t between anchors.

    unit: (n, k, 3) unit-cube positions; ts: (n, k) sample midpoints;
    selector: (n, k) in-bounds mask. Returns (n*k, out_dim) features laid
    out as the plain encode's (coarse levels first). Invalid trailing slots
    sit at t=0, so their lerp denominators are not positive and the clip
    takes the left (valid) anchor. Where exactly one anchor of a pair is out
    of bounds (its encode is the zeroed corner's), the weight snaps to the
    valid one."""
    n, k, _ = unit.shape
    C, S = config.coarse_levels, config.coarse_stride
    table = params["hash_table"]
    feats_fine = he.hash_encode(table, unit.reshape(-1, 3),
                                dataclasses.replace(config.hash, level_lo=C))
    anchors = _anchors(k, S, unit.device)
    A = len(anchors)
    feats_a = he.hash_encode(table, unit[:, anchors].reshape(-1, 3),
                             dataclasses.replace(config.hash, level_hi=C)).reshape(n, A, -1)
    # sample j lies between anchors seg(j) and seg(j) + 1
    seg = torch.clamp(torch.arange(k, device=unit.device) // S, max=A - 2)
    t_left, t_right = ts[:, anchors[seg]], ts[:, anchors[seg + 1]]
    denom = t_right - t_left
    ok = denom > 1e-12
    w = torch.where(ok, (ts - t_left) / torch.where(ok, denom, torch.ones_like(denom)),
                    torch.zeros_like(ts))
    w = torch.clamp(w, 0.0, 1.0)
    sel_a = selector.reshape(n, k)[:, anchors]
    sl, sr = sel_a[:, seg], sel_a[:, seg + 1]
    w = torch.where(sl & ~sr, torch.zeros_like(w), torch.where(~sl & sr, torch.ones_like(w), w))
    w = w[..., None]
    feats_coarse = (1.0 - w) * feats_a[:, seg] + w * feats_a[:, seg + 1]
    return torch.cat([feats_coarse.reshape(n * k, -1), feats_fine], dim=-1)


def _strided_features(params: dict, positions: torch.Tensor, ts: torch.Tensor,
                      config: FieldConfig):
    n, k, _ = positions.shape
    unit, selector = contract_positions(positions.reshape(-1, 3), config)
    return _strided_encode(params, unit.reshape(n, k, 3), ts, config, selector), selector


def ray_codes(params: dict, appearance_id: torch.Tensor, config: FieldConfig,
              train: bool = True):
    """(m, emb_dim) codes of m ids (one a sample, or one a ray of
    consecutive samples), or None without an appearance embedding."""
    if "appearance" not in params:
        return None
    return emb_lib.apply_embedding(params["appearance"], config.embedding,
                                   appearance_id.reshape(-1), train=train)


def appearance_codes(params: dict, appearance_id: torch.Tensor, n: int, config: FieldConfig,
                     train: bool = True) -> torch.Tensor:
    """(n, emb_dim) codes for n samples from one id a sample, or from one
    id a ray of n / len(ids) consecutive samples: then each ray's code is
    looked up once and repeated, so the table's gradient gathers a sum
    over each ray's samples instead of one addition a sample."""
    return expand_codes(ray_codes(params, appearance_id, config, train), n)


def field_apply(
    params: dict,
    positions: torch.Tensor,
    directions: torch.Tensor,
    appearance_id: torch.Tensor,
    config: FieldConfig,
    train: bool = True,
):
    """Full field evaluation -> (density (n, 1), rgb (n, 3)).
    `appearance_id` holds one id a sample or one a ray (appearance_codes)."""
    feats, selector = _features(params, positions, config)
    return _head(params, feats, selector, directions,
                 ray_codes(params, appearance_id, config, train), config)


def field_apply_strided(
    params: dict,
    positions: torch.Tensor,
    ts: torch.Tensor,
    directions: torch.Tensor,
    appearance_id: torch.Tensor,
    config: FieldConfig,
    train: bool = True,
):
    """field_apply over (n, k)-structured samples (positions (n, k, 3), ts
    (n, k)) with the strided coarse-level encode; directions arrive flat
    (n*k, 3) and `appearance_id` as field_apply takes it."""
    feats, selector = _strided_features(params, positions, ts, config)
    return _head(params, feats, selector, directions,
                 ray_codes(params, appearance_id, config, train), config)


def density_fn(params: dict, positions: torch.Tensor, config: FieldConfig) -> torch.Tensor:
    """Density only: the occupancy-grid update's closure."""
    feats, selector = _features(params, positions, config)
    return _head(params, feats, selector, None, None, config)[0]
