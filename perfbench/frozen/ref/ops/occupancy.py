"""Multi-level binary occupancy grid: lookups and EMA updates.
Port of lsenerf_tpu/ops/occupancy.py.

The grid is a dense (levels, R, R, R) f32 EMA plus its binarization. Level l
covers the base aabb enlarged by 2^l. The TPU's matmul and bit-packed lookup
variants are layout tricks; the port keeps their semantics with plain
lookups (march.py keeps the packed phase-2 rule).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

_LN2_F32 = float(np.log(np.float32(2.0)).astype(np.float32))


@dataclass(frozen=True)
class OccGridConfig:
    resolution: int = 128
    levels: int = 4
    aabb_scale: float = 1.0
    occ_thre: float = 0.01
    ema_decay: float = 0.95
    update_interval: int = 16
    sample_fraction: float = 0.03125
    init_jitter_updates: float = 60.0


@dataclass
class OccGridState:
    """The grid. A state is never changed in place: every update makes a
    new one, so what is derived from its binaries is built once a state."""

    occs: torch.Tensor  # (levels, R, R, R) f32 EMA densities
    binaries: torch.Tensor  # (levels, R, R, R) bool

    def super_binaries(self, factor: int) -> torch.Tensor:
        """build_super_binaries(self.binaries, factor), built at the first
        call on this state and kept."""
        cache = self.__dict__.setdefault("_super", {})
        if factor not in cache:
            cache[factor] = build_super_binaries(self.binaries, factor)
        return cache[factor]


def init_occ_grid(
    config: OccGridConfig, device="cpu", jitter: torch.Tensor | None = None
) -> OccGridState:
    """Optimistic init: occs = ema_decay ** (u * init_jitter_updates).

    `u` is U(0, 1) per cell. The JAX package draws it from PRNGKey(961103);
    torch cannot reproduce that stream, so `jitter` takes u from the caller
    (the tests pass JAX's), and by default it comes from a torch generator
    seeded 961103."""
    R = config.resolution
    shape = (config.levels, R, R, R)
    occs = torch.ones(shape, dtype=torch.float32, device=device)
    if config.init_jitter_updates > 0:
        if jitter is None:
            gen = torch.Generator(device=device).manual_seed(961103)
            jitter = torch.rand(shape, generator=gen, device=device)
        occs = config.ema_decay ** (jitter.to(device) * config.init_jitter_updates)
    return OccGridState(occs=occs, binaries=torch.ones(shape, dtype=torch.bool, device=device))


def _log2(x: torch.Tensor) -> torch.Tensor:
    """log(x) / log(2) in f32, the way jnp.log2 computes it."""
    return torch.log(x) / torch.full_like(x, _LN2_F32)


def level_of_positions(positions: torch.Tensor, config: OccGridConfig) -> torch.Tensor:
    """Finest grid level whose aabb contains each (..., 3) position, int32."""
    mag = torch.amax(positions.abs(), dim=-1) / config.aabb_scale
    lvl = torch.ceil(_log2(torch.clamp(mag, min=1e-12)))
    return torch.clamp(lvl, 0, config.levels - 1).to(torch.int32)


def _cell_coords(x, y, z, R: int, config: OccGridConfig):
    """Level-selecting cell coordinates (lvl, ix, iy, iz), int64."""
    mag = torch.maximum(torch.maximum(x.abs(), y.abs()), z.abs())
    lvl = torch.ceil(_log2(torch.clamp(mag / config.aabb_scale, min=1e-12)))
    lvl = torch.clamp(lvl, 0, config.levels - 1)
    half = config.aabb_scale * torch.exp2(lvl)
    inv = R / (2.0 * half)

    def cell(c):
        return torch.clamp(torch.floor((c + half) * inv), 0, R - 1).long()

    return lvl.long(), cell(x), cell(y), cell(z)


def _flat_cell_index(x, y, z, R: int, config: OccGridConfig):
    lvl, ix, iy, iz = _cell_coords(x, y, z, R, config)
    return ((lvl * R + ix) * R + iy) * R + iz


def _take(grid: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """grid's cells at flat indices (any shape)."""
    return grid.reshape(-1)[flat.reshape(-1)].reshape(flat.shape)


def _grid_lookup(grid: torch.Tensor, x, y, z, config: OccGridConfig):
    """Level-selecting cell lookup into a (levels, R, R, R) grid."""
    return _take(grid, _flat_cell_index(x, y, z, grid.shape[-1], config))


def occupancy_at_coords(state: OccGridState, x, y, z, config: OccGridConfig):
    """Coordinate-separate occupancy lookup (any common shape) -> bool."""
    return _grid_lookup(state.binaries, x, y, z, config)


def occupancy_at(state: OccGridState, positions: torch.Tensor, config: OccGridConfig):
    """(n, 3) world positions -> (n,) bool occupancy at their finest level."""
    return occupancy_at_coords(state, positions[:, 0], positions[:, 1], positions[:, 2], config)


def ema_at_coords(occs: torch.Tensor, x, y, z, config: OccGridConfig):
    """Level-selecting EMA lookup (the march's proposal signal)."""
    return _grid_lookup(occs, x, y, z, config)


def build_super_binaries(binaries: torch.Tensor, factor: int) -> torch.Tensor:
    """(levels, S, S, S) supergrid, S = R // factor: a supercell is occupied
    iff any of its fine cells is, OR'd with the spatially overlapping cells of
    the adjacent levels (level aabbs nest by 2x)."""
    L, R = binaries.shape[0], binaries.shape[-1]
    S = R // factor
    sb = binaries.reshape(L, S, factor, S, factor, S, factor).any(6).any(4).any(2)
    if L > 1 and S >= 4 and S % 4 == 0:
        q = S // 4
        h = S // 2
        down = sb.reshape(L, h, 2, h, 2, h, 2).any(6).any(4).any(2)
        center = sb[:, q : 3 * q, q : 3 * q, q : 3 * q]
        up = center.repeat_interleave(2, 1).repeat_interleave(2, 2).repeat_interleave(2, 3)
        merged = sb.clone()
        merged[:-1] |= up[1:]
        merged[1:, q : 3 * q, q : 3 * q, q : 3 * q] |= down[:-1]
        sb = merged
    return sb


def binarize(occs: torch.Tensor, config: OccGridConfig) -> torch.Tensor:
    return occs > torch.clamp(occs.mean(), max=config.occ_thre)


def full_update(state: OccGridState, density_eval: torch.Tensor,
                config: OccGridConfig) -> OccGridState:
    """The warmup-phase update with a density at every cell: a new state of
    occs = max(old * decay, density) and its binaries; `state` is not
    written. density_eval: (levels, R^3), post-activation density x step
    size at the (jittered) cell centres, evaluated with no gradient."""
    occs = torch.maximum(state.occs * config.ema_decay, density_eval.reshape(state.occs.shape))
    return OccGridState(occs=occs, binaries=binarize(occs, config))


def scatter_update(occs: torch.Tensor, cell_ids: torch.Tensor, density_eval: torch.Tensor,
                   config: OccGridConfig) -> torch.Tensor:
    """Decay every cell, then set the sampled cells to
    max(old * decay, density): the new EMA.

    cell_ids: (levels, m) flat indices within each level; density_eval:
    (levels, m); a density of -inf leaves its cell decayed. A cell drawn
    twice gets the larger of its two values: JAX leaves the winner of a
    duplicate scatter unspecified, the port makes it deterministic."""
    occs_flat = occs.reshape(config.levels, -1)
    updated = torch.maximum(torch.gather(occs_flat, 1, cell_ids) * config.ema_decay, density_eval)
    new = occs_flat * config.ema_decay
    new = new.scatter_reduce(1, cell_ids, updated, reduce="amax", include_self=False)
    return new.reshape(occs.shape)


def sampled_update(
    state: OccGridState,
    cell_ids: torch.Tensor,
    density_eval: torch.Tensor,
    config: OccGridConfig,
) -> OccGridState:
    """scatter_update, then the binaries at min(mean, occ_thre)."""
    new = scatter_update(state.occs, cell_ids, density_eval, config)
    return OccGridState(occs=new, binaries=binarize(new, config))


def update_positions(cell_ids: torch.Tensor, jitter: torch.Tensor, config: OccGridConfig):
    """(levels, m) cell ids + (levels, m, 3) U(0, 1) jitter -> world positions."""
    R = config.resolution
    i = cell_ids // (R * R)
    j = (cell_ids // R) % R
    k = cell_ids % R
    unit = (torch.stack([i, j, k], dim=-1).float() + jitter) / R
    return (unit * 2.0 - 1.0) * _halves(config, cell_ids.device)[:, None, None]


def sample_update_positions(
    generator: torch.Generator, config: OccGridConfig, num_cells: int, device="cpu"
):
    """Draw cells and jittered world positions for a sampled update.
    Returns (cell_ids (levels, m) int64, positions (levels, m, 3))."""
    R = config.resolution
    cell_ids = torch.randint(
        0, R**3, (config.levels, num_cells), generator=generator, device=device
    )
    jitter = torch.rand((config.levels, num_cells, 3), generator=generator, device=device)
    return cell_ids, update_positions(cell_ids, jitter, config)


def _halves(config: OccGridConfig, device) -> torch.Tensor:
    """(levels,) half-widths of the levels' aabbs, s * 2^l."""
    return config.aabb_scale * torch.exp2(
        torch.arange(config.levels, dtype=torch.float32, device=device))


def _cell_centers(config: OccGridConfig, device="cpu") -> torch.Tensor:
    """(levels, R^3, 3) world-space centres of every cell at every level."""
    R = config.resolution
    ar = torch.arange(R, device=device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
    unit = (idx.float() + 0.5) / R
    return (unit[None] * 2.0 - 1.0) * _halves(config, device)[:, None, None]


def full_update_positions(config: OccGridConfig, generator: torch.Generator | None = None,
                          jitter: torch.Tensor | None = None, device="cpu") -> torch.Tensor:
    """(levels, R^3, 3) jittered world positions covering every cell: each
    cell's centre moved by (u - 0.5) cells, u U(0, 1) per coordinate, from
    `generator` or given as `jitter` (levels, R^3, 3) (the tests pass JAX's
    draws)."""
    centers = _cell_centers(config, device)
    cell_size = 2.0 * _halves(config, device) / config.resolution
    if jitter is None:
        jitter = torch.rand(centers.shape, generator=generator, device=device)
    return centers + (jitter.to(device) - 0.5) * cell_size[:, None, None]


def num_update_cells(config: OccGridConfig) -> int:
    return max(1, int(config.resolution**3 * config.sample_fraction))

