"""Static-shape occupancy-skipping ray marching. Port of
lsenerf_tpu/ops/march.py: the hierarchical two-phase march with the
supergrid lookup, the packed-phase-2 rule, stride compaction into
`max_samples` slots, and proposal resampling.

The TPU compacts with one-hot matmuls; the port scatters into the slots,
which gives the same values. Everything here is non-differentiable: only
the sample positions, rebuilt from the differentiable origins and
directions, carry gradients.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lsenerf_tpu_torch.cameras.rays import RayBundle, RaySamples
from lsenerf_tpu_torch.ops import occupancy as occ_lib


@dataclass(frozen=True)
class MarchConfig:
    render_step_size: float
    near_plane: float = 0.05
    far_plane: float = 1e3
    cone_angle: float = 0.004
    alpha_thre: float = 0.01
    early_stop_eps: float = 1e-4
    max_samples: int = 48
    max_candidates: int = 512
    coarse_factor: int = 8
    max_coarse_segments: int = 24
    proposal_samples: int = 0
    proposal_uniform_frac: float = 0.2


def ray_aabb_intersect(origins, directions, aabb_half: float):
    """Slab test against [-h, h]^3 -> (t_min, t_max); t_min > t_max on a miss."""
    inv = torch.reciprocal(
        torch.where(directions.abs() < 1e-10, torch.full_like(directions, 1e-10), directions)
    )
    t0 = (-aabb_half - origins) * inv
    t1 = (aabb_half - origins) * inv
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_near, t_far


def ts_at_indices(t_min: torch.Tensor, i: torch.Tensor, config: MarchConfig):
    """Boundary t of candidate index i: the closed form of
    t_{i+1} = t_i + max(step, cone * t_i). t_min (n,), i (n, m) or (1, m)."""
    step = config.render_step_size
    cone = config.cone_angle
    t_min = t_min.reshape(t_min.shape + (1,) * (i.ndim - 1))
    if cone <= 0.0:
        return t_min + i * step
    t_crit = step / cone
    n_lin = torch.ceil(torch.clamp(t_crit - t_min, min=0.0) / step)
    t_lin = t_min + torch.minimum(i, n_lin) * step
    t_geo_start = t_min + n_lin * step
    geo_steps = torch.clamp(i - n_lin, min=0.0)
    # (1+cone)^k in f64, rounded once: closer to XLA's f32 pow than torch's
    base = torch.tensor(1.0 + cone, dtype=torch.float32).double()
    growth = torch.pow(base.to(geo_steps.device), geo_steps.double()).float()
    return torch.where(i <= n_lin, t_lin, t_geo_start * growth)


def _lookup(grid, o, d, mids, occ_config):
    return occ_lib._grid_lookup(
        grid,
        o[:, None, 0] + mids * d[:, None, 0],
        o[:, None, 1] + mids * d[:, None, 1],
        o[:, None, 2] + mids * d[:, None, 2],
        occ_config,
    )


def packed_segment_lookup(binaries, o, d, mids, occ_config):
    """Phase-2 occupancy of segment midpoints with the packed-lookup rule.

    mids: (n, k1, cf). A midpoint in the supercell of its segment's first
    or last midpoint reads its fine cell; one in a third supercell reads
    occupied (conservative: it may add a candidate, never drop one)."""
    n, k1, cf = mids.shape
    R = binaries.shape[-1]
    S = R // cf
    flat = mids.reshape(n, k1 * cf)
    lvl, ix, iy, iz = occ_lib._cell_coords(
        o[:, None, 0] + flat * d[:, None, 0],
        o[:, None, 1] + flat * d[:, None, 1],
        o[:, None, 2] + flat * d[:, None, 2],
        R, occ_config,
    )
    sup = (((lvl * S + ix // cf) * S + iy // cf) * S + iz // cf).reshape(n, k1, cf)
    fine = ((lvl * R + ix) * R + iy) * R + iz
    occ = binaries.reshape(-1)[fine.reshape(-1)].reshape(n, k1, cf)
    in_ends = (sup == sup[..., :1]) | (sup == sup[..., -1:])
    return torch.where(in_ends, occ, torch.ones_like(occ)).reshape(n, k1 * cf)


def _compact(sel, out_slot, k, values):
    """Write values[:, j] of selected candidates into slot out_slot[:, j]
    of (n, k) outputs; empty slots are 0."""
    n = sel.shape[0]
    idx = torch.where(sel, out_slot, torch.full_like(out_slot, k))
    outs = []
    for v in values:
        buf = torch.zeros((n, k + 1), dtype=v.dtype, device=v.device)
        buf.scatter_(1, idx, v)
        outs.append(buf[:, :k])
    return outs


def proposal_resample(t_starts, t_ends, mask, occ_state, o, d, config, occ_config):
    """Inverse-CDF relocation of the (n, k) candidate intervals to (n, F)
    fine intervals by the occupancy EMA proposal (mass-1/F quadrature)."""
    n, k = t_starts.shape
    F = config.proposal_samples
    dt = t_ends - t_starts
    mids = 0.5 * (t_starts + t_ends)
    ema = _lookup(occ_state.occs, o, d, mids, occ_config)
    tau = ema * dt / config.render_step_size
    alpha = 1.0 - torch.exp(-tau)
    w = torch.where(mask, alpha, torch.zeros_like(alpha))
    count = mask.sum(1, keepdim=True)
    valid = count > 0
    uni = mask.float() / torch.clamp(count, min=1).float()
    wsum = w.sum(1, keepdim=True)
    lam = config.proposal_uniform_frac
    pdf = torch.where(
        wsum > 1e-12, (1.0 - lam) * w / torch.clamp(wsum, min=1e-12) + lam * uni, uni
    )
    cdf = torch.cumsum(pdf, dim=1)
    u = (torch.arange(F, dtype=t_starts.dtype, device=t_starts.device) + 0.5) / F
    idx = (u[None, :, None] > cdf[:, None, :]).sum(-1)  # (n, F)
    idx = torch.clamp(idx, max=k - 1)

    def take(a):
        return torch.gather(a, 1, idx)

    t0_s, dt_s, pdf_s = take(t_starts), take(dt), take(pdf)
    cdf_prev = torch.cat([torch.zeros_like(cdf[:, :1]), cdf[:, :-1]], dim=1)
    frac = torch.clamp((u[None, :] - take(cdf_prev)) / torch.clamp(pdf_s, min=1e-12), 0.0, 1.0)
    t_c = t0_s + frac * dt_s
    dt_f = dt_s / torch.clamp(pdf_s * F, min=1e-12)
    mask_f = valid.expand(n, F)
    dt_f = torch.where(mask_f, dt_f, torch.zeros_like(dt_f))
    return t_c - 0.5 * dt_f, t_c + 0.5 * dt_f, mask_f


@torch.no_grad()
def _march_ts(bundle: RayBundle, occ_state, occ_config, config: MarchConfig):
    """The selection pipeline: (t_starts, t_ends, mask), each (n, k)."""
    n = len(bundle)
    k = config.max_samples
    o = bundle.origins.detach()
    d = bundle.directions.detach()
    dev = o.device

    outer_half = occ_config.aabb_scale * (2.0 ** (occ_config.levels - 1))
    t_enter, t_exit = ray_aabb_intersect(o, d, outer_half)
    t_lo = torch.clamp(torch.clamp(t_enter, min=config.near_plane), min=0.0)
    t_hi = torch.clamp(t_exit, max=config.far_plane)

    cf = config.coarse_factor
    if not (
        config.max_candidates % cf == 0
        and occ_config.resolution % cf == 0
        and (occ_config.levels == 1 or (occ_config.resolution // cf) % 4 == 0)
        and config.max_candidates // cf > config.max_coarse_segments
        and cf**3 % 32 == 0
    ):
        raise NotImplementedError(
            "the march is ported for configurations that take the JAX "
            "package's hierarchical branch with its bit-packed phase 2; the "
            "flat march is not ported"
        )
    mc = config.max_candidates // cf
    k1 = config.max_coarse_segments
    # phase 1: segments against the supergrid, tested at both endpoints
    jc = torch.arange(mc + 1, dtype=torch.float32, device=dev)[None, :] * cf
    tc = ts_at_indices(t_lo, jc, config)
    super_bin = occ_lib.build_super_binaries(occ_state.binaries, cf)
    occ_b = _lookup(super_bin, o, d, tc, occ_config)
    keep_c = (occ_b[:, :-1] | occ_b[:, 1:]) & (tc[:, :-1] < t_hi[:, None])

    slot_c = torch.cumsum(keep_c, 1) - 1
    count_c = keep_c.sum(1)
    stride_c = torch.clamp((count_c + k1 - 1) // k1, min=1)[:, None]
    sel_c = keep_c & (slot_c % stride_c == 0)
    segidx_all = torch.arange(mc, dtype=torch.float32, device=dev).expand(n, mc)
    (segidx,) = _compact(sel_c, slot_c // stride_c, k1, [segidx_all])
    nseg = sel_c.sum(1)
    slot_ok = torch.arange(k1, device=dev)[None, :] < nseg[:, None]

    # phase 2: fine candidates inside the selected segments
    fine_i = (
        segidx[:, :, None] * cf
        + torch.arange(cf, dtype=torch.float32, device=dev)[None, None, :]
    ).reshape(n, k1 * cf)
    t0s = ts_at_indices(t_lo, fine_i, config)
    t1s = ts_at_indices(t_lo, fine_i + 1.0, config)
    dts_base = (t1s - t0s) * stride_c.float()
    mids = 0.5 * (t0s + t1s)
    in_range = (mids < t_hi[:, None]) & slot_ok.repeat_interleave(cf, 1)
    keep = packed_segment_lookup(
        occ_state.binaries, o, d, mids.reshape(n, k1, cf), occ_config
    ) & in_range

    # stride compaction: every stride-th survivor, dt widened by the stride
    slot = torch.cumsum(keep, 1) - 1
    count_all = keep.sum(1)
    stride = torch.clamp((count_all + k - 1) // k, min=1)[:, None]
    sel = keep & (slot % stride == 0)
    dts = dts_base * stride.float()
    t_starts, t_ends = _compact(sel, slot // stride, k, [t0s, t0s + dts])
    mask = torch.arange(k, device=dev)[None, :] < sel.sum(1)[:, None]

    if 0 < config.proposal_samples < k:
        t_starts, t_ends, mask = proposal_resample(
            t_starts, t_ends, mask, occ_state, o, d, config, occ_config
        )
    return t_starts, t_ends, mask


def march_rays(bundle: RayBundle, occ_state, occ_config, config: MarchConfig) -> RaySamples:
    """Dense masked samples along each ray, skipping empty space."""
    t_starts, t_ends, mask = _march_ts(bundle, occ_state, occ_config, config)
    t_mid = 0.5 * (t_starts + t_ends)
    positions = bundle.origins[:, None, :] + t_mid[..., None] * bundle.directions[:, None, :]
    dirs = bundle.directions[:, None, :].expand(positions.shape)
    return RaySamples(
        positions=positions, directions=dirs, t_starts=t_starts, t_ends=t_ends, mask=mask
    )
