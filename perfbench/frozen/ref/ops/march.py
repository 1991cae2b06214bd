"""The ray march in plain PyTorch: the frozen copy of the port's
ops/march.py without its kernel (K3). `march_ts` runs `march_ts_plain`
on any device."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from perfbench.frozen.ref.cameras.rays import RayBundle, RaySamples
from perfbench.frozen.ref.ops import occupancy as occ_lib



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
    hierarchical: bool = True
    coarse_factor: int = 8
    max_coarse_segments: int = 24
    # phase-2 lookups by the packed rule (packed_segment_lookup), where
    # coarse_factor**3 is a multiple of 32; else one lookup a midpoint
    packed_phase2: bool = True
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
    return torch.where(i <= n_lin, t_lin, t_geo_start * _growth(geo_steps, cone))


def candidate_ts(t_min: torch.Tensor, config: MarchConfig) -> torch.Tensor:
    """(n,) start distances -> (n, max_candidates + 1) interval boundaries:
    ts_at_indices at every candidate index."""
    i = torch.arange(config.max_candidates + 1, dtype=torch.float32, device=t_min.device)
    return ts_at_indices(t_min, i[None, :], config)


def _growth(geo_steps: torch.Tensor, cone: float) -> torch.Tensor:
    """(1+cone)^geo_steps in f64, rounded once to f32: closer to XLA's f32
    pow than torch's."""
    base = torch.tensor(1.0 + cone, dtype=torch.float32).double()
    return torch.pow(base.to(geo_steps.device), geo_steps.double()).float()


def growth_table(cone: float, max_candidates: int, device) -> torch.Tensor:
    """(1+cone)^g for g = 0..max_candidates, (max_candidates + 1,) f32 on
    device: ts_at_indices' own expression at every geometric step a
    candidate index can take (its i - n_lin is an integer in that range),
    so t_geo_start * table[g] is its t bit for bit. K3 reads it in place
    of a pow; its wrapper builds it once a (cone, max_candidates, device)."""
    g = torch.arange(max_candidates + 1, dtype=torch.float32, device=device)
    return _growth(g, cone)


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
    occ = occ_lib._take(binaries, fine).reshape(n, k1, cf)
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


def proposal_cdf(t_starts, t_ends, mask, occ_state, o, d, config, occ_config):
    """The proposal's distribution over the (n, k) candidate intervals:
    (pdf, cdf) (n, k) and the F quantiles u (F,) it is inverted at."""
    F = config.proposal_samples
    dt = t_ends - t_starts
    mids = 0.5 * (t_starts + t_ends)
    ema = _lookup(occ_state.occs, o, d, mids, occ_config)
    tau = ema * dt / config.render_step_size
    alpha = 1.0 - torch.exp(-tau)
    w = torch.where(mask, alpha, torch.zeros_like(alpha))
    count = mask.sum(1, keepdim=True)
    uni = mask.float() / torch.clamp(count, min=1).float()
    # the sums in f64, rounded once: with lam > 0 they are exact, so they
    # do not depend on the order of the terms (K3 takes another)
    wsum = w.double().sum(1, keepdim=True).float()
    lam = config.proposal_uniform_frac
    pdf = torch.where(
        wsum > 1e-12, (1.0 - lam) * w / torch.clamp(wsum, min=1e-12) + lam * uni, uni
    )
    cdf = torch.cumsum(pdf.double(), dim=1).float()
    u = (torch.arange(F, dtype=t_starts.dtype, device=t_starts.device) + 0.5) / F
    return pdf, cdf, u


def proposal_resample(t_starts, t_ends, mask, occ_state, o, d, config, occ_config):
    """Inverse-CDF relocation of the (n, k) candidate intervals to (n, F)
    fine intervals by the occupancy EMA proposal (mass-1/F quadrature)."""
    n, k = t_starts.shape
    F = config.proposal_samples
    pdf, cdf, u = proposal_cdf(t_starts, t_ends, mask, occ_state, o, d, config, occ_config)
    dt = t_ends - t_starts
    valid = mask.sum(1, keepdim=True) > 0
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


def _phase1(o, d, t_lo, t_hi, occ_state, occ_config, config: MarchConfig):
    """Phase 1: the mc + 1 segment boundaries tc (n, mc + 1), their
    supergrid occupancy occ_b (n, mc + 1), and keep_c (n, mc): a segment
    is kept where either boundary is occupied and its first lies before
    t_hi."""
    cf = config.coarse_factor
    mc = config.max_candidates // cf
    jc = torch.arange(mc + 1, dtype=torch.float32, device=o.device)[None, :] * cf
    tc = ts_at_indices(t_lo, jc, config)
    occ_b = _lookup(occ_state.super_binaries(cf), o, d, tc, occ_config)
    keep_c = (occ_b[:, :-1] | occ_b[:, 1:]) & (tc[:, :-1] < t_hi[:, None])
    return tc, occ_b, keep_c


def _hierarchical_candidates(o, d, t_lo, t_hi, occ_state, occ_config, config: MarchConfig):
    """Phase 1 tests segments of coarse_factor candidates at both endpoints
    against the supergrid and stride-compacts the occupied ones into
    max_coarse_segments slots; phase 2 tests the fine candidates inside
    them. Returns (t0s, dts, keep), each (n, max_coarse_segments *
    coarse_factor)."""
    n, dev = o.shape[0], o.device
    cf = config.coarse_factor
    mc = config.max_candidates // cf
    k1 = config.max_coarse_segments
    keep_c = _phase1(o, d, t_lo, t_hi, occ_state, occ_config, config)[2]

    slot_c = torch.cumsum(keep_c, 1) - 1
    count_c = keep_c.sum(1)
    stride_c = torch.clamp((count_c + k1 - 1) // k1, min=1)[:, None]
    sel_c = keep_c & (slot_c % stride_c == 0)
    segidx_all = torch.arange(mc, dtype=torch.float32, device=dev).expand(n, mc)
    (segidx,) = _compact(sel_c, slot_c // stride_c, k1, [segidx_all])
    nseg = sel_c.sum(1)
    slot_ok = torch.arange(k1, device=dev)[None, :] < nseg[:, None]

    fine_i = (
        segidx[:, :, None] * cf
        + torch.arange(cf, dtype=torch.float32, device=dev)[None, None, :]
    ).reshape(n, k1 * cf)
    t0s = ts_at_indices(t_lo, fine_i, config)
    t1s = ts_at_indices(t_lo, fine_i + 1.0, config)
    # a coarse-stride drop widens every fine dt by the coarse stride
    dts_base = (t1s - t0s) * stride_c.float()
    mids = 0.5 * (t0s + t1s)
    in_range = (mids < t_hi[:, None]) & slot_ok.repeat_interleave(cf, 1)
    if config.packed_phase2 and cf**3 % 32 == 0:
        occ = packed_segment_lookup(occ_state.binaries, o, d, mids.reshape(n, k1, cf), occ_config)
    else:
        occ = _lookup(occ_state.binaries, o, d, mids, occ_config)
    return t0s, dts_base, occ & in_range


def use_hierarchical(occ_config, config: MarchConfig) -> bool:
    """Does the hierarchical march apply (else the flat one)?"""
    cf = config.coarse_factor
    return (
        config.hierarchical
        and config.max_candidates % cf == 0
        and occ_config.resolution % cf == 0
        and (occ_config.levels == 1 or (occ_config.resolution // cf) % 4 == 0)
        and config.max_candidates // cf > config.max_coarse_segments
    )


def uses_proposal(config: MarchConfig) -> bool:
    return 0 < config.proposal_samples < config.max_samples


def ray_range(o, d, nears, fars, occ_config, config: MarchConfig):
    """Each ray's (t_lo, t_hi), (n,) each: the outer aabb clipped to the
    near and far planes and to nears/fars where given."""
    outer_half = occ_config.aabb_scale * (2.0 ** (occ_config.levels - 1))
    t_enter, t_exit = ray_aabb_intersect(o, d, outer_half)
    t_lo = torch.clamp(torch.clamp(t_enter, min=config.near_plane), min=0.0)
    t_hi = torch.clamp(t_exit, max=config.far_plane)
    if nears is not None:
        t_lo = torch.maximum(t_lo, nears)
    if fars is not None:
        t_hi = torch.minimum(t_hi, fars)
    return t_lo, t_hi


@torch.no_grad()
def march_ts_plain(o, d, nears, fars, occ_state, occ_config, config: MarchConfig):
    """The selection pipeline: o, d (n, 3), nears/fars (n,) or None ->
    (t_starts, t_ends, mask), each (n, k), or (n, F) with the proposal."""
    k = config.max_samples
    dev = o.device
    t_lo, t_hi = ray_range(o, d, nears, fars, occ_config, config)
    if use_hierarchical(occ_config, config):
        t0s, dts_base, keep = _hierarchical_candidates(
            o, d, t_lo, t_hi, occ_state, occ_config, config
        )
    else:
        # flat: every candidate's midpoint against the fine grid
        i = torch.arange(config.max_candidates + 1, dtype=torch.float32, device=dev)[None, :]
        ts = ts_at_indices(t_lo, i, config)
        t0s, t1s = ts[:, :-1], ts[:, 1:]
        dts_base = t1s - t0s
        mids = 0.5 * (t0s + t1s)
        keep = _lookup(occ_state.binaries, o, d, mids, occ_config) & (mids < t_hi[:, None])

    # stride compaction: every stride-th survivor, dt widened by the stride
    slot = torch.cumsum(keep, 1) - 1
    count_all = keep.sum(1)
    stride = torch.clamp((count_all + k - 1) // k, min=1)[:, None]
    sel = keep & (slot % stride == 0)
    dts = dts_base * stride.float()
    t_starts, t_ends = _compact(sel, slot // stride, k, [t0s, t0s + dts])
    mask = torch.arange(k, device=dev)[None, :] < sel.sum(1)[:, None]

    if uses_proposal(config):
        t_starts, t_ends, mask = proposal_resample(
            t_starts, t_ends, mask, occ_state, o, d, config, occ_config
        )
    return t_starts, t_ends, mask


def march_ts(o, d, nears, fars, occ_state, occ_config, config: MarchConfig):
    return march_ts_plain(o, d, nears, fars, occ_state, occ_config, config)


def march_rays(bundle: RayBundle, occ_state, occ_config, config: MarchConfig) -> RaySamples:
    """Dense masked samples along each ray, skipping empty space."""

    def column(t):
        return None if t is None else t[:, 0].contiguous()

    # no detach: K3 reads the tensors in place, and the plain version runs
    # without autograd
    t_starts, t_ends, mask = march_ts(
        bundle.origins.contiguous(), bundle.directions.contiguous(),
        column(bundle.nears), column(bundle.fars), occ_state, occ_config, config)
    t_mid = 0.5 * (t_starts + t_ends)
    positions = bundle.origins[:, None, :] + t_mid[..., None] * bundle.directions[:, None, :]
    dirs = bundle.directions[:, None, :].expand(positions.shape)
    return RaySamples(
        positions=positions, directions=dirs, t_starts=t_starts, t_ends=t_ends, mask=mask
    )
