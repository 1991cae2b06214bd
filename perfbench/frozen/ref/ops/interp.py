"""Continuous-time pose interpolation (the camera spline's core) and
nearest-timestamp lookups. Port of lsenerf_tpu/ops/interp.py: batched
slerp, searchsorted + lerp/slerp along the knots, and the index lookups of
the event bundles."""

from __future__ import annotations

import torch

from perfbench.frozen.ref import EPS
from perfbench.frozen.ref.ops import lie


def slerp(v0: torch.Tensor, v1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Batched quaternion slerp: (n, 4), (n, 4), (n, 1) -> (n, 4).

    The dot product is clamped to (-1+EPS, 1-EPS), the shorter path is
    taken, and rotations with |dot| > 0.9995 are lerped."""
    v0n = v0 / torch.linalg.norm(v0, dim=1, keepdim=True)
    v1n = v1 / torch.linalg.norm(v1, dim=1, keepdim=True)

    dot = torch.clamp((v0n * v1n).sum(1, keepdim=True), -1.0 + EPS, 1.0 - EPS)
    dot_neg = dot < 0
    v1n = torch.where(dot_neg, -v1n, v1n)
    dot = torch.where(dot_neg, -dot, dot)
    dot_mag = dot.abs()

    is_near_zero = torch.isnan(dot_mag) | (dot_mag > 0.9995)
    linear_rot = (1 - t) * v0n + t * v1n

    theta_0 = torch.arccos(dot)
    theta_t = theta_0 * t
    sin_theta_t = torch.sin(theta_t)
    sin_theta_0 = torch.sin(theta_0)
    sin_theta_0 = torch.where(sin_theta_0 == 0, torch.ones_like(sin_theta_0), sin_theta_0)
    s0 = torch.sin(theta_0 - theta_t) / sin_theta_0
    s1 = sin_theta_t / sin_theta_0
    slerp_rot = s0 * v0n + s1 * v1n

    return torch.where(is_near_zero.expand_as(slerp_rot), linear_rot, slerp_rot)


def interpolate_pose_map(control_poses: torch.Tensor, control_ts: torch.Tensor,
                         interp_ts: torch.Tensor) -> torch.Tensor:
    """Lerp (translation) + slerp (rotation) along (m, 7) [t, quat] knots at
    strictly increasing (m,) times, for (k,) query times -> (k, 7). Times
    stay f32, as in the JAX package: searchsorted and the fraction are
    taken on f32 knot times."""
    control_poses = control_poses.float()
    control_ts = control_ts.float()
    interp_ts = interp_ts.float()

    indices = torch.searchsorted(control_ts, interp_ts, right=True)
    indices = torch.clamp(indices, 1, len(control_ts) - 1) - 1

    start = control_poses[indices]
    end = control_poses[indices + 1]
    start_ts = control_ts[indices]
    end_ts = control_ts[indices + 1]
    t = ((interp_ts - start_ts) / (end_ts - start_ts))[..., None]

    trans = (1 - t) * start[:, :3] + t * end[:, :3]
    rot = slerp(start[:, 3:], end[:, 3:], t)
    return torch.cat([trans, rot], dim=1)


def interpolate_c2w(ctrl_tangents: torch.Tensor, ctrl_ts: torch.Tensor,
                    query_ts: torch.Tensor) -> torch.Tensor:
    """(m, 6) knot tangents -> (k, 3, 4) camera matrices at the query
    times, which are clipped to the knot range first."""
    ts = torch.clamp(query_ts.reshape(-1), ctrl_ts[0], ctrl_ts[-1])
    ctrl_quats = lie.exp_map_to_quat_map(ctrl_tangents)
    return lie.quat_map_to_mtx(interpolate_pose_map(ctrl_quats, ctrl_ts, ts))


def find_closest_idxs(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Index of the nearest element of sorted `ref` for each `query`."""
    insert = torch.clamp(torch.searchsorted(ref, query), max=len(ref) - 1)
    d_here = (ref[insert] - query).abs()
    prev = torch.clamp(insert - 1, min=0)
    d_prev = (ref[prev] - query).abs()
    return torch.where(d_prev < d_here, prev, insert)


def find_closest_idxs_exclusive(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Like find_closest_idxs, but never the element equal to the query."""
    n = len(ref)
    insert = torch.clamp(torch.searchsorted(ref, query), max=n - 1)
    d_here = (ref[insert] - query).abs()
    prev = torch.clamp(insert - 1, min=0)
    d_prev = (ref[prev] - query).abs()
    nxt = torch.clamp(insert + 1, max=n - 1)
    d_next = (ref[nxt] - query).abs()

    d_here = torch.where(ref[insert] == query, torch.full_like(d_here, float("inf")), d_here)

    mask_prev = (d_prev <= d_here) & (d_prev <= d_next)
    mask_next = (d_next < d_here) & (d_next < d_prev)
    out = torch.where(mask_prev, prev, insert)
    return torch.where(mask_next, nxt, out)
