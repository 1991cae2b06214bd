"""Differentiable Lie-group and rotation math on batched tensors. Port of
lsenerf_tpu/ops/lie.py: the SO3xR3 and SE3 exponential maps, the host-side
log map that builds spline knots, and the quaternion maps of the spline.
Tangent convention: 6-vector = [translation(3), so3 log-rotation(3)]."""

from __future__ import annotations

import numpy as np
import torch


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched f32 matmul for geometry (full f32 on CPU and, with TF32
    off, on the card)."""
    return torch.matmul(a, b)


def skew(w: torch.Tensor) -> torch.Tensor:
    """Batched skew-symmetric matrices from (..., 3) vectors."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def exp_map_SO3xR3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [t, log_rot] -> (..., 3, 4) [R | t], with the reference's
    angle clamp (squared norm >= 1e-4 before the sqrt)."""
    t = tangent[..., :3]
    log_rot = tangent[..., 3:]
    nrms = (log_rot * log_rot).sum(-1)
    rot_angles = torch.sqrt(torch.clamp(nrms, min=1e-4))
    inv = 1.0 / rot_angles
    fac1 = inv * torch.sin(rot_angles)
    fac2 = inv * inv * (1.0 - torch.cos(rot_angles))
    s = skew(log_rot)
    s2 = mm(s, s)
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(s.shape)
    R = fac1[..., None, None] * s + fac2[..., None, None] * s2 + eye
    return torch.cat([R, t[..., None]], dim=-1)


def exp_map_SE3(tangent: torch.Tensor) -> torch.Tensor:
    """(..., 6) [rho, log_rot] -> (..., 3, 4) [R | V rho], with the series
    limits below a squared angle of 1e-8."""
    rho = tangent[..., :3]
    log_rot = tangent[..., 3:]
    nrms = (log_rot * log_rot).sum(-1)
    theta = torch.sqrt(torch.clamp(nrms, min=1e-10))
    s = skew(log_rot)
    s2 = mm(s, s)
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(s.shape)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    small = nrms < 1e-8
    fac1 = torch.where(small, 1.0 - nrms / 6.0, sin_t / theta)
    fac2 = torch.where(small, 0.5 - nrms / 24.0, (1.0 - cos_t) / (theta * theta))
    fac3 = torch.where(small, 1.0 / 6.0 - nrms / 120.0, (theta - sin_t) / theta**3)
    R = fac1[..., None, None] * s + fac2[..., None, None] * s2 + eye
    V = eye + fac2[..., None, None] * s + fac3[..., None, None] * s2
    t = mm(V, rho[..., None])[..., 0]
    return torch.cat([R, t[..., None]], dim=-1)


def matrix_to_tangent_vector(matrix) -> np.ndarray:
    """(..., 4, 4) or (..., 3, 4) transforms -> (..., 6) [t, so3], float32.

    Host-side float64 numpy, used only at init to build spline knots: near
    180 degrees float32 loses several digits of the axis. Not
    differentiable; the learnable path is the forward exp map."""
    m = np.asarray(matrix, dtype=np.float64)
    t = m[..., :3, 3]
    R = m[..., :3, :3]
    trace = np.trace(R, axis1=-2, axis2=-1)
    cos_angle = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    angle = np.arccos(cos_angle)
    axis_raw = np.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]],
        axis=-1,
    )
    sin_angle = np.sin(angle)
    small = np.abs(sin_angle) < 1e-8
    near_pi = small & (cos_angle < 0)
    denom = np.where(small, 1.0, 2.0 * sin_angle)
    axis = axis_raw / denom[..., None]
    # angle ~ 0: any axis will do (+z, as the reference)
    axis = np.where((small & ~near_pi)[..., None], np.array([0.0, 0.0, 1.0]), axis)
    # angle ~ pi: the axis from the symmetric part, R = 2 n n^T - I, with
    # the signs fixed from the off-diagonals around the largest component
    if np.any(near_pi):
        diag = np.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], axis=-1)
        n = np.sqrt(np.clip((diag + 1.0) / 2.0, 0.0, None))
        k = np.argmax(n, axis=-1)
        for idx in np.argwhere(near_pi):
            i = tuple(idx)
            kk = k[i]
            nn = n[i].copy()
            for j in (j for j in range(3) if j != kk):
                s = R[i][kk, j] + R[i][j, kk]
                nn[j] = np.sign(s) * abs(nn[j]) if abs(s) > 1e-12 else nn[j]
            axis[i] = nn / np.linalg.norm(nn)
    so3 = axis * angle[..., None]
    return np.concatenate([t, so3], axis=-1).astype(np.float32)


def exp_map_to_quat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) so(3) log-rotation -> (..., 4) quaternion [w, x, y, z];
    a zero rotation maps to the identity. At exactly zero the gradient is
    finite (torch's norm has gradient 0 there), where the JAX package's is
    NaN."""
    thetas = torch.linalg.norm(v, dim=-1)
    valid = thetas > 0
    safe_thetas = torch.where(valid, thetas, torch.ones_like(thetas))
    n = v / safe_thetas[..., None]
    w = torch.cos(thetas / 2.0)
    sin_half = torch.sin(thetas / 2.0)
    xyz = torch.where(valid[..., None], n * sin_half[..., None], torch.zeros_like(v))
    return torch.cat([w[..., None], xyz], dim=-1)


def quat_to_rot_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) [w, x, y, z] -> (..., 3, 3), without renormalising."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    x2, y2, z2 = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    row0 = torch.stack([1.0 - 2.0 * (y2 + z2), 2.0 * (xy - wz), 2.0 * (xz + wy)], dim=-1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (x2 + z2), 2.0 * (yz - wx)], dim=-1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (x2 + y2)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def exp_map_to_quat_map(exp_map: torch.Tensor) -> torch.Tensor:
    """(..., 6) [t, so3] -> (..., 7) [t, quat(wxyz)]."""
    return torch.cat([exp_map[..., :3], exp_map_to_quat(exp_map[..., 3:])], dim=-1)


def quat_map_to_mtx(quat_map: torch.Tensor) -> torch.Tensor:
    """(..., 7) [t, quat] -> (..., 3, 4) [R | t]."""
    rot = quat_to_rot_mat(quat_map[..., 3:])
    return torch.cat([rot, quat_map[..., :3, None]], dim=-1)


def multiply_poses(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (..., 3, 4) poses: a @ [b; 0 0 0 1]."""
    R = mm(a[..., :3, :3], b[..., :3, :3])
    t = mm(a[..., :3, :3], b[..., :3, 3:]) + a[..., :3, 3:]
    return torch.cat([R, t], dim=-1)


def to_homogeneous(pose: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with bottom row [0, 0, 0, 1]."""
    bottom = torch.zeros_like(pose[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([pose, bottom], dim=-2)
