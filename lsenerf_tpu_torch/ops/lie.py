"""Differentiable Lie-group math on batched tensors. Port of the part of
lsenerf_tpu/ops/lie.py the `ns` camera optimizer needs. Tangent
convention: 6-vector = [translation(3), so3 log-rotation(3)]."""

from __future__ import annotations

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
