"""Real spherical-harmonics direction encoding (degree 4 -> 16 components).
Port of lsenerf_tpu/ops/sh.py: the same hard-coded real-SH basis."""

from __future__ import annotations

import torch


def sh_encode(directions: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """(..., 3) unit vectors -> (..., levels^2) SH basis values."""
    if not 1 <= levels <= 4:
        raise ValueError("sh_encode supports degrees 1..4")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z

    comps = [torch.full_like(x, 0.28209479177387814)]  # l0
    if levels > 1:
        comps += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if levels > 2:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)
