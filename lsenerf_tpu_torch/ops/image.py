"""Image helpers. Port of to_gray from lsenerf_tpu/ops/image.py."""

from __future__ import annotations

import torch

REC601 = (0.2989, 0.5870, 0.1140)  # Rec.601 luma weights


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1) Rec.601 grayscale; other widths pass through."""
    if img.shape[-1] != 3:
        return img
    w = torch.tensor(REC601, dtype=img.dtype, device=img.device).reshape(3, 1)
    return img @ w
