"""Image helpers for the losses, the eval and its artifacts. Port of
lsenerf_tpu/ops/image.py: to_gray, lin_log, the log-domain affine
rescale of an events-only prediction, the linear colour correction and
the signed error map."""

from __future__ import annotations

import functools
import math

import torch

from perfbench.frozen.ref import EPS

REC601 = (0.2989, 0.5870, 0.1140)  # Rec.601 luma weights


@functools.lru_cache(maxsize=None)
def _rec601(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The (3, 1) weights, made once a dtype and device: a copy from the
    host inside a captured CUDA graph would fail."""
    return torch.tensor(REC601, dtype=dtype, device=device).reshape(3, 1)


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 1) Rec.601 grayscale; other widths pass through."""
    if img.shape[-1] != 3:
        return img
    return img @ _rec601(img.dtype, img.device)


def lin_log(x: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """Linear below `threshold`, logarithmic above (0-255 input), in f32."""
    x = x.float()
    f = (1.0 / threshold) * math.log(threshold)
    return torch.where(x <= threshold, x * f, torch.log(x))


def solve_normal_equations(pred_log: torch.Tensor, gt_log: torch.Tensor):
    """Least-squares a, b of gt_log ~ a * pred_log + b by the normal
    equations; a NaN coefficient becomes 5/255."""
    n = pred_log.numel()
    x = torch.ones((n, 2), dtype=pred_log.dtype, device=pred_log.device)
    x[:, 1] = pred_log.reshape(-1)
    beta = torch.linalg.inv(x.T @ x) @ x.T @ gt_log.reshape(-1)
    a, b = beta[1], beta[0]
    fallback = torch.tensor(5.0 / 255.0, dtype=pred_log.dtype, device=pred_log.device)
    return torch.where(torch.isnan(a), fallback, a), torch.where(torch.isnan(b), fallback, b)


def correct_img_scale(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """The prediction rescaled onto the GT's brightness in the log domain
    (an events-only run cannot see absolute intensity)."""
    gt_log, pred_log = torch.log(gt + EPS), torch.log(pred + EPS)
    a, b = solve_normal_equations(pred_log, gt_log)
    return torch.exp(a * pred_log + b)


def linear_correction(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Per-channel affine least-squares colour correction, clipped to [0, 1]."""
    pred_f = pred.reshape(-1, 3)
    x = torch.cat([pred_f, torch.ones((len(pred_f), 1), dtype=pred.dtype, device=pred.device)], 1)
    params = torch.linalg.solve(x.T @ x, x.T @ gt.reshape(-1, 3))
    return torch.clamp((x @ params).reshape(pred.shape), 0, 1)


def make_error_map(rgb: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """Signed grayscale error on white, scaled by 6: where the GT is
    brighter green and blue dim (red), where darker red and green dim."""
    err = (to_gray(rgb)[..., 0] - to_gray(pred)[..., 0]) * 6.0
    pos, neg = err > 0, err < 0
    one = torch.ones_like(err)
    g = torch.where(pos, 1 - err, torch.where(neg, 1 - torch.abs(err), one))
    b = torch.where(pos, 1 - err, one)
    r = torch.where(neg, 1 - torch.abs(err), one)
    return torch.stack([r, g, b], dim=-1)
