"""Eval image metrics: PSNR, SSIM and the optional LPIPS. Port of
lsenerf_tpu/ops/metrics.py.

SSIM filters with an 11x11 Gaussian (sigma 1.5) through F.conv2d in true
f32: cuDNN runs convolutions in TF32 on Hopper by default, whose 10-bit
mantissa breaks the E[x^2] - mu^2 cancellation the variances rest on, so
the filter runs with TF32 off whatever the caller set.
"""

from __future__ import annotations

import contextlib
import os
import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _no_tf32():
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def psnr(gt: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over the full image."""
    mse = torch.mean((gt - pred) ** 2)
    return 10.0 * torch.log10(data_range**2 / mse)


def _gaussian_kernel(kernel_size: int = 11, sigma: float = 1.5, device="cpu") -> torch.Tensor:
    coords = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0
    g = torch.exp(-(coords**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(gt: torch.Tensor, pred: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM of two (h, w, c) images in [0, data_range], each channel
    filtered alone ('valid' windows). The second moments are taken on
    mean-shifted images and clamped to what exact arithmetic guarantees
    (variances >= 0, |cov| <= sqrt(var_x var_y)), as in the JAX package."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    k = _gaussian_kernel(kernel_size, sigma, gt.device)[None, None]
    x = gt.float().permute(2, 0, 1)[:, None]
    y = pred.float().permute(2, 0, 1)[:, None]

    def filt(img):
        return F.conv2d(img, k)

    with _no_tf32():
        mu_x, mu_y = filt(x), filt(y)
        mu_x2, mu_y2, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        xc, yc = x - x.mean(), y - y.mean()
        mu_xc, mu_yc = filt(xc), filt(yc)
        sigma_x = torch.clamp(filt(xc * xc) - mu_xc * mu_xc, min=0.0)
        sigma_y = torch.clamp(filt(yc * yc) - mu_yc * mu_yc, min=0.0)
        sigma_xy = filt(xc * yc) - mu_xc * mu_yc
    cap = torch.sqrt(sigma_x * sigma_y)
    sigma_xy = torch.minimum(torch.maximum(sigma_xy, -cap), cap)
    num = (2 * mu_xy + c1) * (2 * sigma_xy + c2)
    den = (mu_x2 + mu_y2 + c1) * (sigma_x + sigma_y + c2)
    return torch.mean(num / den)


def discover_lpips_weights() -> str | None:
    """$LSENERF_LPIPS_WEIGHTS, else <repo>/assets/lpips_alex.npz, else None."""
    env = os.environ.get("LSENERF_LPIPS_WEIGHTS")
    if env and osp.exists(env):
        return env
    root = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))
    cand = osp.join(root, "assets", "lpips_alex.npz")
    return cand if osp.exists(cand) else None


class LPIPSMetric:
    """The learned perceptual metric, from AlexNet-style weights in an
    .npz (scripts/export_lpips.py's format). Without weights it is not
    `available`, and the eval leaves the key out."""

    def __init__(self, weights_path: str | None = None, device="cpu"):
        self.available = False
        self.params = None
        if weights_path is None:
            weights_path = discover_lpips_weights()
        if weights_path is not None:
            try:
                self.params = {k: torch.as_tensor(v).to(device) if v.dtype.kind == "f" else v
                               for k, v in np.load(weights_path).items()}
                self.available = True
            except (OSError, ValueError):
                self.available = False

    def __call__(self, gt, pred) -> float:
        if not self.available:
            return float("nan")
        dev = self.params["shift"].device
        return float(_lpips_forward(self.params, torch.as_tensor(gt).to(dev),
                                    torch.as_tensor(pred).to(dev)))


def _lpips_forward(params: dict, gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """AlexNet-style LPIPS distance from a flat dict of weights: conv{i}_w
    (o, i, kh, kw) with optional conv{i}_b, lin{i}_w (1, c, 1, 1), shift
    and scale (1, 3, 1, 1), optional strides/pads. Inputs (h, w, 3) in
    [0, 1], mapped to [-1, 1]. Each stage's relu output is tapped before
    the max-pool that feeds the next conv."""
    def prep(img):
        x = img.float().permute(2, 0, 1)[None] * 2.0 - 1.0
        return (x - params["shift"]) / params["scale"]

    strides = np.asarray(params.get("strides", np.array([4, 2, 1, 1, 1])))
    pads = np.asarray(params.get("pads", np.array([2, 2, 1, 1, 1])))

    def features(x):
        feats = []
        i = 0
        while f"conv{i}_w" in params:
            if i in (1, 2):
                x = F.max_pool2d(x, 3, 2)
            p = int(pads[i]) if i < len(pads) else 1
            s = int(strides[i]) if i < len(strides) else 1
            with _no_tf32():
                x = F.conv2d(x, params[f"conv{i}_w"], params.get(f"conv{i}_b"), stride=s, padding=p)
            x = F.relu(x)
            feats.append(x)
            i += 1
        return feats

    total = 0.0
    for i, (a, b) in enumerate(zip(features(prep(gt)), features(prep(pred)))):
        a = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
        b = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
        total = total + torch.mean(torch.sum((a - b) ** 2 * params[f"lin{i}_w"], dim=1))
    return total
