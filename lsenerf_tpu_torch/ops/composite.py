"""Volume-rendering compositing over dense masked samples.
Port of lsenerf_tpu/ops/composite.py, with its inf-safe masking and the
shifted exclusive cumsum (composite.py:45-75)."""

from __future__ import annotations

import torch

from lsenerf_tpu_torch.cameras.rays import RaySamples


def render_weights(
    samples: RaySamples, densities: torch.Tensor, alpha_thre=0.0, early_stop_eps: float = 1e-4
) -> torch.Tensor:
    """(n, k, 1) densities -> (n, k) compositing weights.

    alpha_thre is a float (0 turns culling off) or a 0-dim tensor (the
    dynamic min(alpha_thre, occs.mean()) rule)."""
    mask = samples.mask
    zero = torch.zeros((), dtype=densities.dtype, device=densities.device)
    # torch.where, not a product with the mask: a masked-out inf density
    # would give 0 * inf = NaN
    sigma = torch.where(mask, densities[..., 0], zero)
    delta = torch.where(mask, samples.t_ends - samples.t_starts, zero)
    sdt = sigma * delta
    alpha = 1.0 - torch.exp(-sdt)
    if not (isinstance(alpha_thre, (int, float)) and alpha_thre <= 0.0):
        cull = alpha <= alpha_thre
        sdt = torch.where(cull, zero, sdt)
        alpha = torch.where(cull, zero, alpha)
    # shifted cumsum, not cumsum(sdt) - sdt, which forms inf - inf = NaN
    accum = torch.cumsum(sdt, dim=-1)
    excl = torch.cat([torch.zeros_like(accum[..., :1]), accum[..., :-1]], dim=-1)
    trans = torch.exp(-excl)
    if early_stop_eps > 0.0:
        alpha = torch.where(trans > early_stop_eps, alpha, zero)
    return alpha * trans


def accumulate(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(n, k) weights x (n, k, c) values -> (n, c)."""
    return (weights[..., None] * values).sum(-2)


def render_rgb(
    weights: torch.Tensor, rgbs: torch.Tensor, bg_color: torch.Tensor | None = None,
    background: str = "linear",
) -> torch.Tensor:
    """Weighted RGB with a background blended in by the missing
    accumulation: the colours `bg_color` (n, 3) where given (the random
    background, whose colours the caller draws), else by `background`:
    "linear" (none), "black", "white" or "last_sample" (each ray's last
    sample's colour)."""
    comp = accumulate(weights, rgbs)
    if bg_color is not None:
        bg = bg_color
    elif background == "linear":
        return comp
    elif background == "black":
        bg = torch.zeros_like(comp)
    elif background == "white":
        bg = torch.ones_like(comp)
    elif background == "last_sample":
        bg = rgbs[:, -1, :]
    elif background == "random":
        raise ValueError("the random background needs its colours (bg_color)")
    else:
        raise ValueError(f"unknown background {background}")
    return comp + bg * (1.0 - weights.sum(-1, keepdim=True))


def render_depth(weights: torch.Tensor, samples: RaySamples, eps: float = 1e-10):
    """Expected depth: sum(w * t_mid) / (sum(w) + eps)."""
    t_mid = 0.5 * (samples.t_starts + samples.t_ends)
    acc = weights.sum(-1, keepdim=True)
    return (weights * t_mid).sum(-1, keepdim=True) / (acc + eps)


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return weights.sum(-1, keepdim=True)
