"""Training losses: RGB MSE, the event losses (log_loss, enerf_norm_loss)
and the RGB-to-one-channel reducers. Port of lsenerf_tpu/models/losses.py."""

from __future__ import annotations

import torch

from perfbench.frozen.ref import EPS
from perfbench.frozen.ref.ops.image import to_gray

EVENT_LOSSES = ("log_loss", "enerf_norm_loss")


def mse_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return ((gt - pred) ** 2).mean()


def _delta_log(prev_rad: torch.Tensor, next_rad: torch.Tensor) -> torch.Tensor:
    if prev_rad.shape[-1] != 1:
        prev_rad, next_rad = to_gray(prev_rad), to_gray(next_rad)
    return torch.log(next_rad + EPS) - torch.log(prev_rad + EPS)


def log_loss(evs: torch.Tensor, prev_rad: torch.Tensor, next_rad: torch.Tensor) -> torch.Tensor:
    """MSE between rendered delta-log radiance and the e_thresh-scaled
    event frame."""
    return mse_loss(_delta_log(prev_rad, next_rad), evs)


def enerf_norm_loss(evs: torch.Tensor, prev_rad: torch.Tensor, next_rad: torch.Tensor,
                    e_thresh: torch.Tensor, batch_sum=None) -> torch.Tensor:
    """E-NeRF-style loss: delta-log radiance and the unscaled event frame,
    each divided by its norm over the batch. Where the batch is split over
    ranks, `batch_sum` sums a per-rank tensor over them (with a gradient),
    so that the norms are the global batch's."""

    def norm(x):
        if batch_sum is None:
            return torch.linalg.norm(x, dim=0, keepdim=True)
        return torch.sqrt(batch_sum((x * x).sum(0, keepdim=True)))

    delta_log = _delta_log(prev_rad, next_rad)
    log_norm = norm(delta_log) + EPS
    evs_unscaled = (evs / e_thresh).detach()
    evs_norm = (norm(evs_unscaled) + EPS).detach()
    return mse_loss(delta_log / log_norm, evs_unscaled / evs_norm)


def init_rgb_to_one(kind, device="cpu") -> dict:
    """Params of the RGB -> one channel reducer: "learned" is a
    softmax-weighted channel mix initialised at 1/3 each (ThreeToOne);
    "gt" (Rec.601 gray) and None have none."""
    if kind == "learned":
        return {"weights": torch.full((1, 3), 1.0 / 3.0, dtype=torch.float32, device=device)}
    return {}


def apply_rgb_to_one(kind, params: dict, x: torch.Tensor) -> torch.Tensor:
    if kind == "learned":
        w = torch.softmax(params["weights"], dim=-1)
        return x @ w.T
    if kind == "gt":
        return to_gray(x)
    return x  # None: keep three channels
