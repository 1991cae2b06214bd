"""Training losses. Port of mse_loss, log_loss and the gray RGB-to-one
reducer of lsenerf_tpu/models/losses.py."""

from __future__ import annotations

import torch

from lsenerf_tpu_torch import EPS
from lsenerf_tpu_torch.ops.image import to_gray


def mse_loss(gt: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    return ((gt - pred) ** 2).mean()


def log_loss(evs: torch.Tensor, prev_rad: torch.Tensor, next_rad: torch.Tensor) -> torch.Tensor:
    """MSE between rendered delta-log radiance and the e_thresh-scaled
    event frame."""
    if prev_rad.shape[-1] != 1:
        prev_rad, next_rad = to_gray(prev_rad), to_gray(next_rad)
    delta_log = torch.log(next_rad + EPS) - torch.log(prev_rad + EPS)
    return mse_loss(delta_log, evs)


def apply_rgb_to_one(kind, x: torch.Tensor) -> torch.Tensor:
    """RGB -> one channel before the event loss: "gt" is the fixed Rec.601
    gray (ToGrayGT); None keeps three channels. The learned reducer is not
    ported yet."""
    if kind == "gt":
        return to_gray(x)
    if kind is None:
        return x
    raise NotImplementedError(f"ev_one_dim={kind!r} is not ported")
