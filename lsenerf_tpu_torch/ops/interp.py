"""Nearest-timestamp index lookup. Port of find_closest_idxs from
lsenerf_tpu/ops/interp.py (the CameraIdxFixer of the event bundles); the
spline interpolation is not ported yet."""

from __future__ import annotations

import torch


def find_closest_idxs(ref: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Index of the nearest element of sorted `ref` for each `query`."""
    insert = torch.clamp(torch.searchsorted(ref, query), max=len(ref) - 1)
    d_here = (ref[insert] - query).abs()
    prev = torch.clamp(insert - 1, min=0)
    d_prev = (ref[prev] - query).abs()
    return torch.where(d_prev < d_here, prev, insert)
