"""Ray containers. Port of lsenerf_tpu/cameras/rays.py."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch


@dataclass
class RayBundle:
    origins: torch.Tensor  # (n, 3)
    directions: torch.Tensor  # (n, 3) unit-norm
    pixel_area: torch.Tensor  # (n, 1)
    camera_indices: torch.Tensor  # (n, 1) int
    times: Optional[torch.Tensor] = None  # (n, 1)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def __len__(self) -> int:
        return self.origins.shape[0]

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)


@dataclass
class RaySamples:
    """Dense per-ray samples (n_rays, n_samples) with a validity mask."""

    positions: torch.Tensor  # (n, s, 3)
    directions: torch.Tensor  # (n, s, 3)
    t_starts: torch.Tensor  # (n, s)
    t_ends: torch.Tensor  # (n, s)
    mask: torch.Tensor  # (n, s) bool
