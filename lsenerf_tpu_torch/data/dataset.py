"""In-memory datasets for RGB frames and event frames. Port of
lsenerf_tpu/data/dataset.py: the RGB frames with an optional RGB-to-event
extrinsic dM (the event spline's), and event frames paired either by
consecutive cameras or by explicit prev/next cameras. Masks, gray images
and lazy on-disk frames wait for the parser."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from lsenerf_tpu_torch.cameras.cameras import Cameras


@dataclass
class ColorDataset:
    images: np.ndarray  # (n, h, w, 3) float32 in [0, 1]
    cameras: Cameras
    appearance_ids: np.ndarray  # (n,) int32
    dM: Optional[np.ndarray] = None  # (4, 4) rigid RGB -> event extrinsic

    def __len__(self):
        return len(self.images)


@dataclass
class EventFrameDataset:
    """Event frames: per-pixel brightness-change counts between two poses,
    cameras i and i+1 (consecutive pairing) or prev_cameras[i] and
    next_cameras[i] where those are given."""

    eimgs: np.ndarray  # (n, h, w, 1) raw counts
    cameras: Cameras
    e_thresh: float
    appearance_ids: np.ndarray
    prev_cameras: Optional[Cameras] = None
    next_cameras: Optional[Cameras] = None

    def __len__(self):
        return len(self.eimgs)

    def get_scaled(self, idx) -> np.ndarray:
        """Event values pre-multiplied by e_thresh (delta-log units)."""
        return self.eimgs[idx].astype(np.float32) * self.e_thresh
