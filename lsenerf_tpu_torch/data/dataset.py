"""In-memory datasets for RGB frames and event frames. Port of
lsenerf_tpu/data/dataset.py for what the synthetic scene needs: masks,
gray images, explicit prev/next event cameras and lazy on-disk frames wait
for the parser."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lsenerf_tpu_torch.cameras.cameras import Cameras


@dataclass
class ColorDataset:
    images: np.ndarray  # (n, h, w, 3) float32 in [0, 1]
    cameras: Cameras
    appearance_ids: np.ndarray  # (n,) int32

    def __len__(self):
        return len(self.images)


@dataclass
class EventFrameDataset:
    """Event frames: per-pixel brightness-change counts between cameras i
    and i+1 (consecutive pairing)."""

    eimgs: np.ndarray  # (n, h, w, 1) raw counts
    cameras: Cameras
    e_thresh: float
    appearance_ids: np.ndarray

    def __len__(self):
        return len(self.eimgs)

    def get_scaled(self, idx) -> np.ndarray:
        """Event values pre-multiplied by e_thresh (delta-log units)."""
        return self.eimgs[idx].astype(np.float32) * self.e_thresh
