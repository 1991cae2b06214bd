"""Datasets for RGB frames and event frames. Port of
lsenerf_tpu/data/dataset.py: the RGB frames with an optional mask, gray
conversion and RGB-to-event extrinsic dM (the event spline's), and event
frames paired either by consecutive cameras or by explicit prev/next
cameras, kept on disk through LazyFrameArray when the parser reads them."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from lsenerf_tpu_torch.cameras.cameras import Cameras
from lsenerf_tpu_torch.ops.image import REC601


@dataclass
class ColorDataset:
    images: np.ndarray  # (n, h, w, 3) float32 in [0, 1]
    cameras: Cameras
    appearance_ids: np.ndarray  # (n,) int32
    msk: Optional[np.ndarray] = None  # (n, h, w) or (h, w)
    use_gray: bool = False
    dM: Optional[np.ndarray] = None  # (4, 4) rigid RGB -> event extrinsic
    data_idxs: Optional[list] = None  # the frame indices the parser selected

    def __post_init__(self):
        if self.use_gray and self.images.shape[-1] == 3:
            g = self.images @ np.array(REC601, np.float32)
            self.images = np.repeat(g[..., None], 3, axis=-1)

    def __len__(self):
        return len(self.images)


class LazyFrameArray:
    """A frame-subset view over an on-disk .npy (np.memmap) that never
    reads the whole stack: a batch gather eimgs[(c, y, x)] maps the frame
    index through `sel` and reads only the touched pages. A trailing
    channel axis is added at access, so callers see (n, h, w, 1)."""

    def __init__(self, src: np.ndarray, sel):
        self.src = src
        self.sel = np.asarray(sel, np.int64)
        self.shape = (len(self.sel), *src.shape[1:3], 1)
        self.dtype = src.dtype

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx):
        if isinstance(idx, tuple):
            c, *rest = idx
            return self.src[(self.sel[c], *rest)][..., None]
        if isinstance(idx, slice):
            return LazyFrameArray(self.src, self.sel[idx])
        return self.src[self.sel[idx]][..., None]

    def __array__(self, dtype=None, copy=None):
        out = np.asarray(self.src[self.sel])[..., None]
        return out if dtype is None else out.astype(dtype)


@dataclass
class EventFrameDataset:
    """Event frames: per-pixel brightness-change counts between two poses,
    cameras i and i+1 (consecutive pairing) or prev_cameras[i] and
    next_cameras[i] where those are given."""

    eimgs: np.ndarray  # (n, h, w, 1) raw counts, or a LazyFrameArray
    cameras: Cameras
    e_thresh: float
    appearance_ids: np.ndarray
    prev_cameras: Optional[Cameras] = None
    next_cameras: Optional[Cameras] = None
    msk: Optional[np.ndarray] = None

    def __post_init__(self):
        if len(self.eimgs) > 1000:  # drop the last frames of long recordings
            self.eimgs = self.eimgs[:-8]
        if self.e_thresh == 1 and self.msk is not None:
            # normalised (EVIMO-style) frames: reads a lazy view whole
            self.eimgs = np.clip(np.asarray(self.eimgs) / 255.0, 0, 1)

    def __len__(self):
        return len(self.eimgs)

    def get_scaled(self, idx) -> np.ndarray:
        """Event values pre-multiplied by e_thresh (delta-log units)."""
        return self.eimgs[idx].astype(np.float32) * self.e_thresh
