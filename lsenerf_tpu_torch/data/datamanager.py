"""Multi-camera batch assembly. Port of lsenerf_tpu/data/datamanager.py
with the numpy pixel sampler copied exactly, so one seed gives the same
batches as the JAX package, the deblur budget included (the native C++
prefetcher and multi-host splits are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from lsenerf_tpu_torch.data.dataset import ColorDataset, EventFrameDataset


@dataclass
class DataManagerConfig:
    train_num_rays_per_batch: int = 3512
    rgb_frac: float = 0.66
    rgb_loss_mode: str = "mse"  # mse | deblur

    def __post_init__(self):
        """The ray budget split: events get (1-rgb_frac)/2 each for prev and
        next, RGB the rest; under deblur a quarter of the rest, since each
        RGB pixel is rendered as 4 exposure rays."""
        self.rgb_loss_mode = self.rgb_loss_mode.lower()
        self.train_num_evs_rays_per_batch = int(
            (1 - self.rgb_frac) * self.train_num_rays_per_batch * 0.5
        )
        n_col = self.train_num_rays_per_batch - self.train_num_evs_rays_per_batch * 2
        self.train_num_col_rays_per_batch = (
            int(n_col * 0.25) if self.rgb_loss_mode == "deblur" else n_col
        )


class MultiCamDataManager:
    """Samples fixed-shape pixel batches from the two sensor streams."""

    def __init__(self, config: DataManagerConfig, col_dataset: Optional[ColorDataset],
                 evs_dataset: Optional[EventFrameDataset] = None, seed: int = 0):
        self.config = config
        self.col = col_dataset
        self.evs = evs_dataset
        self.rng = np.random.default_rng(seed)
        # rows of the appearance table: the largest id of either stream + 1
        ids = [int(d.appearance_ids.max()) for d in (col_dataset, evs_dataset) if d is not None]
        self.num_embd = max(ids) + 1 if ids else 1

    def _sample_pixels(self, n: int, num_images: int, h: int, w: int):
        c = self.rng.integers(0, num_images, size=n)
        y = self.rng.integers(0, h, size=n)
        x = self.rng.integers(0, w, size=n)
        return c.astype(np.int32), y.astype(np.int32), x.astype(np.int32)

    def next_train(self, step: int) -> dict:
        """One batch of numpy arrays: col_indices (n,3) [cam,y,x], col_rgb,
        col_app_id; evs_indices, evs_values (e_thresh-scaled), evs_app_id,
        e_thresh."""
        batch = {}
        n_col = self.config.train_num_col_rays_per_batch
        if n_col > 0 and self.col is not None:
            imgs = self.col.images
            c, y, x = self._sample_pixels(n_col, len(imgs), *imgs.shape[1:3])
            batch["col_indices"] = np.stack([c, y, x], axis=1)
            batch["col_rgb"] = imgs[c, y, x]
            batch["col_app_id"] = self.col.appearance_ids[c]
        n_evs = self.config.train_num_evs_rays_per_batch
        if n_evs > 0 and self.evs is not None:
            ev = self.evs.eimgs
            # consecutive pairing needs camera i+1 to exist
            max_frame = len(ev) if self.evs.prev_cameras is not None else min(
                len(ev), len(self.evs.cameras) - 1
            )
            c, y, x = self._sample_pixels(n_evs, max_frame, *ev.shape[1:3])
            batch["evs_indices"] = np.stack([c, y, x], axis=1)
            batch["evs_values"] = self.evs.get_scaled((c, y, x))
            batch["evs_app_id"] = self.evs.appearance_ids[c]
            batch["e_thresh"] = np.full((n_evs, 1), self.evs.e_thresh, np.float32)
        return batch
