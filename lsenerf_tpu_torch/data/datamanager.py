"""Multi-camera batch assembly. Port of lsenerf_tpu/data/datamanager.py
with the numpy pixel sampler copied exactly, so one seed gives the same
batches as the JAX package, the deblur budget included; with `use_native`
the batches come from the C++ prefetcher (data/native_loader.py), the
same one the JAX package binds."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from lsenerf_tpu_torch.data.dataset import ColorDataset, EventFrameDataset, LazyFrameArray


@dataclass
class DataManagerConfig:
    train_num_rays_per_batch: int = 3512
    rgb_frac: float = 0.66
    rgb_loss_mode: str = "mse"  # mse | deblur
    eval_num_rays_per_batch: int = 1024
    use_native: bool = False  # the C++ prefetcher (native/fastloader.cpp)
    num_hosts: int = 1  # each rank samples 1/num_hosts of each budget (parallel/ddp.py)

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
        self.native = self._build_native(seed) if config.use_native else None
        # rows of the appearance table: the largest id of either stream + 1
        ids = [int(d.appearance_ids.max()) for d in (col_dataset, evs_dataset) if d is not None]
        self.num_embd = max(ids) + 1 if ids else 1

    def _build_native(self, seed: int):
        """The C++ prefetcher over this rank's budgets: the colour frames
        as uint8, the event frames as f32, or an int16 memmap and its frame
        map where the scene's events are one (only the sampled pages are
        read). Raises where the library cannot be built."""
        from lsenerf_tpu_torch.data import native_loader

        c = self.config
        n_col = c.train_num_col_rays_per_batch // c.num_hosts if self.col is not None else 0
        n_evs = c.train_num_evs_rays_per_batch // c.num_hosts if self.evs is not None else 0
        col_u8 = evs_src = evs_sel = None
        if n_col > 0:
            col_u8 = np.ascontiguousarray(np.clip(self.col.images * 255, 0, 255).astype(np.uint8))
        img_limit = 0
        if n_evs > 0:
            eimgs = self.evs.eimgs
            if isinstance(eimgs, LazyFrameArray) and eimgs.src.dtype == np.int16:
                evs_src, evs_sel = eimgs.src, eimgs.sel
            else:
                evs_src = np.ascontiguousarray(np.asarray(eimgs, dtype=np.float32))
            img_limit = len(eimgs) if self.evs.prev_cameras is not None else min(
                len(eimgs), len(self.evs.cameras) - 1)
        if col_u8 is None and evs_src is None:
            return None
        return native_loader.NativePrefetcher(
            col_u8, n_col if col_u8 is not None else 0, evs_src, n_evs if evs_src is not None else 0,
            img_limit, self.evs.e_thresh if self.evs is not None else 1.0, seed=seed,
            evs_sel=evs_sel)

    def _next_train_native(self) -> dict:
        raw = self.native.next()
        batch = {}
        if "col_indices" in raw:
            batch["col_indices"], batch["col_rgb"] = raw["col_indices"], raw["col_rgb"]
            batch["col_app_id"] = self.col.appearance_ids[raw["col_indices"][:, 0]]
        if "evs_indices" in raw:
            batch["evs_indices"], batch["evs_values"] = raw["evs_indices"], raw["evs_values"]
            batch["evs_app_id"] = self.evs.appearance_ids[raw["evs_indices"][:, 0]]
            batch["e_thresh"] = np.full((len(raw["evs_indices"]), 1), self.evs.e_thresh, np.float32)
        return batch

    def _sample_pixels(self, n: int, num_images: int, h: int, w: int):
        c = self.rng.integers(0, num_images, size=n)
        y = self.rng.integers(0, h, size=n)
        x = self.rng.integers(0, w, size=n)
        return c.astype(np.int32), y.astype(np.int32), x.astype(np.int32)

    def next_train(self, step: int) -> dict:
        """One batch of numpy arrays: col_indices (n,3) [cam,y,x], col_rgb,
        col_app_id; evs_indices, evs_values (e_thresh-scaled), evs_app_id,
        e_thresh."""
        if self.native is not None:
            return self._next_train_native()
        batch = {}
        n_col = self.config.train_num_col_rays_per_batch // self.config.num_hosts
        if n_col > 0 and self.col is not None:
            imgs = self.col.images
            c, y, x = self._sample_pixels(n_col, len(imgs), *imgs.shape[1:3])
            batch["col_indices"] = np.stack([c, y, x], axis=1)
            batch["col_rgb"] = imgs[c, y, x]
            batch["col_app_id"] = self.col.appearance_ids[c]
        n_evs = self.config.train_num_evs_rays_per_batch // self.config.num_hosts
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

    def next_train_stack(self, step: int, k: int) -> dict:
        """k batches of next_train, drawn in the same order, stacked into
        (k, ...) arrays: one chunk of Trainer.make_train_step_multi(k)."""
        batches = [self.next_train(step + i) for i in range(k)]
        return {key: np.stack([b[key] for b in batches]) for key in batches[0]}

    def next_eval_image(self, idx: int, eval_dataset: Optional[ColorDataset] = None) -> dict:
        """One view's full pixel grid [cam, y, x], its image and ids."""
        ds = eval_dataset if eval_dataset is not None else self.col
        img = ds.images[idx]
        h, w = img.shape[:2]
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        indices = np.stack([np.full(h * w, idx), ys.reshape(-1), xs.reshape(-1)], axis=1)
        return {
            "indices": indices.astype(np.int32),
            "image": img,
            "app_id": np.full((h * w,), ds.appearance_ids[idx], np.int32),
        }
