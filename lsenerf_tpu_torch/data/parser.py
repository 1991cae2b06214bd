"""On-disk scene parser for the LSENeRF-formatter layout. Port of
lsenerf_tpu/data/parser.py: per-frame camera JSONs (orientation, position,
focal length, principal point, distortion, t), OpenCV world-to-camera to
OpenGL camera-to-world, metadata.json appearance ids, dataset.json splits
with the eval-mode train/val swap, scene.json e_thresh, msk.npy, the
memmapped eimgs/eimgs_1x.npy event frames, prev_camera/next_camera dirs,
and the rigid RGB-to-event extrinsic dM from rel_cam.json and colmap_scale.

Expected tree (<root> = the scene dir passed as --data):
    <root>/colcam_set/{camera/*.json, rgb/1x/*.png|jpg, dataset.json, metadata.json}
    <root>/ecam_set/{camera/*.json, eimgs/eimgs_1x.npy, dataset.json, scene.json,
                     metadata.json, prev_camera/, next_camera/}
    <root>/rel_cam.json
"""

from __future__ import annotations

import glob
import json
import os.path as osp
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from lsenerf_tpu_torch.cameras.cameras import Cameras
from lsenerf_tpu_torch.data.dataset import ColorDataset, EventFrameDataset, LazyFrameArray
from lsenerf_tpu_torch.data.imageio import read_image


def load_json(path):
    if not osp.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cv_to_working(w2c: np.ndarray) -> np.ndarray:
    """OpenCV world-to-camera (4x4) -> OpenGL camera-to-world (4x4)."""
    c2w = np.copy(w2c)
    mtx, pos = w2c[:3, :3], w2c[:3, 3]
    pos = -mtx.T @ pos
    right, up, forward = mtx
    c2w[:3, :3] = np.stack([right, -up, -forward]).T
    c2w[:3, 3] = pos
    return c2w


@dataclass
class ParserConfig:
    scale_factor: float = 1.0  # world-translation scale
    scene_scale: float = 1.0  # aabb half-extent
    use_gray: bool = False
    e_thresh: Optional[float] = None  # overrides the dataset's e_thresh
    event_type: Optional[str] = None  # another event dir (e.g. "decam_set")
    # train reads <quality>_<image_type>_colcam_set where that dir exists;
    # val always reads the "clear" quality
    quality: str = "clear"
    image_type: str = "gamma"


def _frame_files(d: str):
    return sorted(glob.glob(osp.join(d, "rgb", "1x", "*.[pj][np]g")))


class SceneParser:
    """Parses one scene directory into colour and event-frame datasets."""

    def __init__(self, root: str, config: ParserConfig = None):
        self.root = root
        self.config = config or ParserConfig()
        self.col_dir = osp.join(root, "colcam_set")
        self.evs_dir = osp.join(root, self.config.event_type or "ecam_set")

    def _get_img_dir(self, *nargs) -> str:
        prefix = "".join(f"{e}_" for e in nargs if e)
        alt = osp.join(self.root, prefix + "colcam_set")
        if prefix and osp.exists(alt):
            return alt
        if prefix and prefix != "clear_gamma_":
            print("[parser] colcam quality/image_type provided but "
                  f"{alt} does not exist, loading default colcam_set")
        return self.col_dir

    def _col_dir_for_split(self, split: str) -> str:
        quality = self.config.quality if split == "train" else "clear"
        return self._get_img_dir(quality, self.config.image_type)

    # -- cameras -------------------------------------------------------------

    def _load_cam_jsons(self, cam_dir: str, idxs=None):
        fs = sorted(glob.glob(osp.join(cam_dir, "*.json")))
        if idxs is not None:
            fs = [fs[i] for i in idxs if i < len(fs)]
        return [load_json(f) for f in fs]

    def _cam_translation(self, data_dir: str):
        t = load_json(osp.join(data_dir, "camera_transform.json"))
        return None if t is None else np.asarray(t["translation"])

    def _format_cameras(self, cam_data: list, data_dir: str):
        """Camera JSONs -> (Cameras, the OpenCV w2c matrices): translation
        scaled by scale_factor, one shared intrinsic from frame 0."""
        translation = self._cam_translation(data_dir)
        n = len(cam_data)
        mtxs = np.tile(np.eye(4)[None], (n, 1, 1)).astype(np.float32)
        ori_mtxs = np.zeros((n, 4, 4), dtype=np.float32)
        times = []
        for i, datum in enumerate(cam_data):
            mtx_ori = np.asarray(datum["orientation"])
            pos = np.asarray(datum["position"]).reshape(3, 1)
            if translation is not None:
                pos = pos + translation.reshape(3, 1)
            w2c = np.concatenate([mtx_ori, -mtx_ori @ pos], axis=1)
            w2c = np.concatenate([w2c, np.array([[0, 0, 0, 1.0]])], 0)
            ori_mtxs[i] = w2c
            mtxs[i, :3, :4] = cv_to_working(w2c)[:3, :4]
            if datum.get("t") is not None:
                times.append(float(datum["t"]))
        mtxs[:, :3, 3] *= self.config.scale_factor

        datum = cam_data[0]
        cx, cy = datum["principal_point"]
        w, h = datum["image_size"]
        k1, k2, k3 = datum["radial_distortion"]
        p1, p2 = datum["tangential_distortion"]
        distortion = np.array([k1, k2, k3, 0.0, p1, p2], np.float32)
        cams = Cameras(
            camera_to_worlds=torch.from_numpy(np.ascontiguousarray(mtxs[:, :3, :4])),
            fx=float(datum["focal_length"]), fy=float(datum["focal_length"]),
            cx=float(cx), cy=float(cy), width=int(w), height=int(h),
            distortion_params=None if np.abs(distortion).sum() == 0 else torch.from_numpy(distortion),
            times=torch.tensor(times, dtype=torch.float32) if times else None,
        )
        return cams, ori_mtxs

    def _compute_dM(self, ori_mtxs: np.ndarray, data_dir: str):
        """Rigid RGB -> event extrinsic in GL space: R_evs = R_rgb @ dM."""
        meta = load_json(osp.join(data_dir, "metadata.json"))
        if meta is None or meta.get("colmap_scale") is None:
            return None
        rel = load_json(osp.join(osp.dirname(data_dir), "rel_cam.json"))
        if rel is None:
            return None
        R = np.asarray(rel["R"])
        T = np.asarray(rel["T"]) * meta["colmap_scale"]
        dM = np.concatenate([R, T.reshape(-1, 1)], axis=1)
        dM = np.concatenate([dM, np.array([[0, 0, 0, 1.0]])], 0)
        Mes = np.stack([dM @ m for m in ori_mtxs])
        Mrgs = np.stack([cv_to_working(m) for m in ori_mtxs])
        Megs = np.stack([cv_to_working(m) for m in Mes])
        Mrgs[:, :3, 3] *= self.config.scale_factor
        Megs[:, :3, 3] *= self.config.scale_factor
        dr1 = np.linalg.inv(Mrgs[0]) @ Megs[0]
        if len(Mrgs) > 5:
            dr2 = np.linalg.inv(Mrgs[5]) @ Megs[5]
            if not (np.abs(dr1 - dr2) < 1e-5).all():
                raise ValueError("relative extrinsics inconsistent between frames 0 and 5")
        return dr1.astype(np.float32)

    def _load_metadata_ids(self, data_dir: str):
        meta = load_json(osp.join(data_dir, "metadata.json")) or {}
        ids = {}
        for k, v in meta.items():
            try:
                ids[int(k)] = v["appearance_id"]
            except (ValueError, TypeError, KeyError):
                continue
        return [ids[k] for k in sorted(ids)]

    def _load_msk(self, data_dir: str, data_idxs=None):
        f = osp.join(data_dir, "msk.npy")
        if not osp.exists(f):
            return None
        msk = np.load(f)
        if data_idxs is not None and msk.ndim == 3:
            msk = np.stack([msk[i] for i in data_idxs])
        return msk

    # -- colour --------------------------------------------------------------

    def parse_color(self, split: str = "train", is_eval: bool = False,
                    do_pretrain: bool = False) -> ColorDataset:
        """An eval run refines its cameras on half_train_ids where the scene
        has them, else on the val split; the emb_eval pretrain on train."""
        d = self._col_dir_for_split(split)
        dataset_meta = load_json(osp.join(d, "dataset.json"))
        split_map = {"train": "train_ids", "test": "val_ids", "val": "val_ids"}
        if split == "train" and is_eval and dataset_meta.get("half_train_ids"):
            id_key = "half_train_ids"
        else:
            id_key = split_map["val" if (is_eval and not do_pretrain) else split]
        img_fs = _frame_files(d)
        data_idxs = sorted(int(e) for e in dataset_meta[id_key])
        data_idxs = [i for i in data_idxs if i < len(img_fs) - 1]

        cam_data = self._load_cam_jsons(osp.join(d, "camera"))
        cams, ori_mtxs = self._format_cameras([cam_data[i] for i in data_idxs], d)
        app_ids = self._load_metadata_ids(d)
        images = np.stack([read_image(img_fs[i]).astype(np.float32) / 255.0 for i in data_idxs])
        return ColorDataset(
            images=images, cameras=cams,
            appearance_ids=np.asarray([app_ids[i] for i in data_idxs], np.int32),
            msk=self._load_msk(d, data_idxs), use_gray=self.config.use_gray,
            dM=self._compute_dM(ori_mtxs, d), data_idxs=data_idxs,
        )

    def color_train_ts(self):
        """Timestamps of the train RGB cameras (None without t)."""
        d = self.col_dir
        dataset_meta = load_json(osp.join(d, "dataset.json"))
        n_imgs = len(_frame_files(d))
        idxs = [i for i in sorted(int(e) for e in dataset_meta["train_ids"]) if i < n_imgs - 1]
        cam_data = self._load_cam_jsons(osp.join(d, "camera"))
        if cam_data[idxs[0]].get("t") is None:
            return None
        return np.asarray([cam_data[i]["t"] for i in idxs], np.float32)

    def all_color_cameras(self) -> Cameras:
        """The full trajectory the spline's knots sit on: full_camera/
        where present, else every camera JSON but the last."""
        d = self.col_dir
        full_dir = osp.join(d, "full_camera")
        if osp.exists(full_dir):
            cam_data = self._load_cam_jsons(full_dir)
        else:
            cam_data = self._load_cam_jsons(osp.join(d, "camera"))[:-1]
        return self._format_cameras(cam_data, d)[0]

    # -- events --------------------------------------------------------------

    def parse_events(self) -> EventFrameDataset:
        """The train event frames, left on disk: a batch reads only the
        pages of the pixels it samples."""
        d = self.evs_dir
        dataset_meta = load_json(osp.join(d, "dataset.json"))
        data_idxs = sorted(int(e) for e in dataset_meta["train_ids"])
        src = np.load(osp.join(d, "eimgs", "eimgs_1x.npy"), mmap_mode="r")
        eimgs = LazyFrameArray(src, data_idxs)

        prev_dir = osp.join(d, "prev_camera")
        prev_cams = next_cams = None
        if osp.exists(prev_dir):
            prev_cams, _ = self._format_cameras(self._load_cam_jsons(prev_dir, data_idxs), d)
            next_cams, _ = self._format_cameras(
                self._load_cam_jsons(osp.join(d, "next_camera"), data_idxs), d)
            cams = prev_cams
        else:
            cams, _ = self._format_cameras(self._load_cam_jsons(osp.join(d, "camera")), d)

        scene = load_json(osp.join(d, "scene.json"))
        e_thresh = 0.2
        if scene is not None and scene.get("e_thresh") is not None:
            e_thresh = scene["e_thresh"]
        if self.config.e_thresh is not None:
            e_thresh = self.config.e_thresh
        if self.config.event_type == "decam_set":
            e_thresh = 1
        app_ids = self._load_metadata_ids(d)
        return EventFrameDataset(
            eimgs=eimgs, cameras=cams, e_thresh=e_thresh,
            appearance_ids=np.asarray([app_ids[i] for i in data_idxs], np.int32),
            prev_cameras=prev_cams, next_cameras=next_cams, msk=self._load_msk(d),
        )

    def max_appearance_id(self) -> int:
        ids = [max(got) for got in map(self._load_metadata_ids, (self.col_dir, self.evs_dir)) if got]
        return max(ids) + 1 if ids else 1
