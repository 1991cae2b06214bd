"""Analytic synthetic scene: a normal-coloured sphere, orbiting cameras and
exact delta-log-gray event frames, in memory or written to disk in the
LSENeRF-formatter layout the parser reads. Port of
lsenerf_tpu/data/synthetic.py; the same arguments give the same images,
cameras and events, and the same files."""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np
import torch

from lsenerf_tpu_torch.cameras.cameras import Cameras
from lsenerf_tpu_torch.data.dataset import ColorDataset, EventFrameDataset
from lsenerf_tpu_torch.data.imageio import write_png

EPS = 1e-6
REC601 = np.array([0.2989, 0.5870, 0.1140], np.float32)


def look_at_c2w(eye: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """OpenGL-convention camera-to-world (camera looks down -z)."""
    forward = target - eye
    forward = forward / np.linalg.norm(forward)
    up = np.asarray(up, np.float64)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = true_up
    c2w[:3, 2] = -forward
    c2w[:3, 3] = eye
    return c2w[:3, :4].astype(np.float32)


def orbit_cameras(
    n: int, radius: float = 1.5, height: float = 0.4,
    h: int = 64, w: int = 64, focal: float = 80.0,
    t_span: float = 1e6, arc: float = 1.5 * np.pi,
) -> Cameras:
    angles = np.linspace(0.0, arc, n, endpoint=False)
    c2ws = np.stack([
        look_at_c2w(np.array([radius * np.cos(a), height, radius * np.sin(a)]), np.zeros(3))
        for a in angles
    ])
    times = np.linspace(0.0, t_span, n).astype(np.float32)
    return Cameras(
        camera_to_worlds=torch.from_numpy(c2ws),
        fx=focal, fy=focal, cx=w / 2.0, cy=h / 2.0, width=w, height=h,
        times=torch.from_numpy(times),
    )


def render_sphere_image(cam_c2w: np.ndarray, cams: Cameras, sphere_r: float = 0.5,
                        texture_freq: float = 0.0):
    """Analytic render of the normal-coloured sphere (white background)."""
    h, w = cams.height, cams.width
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    dirs_cam = np.stack(
        [(xs - cams.cx) / cams.fx, -(ys - cams.cy) / cams.fy, -np.ones_like(xs, np.float64)],
        axis=-1,
    )
    R, o = cam_c2w[:3, :3], cam_c2w[:3, 3]
    d = dirs_cam @ R.T
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = 2 * d @ o
    c = o @ o - sphere_r**2
    disc = b * b - 4 * c
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)
    hit &= t > 0
    t_safe = np.where(np.isfinite(t), t, 0.0)
    p = o[None, None] + t_safe[..., None] * d
    color = 0.5 + 0.45 * (p / sphere_r)
    if texture_freq > 0.0:
        phi = np.arctan2(p[..., 2], p[..., 0])
        theta = np.arccos(np.clip(p[..., 1] / sphere_r, -1.0, 1.0))
        tex = 0.5 + 0.5 * np.sin(texture_freq * phi) * np.sin(texture_freq * theta)
        color = color * (0.35 + 0.65 * tex)[..., None]
    img = np.ones((h, w, 3), np.float32)
    img[hit] = color[hit].astype(np.float32)
    return img


def make_synthetic_scene(
    n_cams: int = 12, h: int = 48, w: int = 48, focal: float = 60.0,
    e_thresh: float = 0.2, texture_freq: float = 0.0,
):
    """Returns (ColorDataset, EventFrameDataset); event frame i is the
    delta-log-gray between cameras i and i+1, stored as counts."""
    cams = orbit_cameras(n_cams, h=h, w=w, focal=focal)
    c2ws = cams.camera_to_worlds.numpy()
    images = np.stack([
        render_sphere_image(c2ws[i], cams, texture_freq=texture_freq) for i in range(n_cams)
    ])
    log_gray = np.log(images @ REC601 + EPS)
    eimgs = (log_gray[1:] - log_gray[:-1])[..., None] / e_thresh
    col = ColorDataset(
        images=images, cameras=cams, appearance_ids=np.arange(n_cams, dtype=np.int32)
    )
    evs = EventFrameDataset(
        eimgs=eimgs.astype(np.float32),
        cameras=Cameras(
            camera_to_worlds=cams.camera_to_worlds, fx=cams.fx, fy=cams.fy,
            cx=cams.cx, cy=cams.cy, width=cams.width, height=cams.height,
            times=cams.times,
        ),
        e_thresh=e_thresh,
        appearance_ids=np.arange(n_cams - 1, dtype=np.int32),
    )
    return col, evs


def gl_c2w_to_cv_json(c2w: np.ndarray) -> tuple:
    """GL camera-to-world (3x4) -> (CV w2c orientation rows, camera
    position): the inverse of parser.cv_to_working."""
    cols = c2w[:3, :3]
    return np.stack([cols[:, 0], -cols[:, 1], -cols[:, 2]]), c2w[:3, 3]


def write_reference_scene(
    root: str, n_cams: int = 12, h: int = 64, w: int = 64, focal: float = 60.0,
    e_thresh: float = 0.2, n_val: int = 2, with_prevnext: bool = False,
    with_msk: bool = False, with_full_camera: bool = False, texture_freq: float = 0.0,
):
    """Write the synthetic sphere scene as the tree SceneParser reads:
    colcam_set/{camera, rgb/1x, dataset.json, metadata.json} and
    ecam_set/{camera, eimgs, dataset.json, scene.json, metadata.json}, with
    prev_camera/next_camera (event frame i spans cameras i and i+1),
    all-ones masks and a full_camera dir of twice as many orbit poses where
    asked. The usable ids are 0..n_cams-2 (the parser drops the last
    frame); the last n_val of them are the val split. Event counts are
    the delta-log-gray over a threshold that drops to ~half the 90th
    percentile of the moving pixels' deltas where e_thresh would zero
    99% of the events (scene.json records it). Deterministic: the same
    arguments write the same files."""
    col_ds, evs_ds = make_synthetic_scene(
        n_cams=n_cams, h=h, w=w, focal=focal, e_thresh=e_thresh, texture_freq=texture_freq,
    )
    c2ws = col_ds.cameras.camera_to_worlds.numpy()
    times = col_ds.cameras.times.numpy()

    def cam_json(c2w, t):
        ori, pos = gl_c2w_to_cv_json(c2w)
        return {
            "orientation": ori.tolist(), "position": pos.tolist(), "focal_length": focal,
            "principal_point": [w / 2.0, h / 2.0], "image_size": [w, h],
            "radial_distortion": [0.0, 0.0, 0.0], "tangential_distortion": [0.0, 0.0],
            "t": float(t),
        }

    def write_cam_dir(cam_dir, mats=None, ts=None):
        os.makedirs(cam_dir, exist_ok=True)
        mats = c2ws if mats is None else mats
        ts = times if ts is None else ts
        for i in range(len(mats)):
            with open(osp.join(cam_dir, f"{i:06d}.json"), "w") as f:
                json.dump(cam_json(mats[i], ts[i]), f, indent=1)

    col = osp.join(root, "colcam_set")
    evs = osp.join(root, "ecam_set")
    write_cam_dir(osp.join(col, "camera"))
    write_cam_dir(osp.join(evs, "camera"))
    if with_prevnext:
        write_cam_dir(osp.join(evs, "prev_camera"), c2ws[:-1], times[:-1])
        write_cam_dir(osp.join(evs, "next_camera"), c2ws[1:], times[1:])
    if with_full_camera:
        dense = orbit_cameras(2 * n_cams, h=h, w=w, focal=focal)
        write_cam_dir(osp.join(col, "full_camera"), dense.camera_to_worlds.numpy(),
                      dense.times.numpy())
    if with_msk:
        np.save(osp.join(col, "msk.npy"), np.ones((h, w), np.float32))
        np.save(osp.join(evs, "msk.npy"), np.ones((h, w), np.float32))

    os.makedirs(osp.join(col, "rgb", "1x"), exist_ok=True)
    for i in range(n_cams):
        img8 = np.clip(col_ds.images[i] * 255.0 + 0.5, 0, 255).astype(np.uint8)
        write_png(osp.join(col, "rgb", "1x", f"{i:06d}.png"), img8)

    meta = {str(i): {"appearance_id": i} for i in range(n_cams)}
    for d in (col, evs):
        with open(osp.join(d, "metadata.json"), "w") as f:
            json.dump(meta, f)
    usable = list(range(n_cams - 1))
    val_ids = usable[-n_val:]
    train_ids = usable[:-n_val] if n_val else usable
    with open(osp.join(col, "dataset.json"), "w") as f:
        json.dump({"train_ids": train_ids, "val_ids": val_ids}, f)
    with open(osp.join(evs, "dataset.json"), "w") as f:
        json.dump({"train_ids": list(range(n_cams - 1))}, f)

    os.makedirs(osp.join(evs, "eimgs"), exist_ok=True)
    raw_delta = np.asarray(evs_ds.eimgs)[..., 0] * e_thresh
    e_eff = e_thresh
    counts = np.rint(raw_delta / e_eff)
    if (counts != 0).mean() < 0.01:
        moving = np.abs(raw_delta[np.abs(raw_delta) > 1e-6])
        if moving.size:
            e_eff = float(max(np.quantile(moving, 0.9) / 2.0, 1e-6))
            counts = np.rint(raw_delta / e_eff)
    with open(osp.join(evs, "scene.json"), "w") as f:
        json.dump({"e_thresh": e_eff}, f)
    np.save(osp.join(evs, "eimgs", "eimgs_1x.npy"), counts.astype(np.int16))
    return root
