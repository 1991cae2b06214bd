"""Eval artifacts and train scalars. Port of lsenerf_tpu/engine/writer.py:
eval_results/<key>/NNN.png for each output image, comb_imgs/NNN.png side
by side, eval_metrics.json (per view) and eval_mean.json, the git hash,
and a scalar log (metrics.jsonl, plus TensorBoard where
torch.utils.tensorboard imports).

The JAX package plots each mapper's response curve with matplotlib. The
port writes the sampled curve as numbers instead,
<which>_mappers/mapper_<which>_NNN.json: the x grid and, for each output
channel, y (and the gt curve x^(1/2.4) where the plot draws it).
"""

from __future__ import annotations

import json
import os
import os.path as osp
import subprocess

import numpy as np
import torch

from lsenerf_tpu_torch.data.imageio import write_png


def get_git_hash() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                              text=True).stdout.strip() or "unknown"
    except OSError:
        return "unknown"


def write_git_hash_txt(log_dir: str):
    os.makedirs(log_dir, exist_ok=True)
    path = osp.join(log_dir, "commit_hash.txt")
    if not osp.exists(path):
        with open(path, "w") as f:
            f.write(get_git_hash())


def _gt_gamma(x):
    return x ** (1 / 2.4)


class LSEWriter:
    """Disk writer for eval outputs."""

    SKIP_KEYS = ("accumulation", "ev_linear", "num_samples_per_ray")

    def __init__(self, log_dir: str):
        self.log_dir = osp.join(log_dir, "eval_results")
        self.comb_dir = osp.join(self.log_dir, "comb_imgs")
        os.makedirs(self.comb_dir, exist_ok=True)
        self.cnt = 0

    @staticmethod
    def _write_image(path: str, image: np.ndarray) -> np.ndarray:
        data = np.clip(np.asarray(image) * 255, 0, 255).astype(np.uint8)
        if data.ndim == 2:
            data = data[..., None]
        if data.shape[-1] != 3:
            data = np.tile(data, (1, 1, 3))
        write_png(path, data)
        return data

    def log_images(self, output_img_dict: dict):
        all_imgs = []
        for k, v in output_img_dict.items():
            if k in self.SKIP_KEYS:
                continue
            save_dir = osp.join(self.log_dir, k)
            os.makedirs(save_dir, exist_ok=True)
            v = np.asarray(v)
            if k == "linear" and v.max() > 0:
                v = v / v.max()
            all_imgs.append(self._write_image(osp.join(save_dir, f"{self.cnt:03d}.png"), v))
        if all_imgs:
            h = max(a.shape[0] for a in all_imgs)
            grid = np.concatenate(
                [np.pad(a, ((0, h - a.shape[0]), (0, 0), (0, 0))) for a in all_imgs], axis=1)
            write_png(osp.join(self.comb_dir, f"{self.cnt:03d}.png"), grid)
        self.cnt += 1

    def log_metrics(self, metrics_dict_list: list) -> dict:
        """eval_metrics.json (per-view lists) and eval_mean.json; returns
        the means."""
        keys = metrics_dict_list[0].keys()
        metrics = {k: [m[k] for m in metrics_dict_list] for k in keys}
        base = osp.dirname(self.log_dir)
        with open(osp.join(base, "eval_metrics.json"), "w") as f:
            json.dump(metrics, f, indent=4)
        means = {k: float(np.nanmean(np.asarray(v, np.float64))) for k, v in metrics.items()}
        with open(osp.join(base, "eval_mean.json"), "w") as f:
            json.dump(means, f, indent=4)
        return means

    def plt_mapper(self, mapper_name: str, mapper_params: dict, which: str = "rgb",
                   linear_img: np.ndarray = None, gt_fn=_gt_gamma) -> str:
        """The mapper's response on 1000 points of [0, max], max 1 unless
        the linear image's peak is above 1 or below 0.7, as numbers."""
        from lsenerf_tpu_torch.engine.trainer import tree_leaves
        from lsenerf_tpu_torch.models import mappers as mapper_lib

        save_dir = osp.join(osp.dirname(self.log_dir), f"{which}_mappers")
        os.makedirs(save_dir, exist_ok=True)
        n_saved = len([f for f in os.listdir(save_dir) if f.startswith(f"mapper_{which}")])
        path = osp.join(save_dir, f"mapper_{which}_{n_saved:03d}.json")
        max_val = 1.0
        if linear_img is not None:
            lin_max = float(np.max(linear_img))
            max_val = lin_max if (lin_max > 1 or lin_max < 0.7) else 1.0
        lins = np.linspace(0, max_val, 1000).reshape(-1, 1)
        dev = next((t.device for _, t in tree_leaves(mapper_params)), "cpu")
        with torch.no_grad():
            out = mapper_lib.apply_mapper(
                mapper_name, mapper_params, torch.as_tensor(lins, dtype=torch.float32, device=dev))
        out = out.float().cpu().numpy()
        if out.shape[-1] != lins.shape[-1]:
            out = np.broadcast_to(out, (len(lins), out.shape[-1]))
        curve = {"mapper": mapper_name, "x": lins[:, 0].tolist(),
                 "y": [out[:, c].tolist() for c in range(out.shape[-1])]}
        if gt_fn is not None:
            curve["gt"] = gt_fn(lins[:, 0]).tolist()
        with open(path, "w") as f:
            json.dump(curve, f)
        return path


class ScalarLogger:
    """Train-time scalars: metrics.jsonl always; TensorBoard where
    torch.utils.tensorboard imports and `use_tensorboard` is set."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(osp.join(log_dir, "metrics.jsonl"), "a")
        self.tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb = SummaryWriter(log_dir)
            except ImportError:
                self.tb = None

    def log(self, step: int, scalars: dict):
        self.jsonl.write(json.dumps({"step": step, **scalars}) + "\n")
        self.jsonl.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()
