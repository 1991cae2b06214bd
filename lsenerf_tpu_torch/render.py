"""Render a trained model along a camera trajectory (the reference's
IS_RENDER mode). Port of the repo's render.py:

    python -m lsenerf_tpu_torch.render --load-dir <run>/checkpoints --load-config <run>/config.yml \\
        [--data <scene_dir>] [--output-dir renders] [--traj train|full] [--device cpu]

`train` renders the train cameras, `full` the scene's whole colour
trajectory (parser.all_color_cameras). Frames go to
<output-dir>/eval_results/{img,depth}/NNN.png through LSEWriter, under
the JAX package's names. It runs on the CUDA card unless `--device cpu` is
given.
"""

from __future__ import annotations

import argparse
import os
import sys


def load_trained(load_dir: str, load_config: str, data: str = "", device=None):
    """The run's config.yml with is_render set (and `data` in place of its
    scene where given), its datasets, and a RENDER-mode trainer on `device`
    with the latest checkpoint of `load_dir` restored. Returns (trainer,
    train colour dataset, scene parser or None)."""
    from lsenerf_tpu_torch import resolve_device
    from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
    from lsenerf_tpu_torch.engine import checkpoints as ckpt_lib
    from lsenerf_tpu_torch.engine import config as config_lib
    from lsenerf_tpu_torch.engine.trainer import Trainer
    from lsenerf_tpu_torch.train import build_datasets

    config = config_lib.load_config(load_config)
    config.is_render = True
    if data:
        config.data = data
    trainer_cfg, model_cfg, dm_cfg, parser_cfg = config_lib.build_runtime_configs(config)
    col, evs, _, sp = build_datasets(config, parser_cfg)
    dm = MultiCamDataManager(dm_cfg, col, evs)
    trainer = Trainer(trainer_cfg, model_cfg, dm, device=resolve_device(device))
    trainer.setup()
    step, params, occ = ckpt_lib.load_checkpoint(load_dir)
    ckpt_lib.restore_into_state(trainer, params, occ, step)
    return trainer, col, sp, step


def render_frames(trainer, col, cams, output_dir: str, chunk: int = 4096, log=print) -> int:
    """Render every camera of `cams` and write its rgb and depth (divided
    by its max) through LSEWriter. Returns the frame count."""
    from lsenerf_tpu_torch.engine import renderer
    from lsenerf_tpu_torch.engine.writer import LSEWriter

    os.makedirs(output_dir, exist_ok=True)
    writer = LSEWriter(output_dir)
    cams = cams.to(trainer.device)
    ids = col.appearance_ids
    for i in range(len(cams)):
        out = renderer.render_image(trainer.params["model"], cams, i, trainer.occ,
                                    trainer.model_config,
                                    appearance_id=int(ids[min(i, len(ids) - 1)]), chunk=chunk)
        writer.log_images({"img": out["rgb"], "depth": out["depth"] / out["depth"].max()})
        log(f"[render] frame {i + 1}/{len(cams)}")
    return len(cams)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m lsenerf_tpu_torch.render")
    ap.add_argument("--load-dir", required=True)
    ap.add_argument("--load-config", required=True)
    ap.add_argument("--data", default="")
    ap.add_argument("--output-dir", default="renders")
    ap.add_argument("--traj", default="train", choices=["train", "full"])
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--device", default=None, help="cpu for the plain PyTorch path (default: the card)")
    ns = ap.parse_args(sys.argv[1:] if argv is None else argv)

    trainer, col, sp, step = load_trained(ns.load_dir, ns.load_config, ns.data, ns.device)
    print(f"[render] restored step {step}")
    cams = sp.all_color_cameras() if ns.traj == "full" and sp is not None else col.cameras
    n = render_frames(trainer, col, cams, ns.output_dir, ns.chunk)
    print(f"[render] wrote {n} frames to {ns.output_dir}/eval_results")
    return ns.output_dir


if __name__ == "__main__":
    main()
