"""The training loop and its cadences. Port of lsenerf_tpu/engine/loop.py
for single steps:
  - the occupancy update every grid.update_interval steps (inside
    Trainer.step, on the same absolute steps);
  - scalar logging every LOG_EVERY steps (printed every PRINT_EVERY),
    and a non-finite loss stops the run;
  - the eval-ray-batch, eval-image and eval-all-images cadences;
  - the checkpoint cadence and the final checkpoint;
  - an optional torch.profiler trace of the first ~30 steps
    (LSENERF_PROFILE_DIR in the CLI).
Cadences fire on absolute step numbers, so a resumed run keeps the
original schedule: step s fires a cadence of `every` when (s + 1) is a
multiple of it.

The JAX loop retries a flaky remote TPU compile and skips an eval that
fails; the port does neither: an eval that raises ends the run.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

LOG_EVERY = 100
PRINT_EVERY = 1000


def _covered(first: int, every: int, k: int) -> bool:
    """Does the step range [first, first+k-1] contain a multiple of `every`?"""
    if every <= 0:
        return False
    if first <= 0:
        return True
    return (first + k - 1) // every > (first - 1) // every


def run_training_loop(
    trainer,
    *,
    num_steps: Optional[int] = None,
    logger=None,
    eval_ds=None,
    eval_chunk: int = 4096,
    eval_batch_rays: int = 4096,
    ckpt_dir: Optional[str] = None,
    base_dir: Optional[str] = None,
    apply_cam_opt: bool = False,
    evs_only: bool = False,
    profile_dir: Optional[str] = None,
):
    """Run `num_steps` steps (default max_num_iterations) from the
    trainer's current step. Returns the last step's metrics as floats."""
    from lsenerf_tpu_torch.engine import checkpoints as ckpt_lib
    from lsenerf_tpu_torch.engine import evaluation, renderer
    from lsenerf_tpu_torch.ops import metrics as metric_ops

    cfg = trainer.config
    dm = trainer.dm
    num_steps = num_steps or cfg.max_num_iterations
    start = trainer.step_count
    end = start + num_steps

    eval_cams = None
    if eval_ds is not None:
        eval_cams = eval_ds.cameras.to(trainer.device)
        eval_batch_rng = np.random.default_rng(cfg.seed + 17)

    prof = None
    if profile_dir:
        prof = torch.profiler.profile(
            on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))
        prof.start()

    metrics = {}
    for it in range(start, end):
        metrics = trainer.step(dm.next_train(it))
        if prof is not None and it - start >= 30:
            prof.stop()
            prof = None
        if _covered(it, LOG_EVERY, 1):
            scal = {k: float(v) for k, v in metrics.items()}
            if logger is not None:
                logger.log(it, scal)
            if not math.isfinite(scal.get("loss", 0.0)):
                raise RuntimeError(f"non-finite loss at step {it}: {scal}")
            if _covered(it, PRINT_EVERY, 1) and logger is not None:
                print(f"step {it}: " + ", ".join(f"{k}={v:.4f}" for k, v in scal.items()))
        if eval_cams is not None and _covered(it + 1, cfg.steps_per_eval_batch, 1):
            nb = eval_batch_rays
            vi = eval_batch_rng.integers(0, len(eval_ds), nb)
            ys = eval_batch_rng.integers(0, eval_cams.height, nb)
            xs = eval_batch_rng.integers(0, eval_cams.width, nb)
            em = trainer.eval_batch(eval_cams, vi, np.stack([ys, xs], 1), eval_ds.images[vi, ys, xs],
                                    eval_ds.appearance_ids[vi])
            if logger is not None:
                logger.log(it, {k: float(v) for k, v in em.items()})
        if eval_ds is not None and _covered(it + 1, cfg.steps_per_eval_image, 1):
            vi = int(np.random.default_rng(it).integers(0, len(eval_ds)))
            out = renderer.render_image(
                trainer.params["model"], eval_cams, vi, trainer.occ, trainer.model_config,
                appearance_id=int(eval_ds.appearance_ids[vi]), chunk=eval_chunk)
            psnr_v = float(metric_ops.psnr(torch.as_tensor(eval_ds.images[vi]),
                                           torch.as_tensor(out["rgb"])))
            if logger is not None:
                logger.log(it, {"eval_psnr": psnr_v})
            print(f"[eval-image @ {it}] view {vi} psnr {psnr_v:.2f}")
        if ckpt_dir is not None and _covered(it + 1, cfg.steps_per_save, 1):
            ckpt_lib.save_checkpoint(ckpt_dir, it, trainer)
        if eval_ds is not None and base_dir is not None and _covered(
                it + 1, cfg.steps_per_eval_all_images, 1):
            means = evaluation.average_eval_metrics(
                trainer, eval_ds, base_dir, chunk=eval_chunk, apply_cam_opt=apply_cam_opt,
                evs_only=evs_only)
            print(f"[eval @ {it}] " + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
    if prof is not None:
        prof.stop()
    if ckpt_dir is not None:
        ckpt_lib.save_checkpoint(ckpt_dir, end - 1, trainer)
    return {k: float(v) for k, v in metrics.items()}
