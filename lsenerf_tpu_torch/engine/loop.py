"""The training loop and its cadences. Port of lsenerf_tpu/engine/loop.py,
in chunks of `scan_steps` (JAX's chunked loop, lsenerf_tpu/engine/loop.py:
82-148): a chunk of k steps is one call of Trainer.make_train_step_multi(k)
on batches from MultiCamDataManager.next_train_stack (one replayed CUDA
graph on the card), and a trimmed last chunk runs as single steps; every
cadence fires on the chunk's last step `last` where the chunk covers one
of its steps (_covered), so they fire on JAX's steps. scan_steps 1 runs
Trainer.step a step, as before:
  - the occupancy update every grid.update_interval steps, before any
    chunk that covers one of its steps (with scan_steps 1 inside
    Trainer.step, on the same absolute steps);
  - scalar logging every `log_every` steps (printed every `print_every`),
    each logged step also handed to `callback(step, scalars)`; with
    `fail_fast` (the default) a non-finite loss stops the run, else it is
    logged and the run goes on;
  - the eval-ray-batch, eval-image and eval-all-images cadences;
  - the checkpoint cadence and the final checkpoint;
  - the grad_overflow sentinel (TrainerConfig.grad_overflow_every, TRAIN
    mode, blocked layout): after the chunk holding step s with (s + 1) a
    multiple of it, Trainer.overflow_count of the chunk's last batch,
    logged at its last step and carried in the returned metrics. JAX merges it into the step's metrics only,
    whose log (s a multiple of 100) never falls on a sentinel step (s + 1
    a multiple of 256), so the port logs the probe where it fires;
  - an optional torch.profiler trace of the chunks that start in the
    first 30 steps (LSENERF_PROFILE_DIR in the CLI);
  - while any torch profiler runs, the spans and counters of
    engine/spans.py: the call is one run, with the spans "loop", "chunk"
    (its children "chunk.draw" and, in ChunkGraph, "chunk.stage",
    "chunk.refresh_occ", "chunk.capture", "chunk.launch"), "occ_update",
    "log", "overflow_probe", "eval_batch", "eval_image" and "checkpoint".
A render run (`is_render`) skips the occupancy updates and the
eval-ray-batch cadence, as the JAX loop does. Under data parallelism
(trainer.dp) the evals and the log run on rank 0 while the other ranks
wait at a barrier; every rank takes the checkpoint cadence (rank 0
writes).
Cadences fire on absolute step numbers, so a resumed run keeps the
original schedule: step s fires a cadence of `every` when (s + 1) is a
multiple of it.

The JAX loop retries a flaky remote TPU compile and skips an eval or a
sentinel probe that fails; the port does neither: an eval or a probe that
raises ends the run.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from lsenerf_tpu_torch.engine import spans

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
    is_render: bool = False,
    scan_steps: int = 1,
    log_every: int = 100,
    print_every: int = 1000,
    callback=None,
    fail_fast: bool = True,
):
    """Run `num_steps` steps (default max_num_iterations) from the
    trainer's current step, `scan_steps` a chunk. Returns the last step's
    metrics as floats. `log_every`, `print_every`, `callback` and
    `fail_fast` are JAX's, with its defaults (lsenerf_tpu/engine/loop.py:
    66-69)."""
    from lsenerf_tpu_torch.engine import checkpoints as ckpt_lib
    from lsenerf_tpu_torch.engine import evaluation, renderer
    from lsenerf_tpu_torch.engine.trainer import RunMode
    from lsenerf_tpu_torch.ops import metrics as metric_ops

    cfg = trainer.config
    dm = trainer.dm
    num_steps = num_steps or cfg.max_num_iterations
    start = trainer.step_count
    end = start + num_steps

    dp = trainer.dp
    if dp is not None and not dp.is_main:
        eval_ds = logger = profile_dir = None  # evals, logs and the trace are rank 0's
    eval_cams = None
    if eval_ds is not None:
        eval_cams = eval_ds.cameras.to(trainer.device)
        eval_batch_rng = np.random.default_rng(cfg.seed + 17)

    def wait_for_main(it: int, k: int, *cadences):
        """The other ranks wait for rank 0's evals after the chunk of k
        steps from it."""
        if dp is not None and any(_covered(it + 1, every, k) for every in cadences):
            dp.barrier()

    # the grad_overflow sentinel (JAX: training mode, blocked layout only)
    overflow_every = cfg.grad_overflow_every if (
        cfg.mode == RunMode.TRAIN and not is_render
        and trainer.model_config.field.hash.layout == "blocked") else 0

    prof = None
    if profile_dir:
        prof = torch.profiler.profile(
            on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))
        prof.start()

    with spans.run(), spans.span("loop"):
        scan_k = max(1, int(scan_steps))
        grid_every = trainer.model_config.grid.update_interval
        train_steps_multi = trainer.make_train_step_multi(scan_k) if scan_k > 1 else None
        metrics = {}
        for it in range(start, end, scan_k):
            k_eff = min(scan_k, end - it)  # the trimmed last chunk runs as single steps
            last = it + k_eff - 1
            if scan_k == 1:
                with spans.span("chunk", step=it):
                    with spans.span("chunk.draw"):
                        batch = dm.next_train(it)
                    spans.count("eager_steps", 1, "scan_steps 1")
                    metrics = trainer.step(batch, update_occ=False) if is_render else trainer.step(batch)
            else:
                if not is_render and _covered(it, grid_every, k_eff):
                    with spans.span("occ_update", step=it):
                        trainer.occ_update()
                with spans.span("chunk", step=it):
                    if k_eff == scan_k:
                        with spans.span("chunk.draw"):
                            stacked = dm.next_train_stack(it, scan_k)
                        metrics = train_steps_multi(stacked)
                        batch = {k: v[-1] for k, v in stacked.items()}
                    else:
                        spans.count("eager_steps", k_eff, "trimmed chunk")
                        for j in range(k_eff):
                            with spans.span("chunk.draw"):
                                batch = dm.next_train(it + j)
                            metrics = trainer.step(batch, update_occ=False)
            if prof is not None and it - start >= 30:
                prof.stop()
                prof = None
            if _covered(it + 1, overflow_every, k_eff):
                with spans.span("overflow_probe", step=it):
                    overflow = trainer.overflow_count(batch)
                metrics = dict(metrics, grad_overflow=overflow)
                if logger is not None:
                    logger.log(last, {"grad_overflow": float(overflow)})
            if _covered(it, log_every, k_eff):
                with spans.span("log", step=it):
                    scal = {k: float(v) for k, v in metrics.items()}
                if logger is not None:
                    logger.log(last, scal)
                if callback is not None:
                    callback(last, scal)
                if fail_fast and not math.isfinite(scal.get("loss", 0.0)):
                    raise RuntimeError(f"non-finite loss at step {last}: {scal}")
                if _covered(it, print_every, k_eff) and logger is not None:
                    print(f"step {last}: " + ", ".join(f"{k}={v:.4f}" for k, v in scal.items()))
            if eval_cams is not None and not is_render and _covered(it + 1, cfg.steps_per_eval_batch, k_eff):
                nb = eval_batch_rays
                vi = eval_batch_rng.integers(0, len(eval_ds), nb)
                ys = eval_batch_rng.integers(0, eval_cams.height, nb)
                xs = eval_batch_rng.integers(0, eval_cams.width, nb)
                with spans.span("eval_batch", step=it):
                    em = trainer.eval_batch(eval_cams, vi, np.stack([ys, xs], 1),
                                            eval_ds.images[vi, ys, xs], eval_ds.appearance_ids[vi])
                if logger is not None:
                    logger.log(last, {k: float(v) for k, v in em.items()})
            if eval_ds is not None and _covered(it + 1, cfg.steps_per_eval_image, k_eff):
                vi = int(np.random.default_rng(it).integers(0, len(eval_ds)))
                with spans.span("eval_image", step=it):
                    out = renderer.render_image(
                        trainer.params["model"], eval_cams, vi, trainer.occ, trainer.model_config,
                        appearance_id=int(eval_ds.appearance_ids[vi]), chunk=eval_chunk)
                    psnr_v = float(metric_ops.psnr(torch.as_tensor(eval_ds.images[vi]),
                                                   torch.as_tensor(out["rgb"])))
                if logger is not None:
                    logger.log(last, {"eval_psnr": psnr_v})
                print(f"[eval-image @ {last}] view {vi} psnr {psnr_v:.2f}")
            wait_for_main(it, k_eff, cfg.steps_per_eval_image, 0 if is_render else cfg.steps_per_eval_batch)
            if ckpt_dir is not None and _covered(it + 1, cfg.steps_per_save, k_eff):
                with spans.span("checkpoint", step=it):
                    ckpt_lib.save_checkpoint(ckpt_dir, last, trainer)
            if eval_ds is not None and base_dir is not None and _covered(
                    it + 1, cfg.steps_per_eval_all_images, k_eff):
                means = evaluation.average_eval_metrics(
                    trainer, eval_ds, base_dir, chunk=eval_chunk, apply_cam_opt=apply_cam_opt,
                    evs_only=evs_only)
                print(f"[eval @ {last}] " + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
            wait_for_main(it, k_eff, cfg.steps_per_eval_all_images)
        if prof is not None:
            prof.stop()
        if ckpt_dir is not None:
            with spans.span("checkpoint"):
                ckpt_lib.save_checkpoint(ckpt_dir, end - 1, trainer)
        return {k: float(v) for k, v in metrics.items()}
