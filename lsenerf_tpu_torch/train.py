"""Train and eval entry point of the PyTorch port. Port of the repo's
train.py: dotted CLI flags in the reference's spellings, the eval-mode
surgery (--is_eval, --do_pretrain, --load-dir, --load-config), config.yml,
checkpoints with exact resume (--load-checkpoint), the eval cadences and
the full-image eval that writes eval_metrics.json and eval_mean.json.

    python -m lsenerf_tpu_torch.train lsenerf --data <scene_dir> --max-num-iterations 30000
    python -m lsenerf_tpu_torch.train lsenerf --is_eval True --load-dir <run>/checkpoints \\
        --load-config <run>/config.yml
    python -m lsenerf_tpu_torch.train lsenerf --data <scene_dir> --device cpu   # plain PyTorch
    python -m lsenerf_tpu_torch.train lsenerf --data <scene_dir> --machine.num-devices 2

It runs on the CUDA card unless `--device cpu` is given, and raises
without a card. `--machine.num-devices N` (N > 1) spawns N ranks, one
process each, on cuda:0..N-1 over NCCL (over gloo on the CPU); a process
that torchrun started joins its group instead (parallel/ddp.py). Rank 0
writes the run dir, the logs and the checkpoints and runs the evals.
`--is_render True` runs the render mode (nothing trains, no occupancy
update, no eval-ray batch). `--machine.scan-steps k` (JAX's default 16)
trains k steps a chunk: on the card one replayed CUDA graph a chunk, on
the CPU k eager steps (engine/loop.py). A training run on the blocked layout logs
`grad_overflow` every 256 steps (engine/loop.py), and every step's with
`--pipeline.model.grad-overflow-telemetry True`.
"""

from __future__ import annotations

import datetime
import os
import os.path as osp
import sys

import torch


def build_datasets(config, parser_cfg):
    """--data names a scene dir (the LSENeRF-formatter layout) or the
    built-in synthetic sphere scene ('synthetic'). Returns (train colour,
    events or None, eval colour, parser or None)."""
    data = config.data or config.pipeline.datamanager.data
    if not data or str(data).startswith("synthetic"):
        from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene

        col, evs = make_synthetic_scene(n_cams=12, h=64, w=64, focal=60.0)
        return col, evs, col, None
    from lsenerf_tpu_torch.data.parser import SceneParser

    sp = SceneParser(str(data), parser_cfg)
    col = sp.parse_color("train", is_eval=config.is_eval, do_pretrain=config.do_pretrain)
    evs = sp.parse_events() if config.pipeline.datamanager.rgb_frac < 1 else None
    return col, evs, sp.parse_color("val"), sp


def _pop_device(argv):
    """The port's own flag, --device <cuda|cpu> (not part of config.yml)."""
    argv = list(argv)
    for i, tok in enumerate(argv):
        if tok == "--device":
            return argv[i + 1], argv[:i] + argv[i + 2:]
        if tok.startswith("--device="):
            return tok.split("=", 1)[1], argv[:i] + argv[i + 1:]
    return None, argv


def graft_test_embedding(trainer) -> None:
    """Add the one-row test embedding (seeded from a train row) to the
    tree and give the trainer a fresh optimizer over the new tree."""
    from lsenerf_tpu_torch.models import embeddings as emb_lib

    app = trainer.params["model"]["field"].get("appearance")
    if app is None:
        return
    grafted = emb_lib.init_test_params(app, trainer.model_config.field.embedding)
    if "test_table" in grafted and "test_table" not in app:
        app["test_table"] = grafted["test_table"].detach().clone().requires_grad_(True)
    trainer.rebuild_optimizer()


def main(argv=None):
    """The CLI. Runs in this process, in the group that torchrun made, or
    in machine.num_devices spawned ranks. Returns the run dir."""
    from lsenerf_tpu_torch import resolve_device
    from lsenerf_tpu_torch.engine import config as config_lib
    from lsenerf_tpu_torch.parallel import ddp

    device, argv = _pop_device(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)
    timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    backend = "nccl" if device.type == "cuda" else "gloo"
    dp = ddp.from_env(backend)
    if dp is not None:
        if device.type == "cuda":
            device = torch.device(f"cuda:{ddp.local_rank()}")
            torch.cuda.set_device(device)
        return run(argv, device, dp, dp.broadcast_object(timestamp))
    n = config_lib.parse_cli(argv).machine.num_devices
    if n > 1:
        init_method = f"tcp://localhost:{ddp.free_port()}"
        print(f"[lsenerf-torch] data parallel: {n} ranks over {backend}")
        ddp.spawn(_rank_main, n, (n, argv, str(device), backend, init_method, timestamp))
        return _config(argv, timestamp).base_dir()
    return run(argv, device, None, timestamp)


def _rank_main(rank, world_size, argv, device, backend, init_method, timestamp):
    """One spawned rank, on cuda:rank on the card."""
    from lsenerf_tpu_torch.parallel import ddp

    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device(f"cuda:{rank}")
        torch.cuda.set_device(device)
    dp = ddp.init(rank, world_size, backend, init_method)
    try:
        run(argv, device, dp, timestamp)
    finally:
        ddp.shutdown()


def _config(argv, timestamp):
    """The run's config tree: the CLI's, after the eval-mode surgery, with
    the experiment named after the scene."""
    from lsenerf_tpu_torch.engine import config as config_lib

    config = config_lib.parse_cli(argv)
    config.timestamp = timestamp
    config = config_lib.modify_config(config)
    if config.data and not config.experiment_name or config.experiment_name == "unnamed":
        config.experiment_name = osp.basename(str(config.data).rstrip("/")) or "synthetic"
    return config


def run(argv, device, dp=None, timestamp: str = ""):
    """One process's run (rank dp.rank of a data-parallel group, or the
    only one): datasets, trainer, restore, the training loop with the
    proposal warmup, the final eval. Returns the run dir."""
    from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
    from lsenerf_tpu_torch.engine import checkpoints as ckpt_lib
    from lsenerf_tpu_torch.engine import config as config_lib
    from lsenerf_tpu_torch.engine.loop import run_training_loop
    from lsenerf_tpu_torch.engine.trainer import Trainer
    from lsenerf_tpu_torch.engine.writer import ScalarLogger, get_git_hash
    from lsenerf_tpu_torch.parallel import ddp

    config = _config(argv, timestamp)
    trainer_cfg, model_cfg, dm_cfg, parser_cfg = config_lib.build_runtime_configs(config)
    rank = 0 if dp is None else dp.rank
    if dp is not None:
        ddp.round_rays(dm_cfg, dp.world_size)
    base_dir = config.base_dir()
    main_rank = rank == 0
    if main_rank:
        os.makedirs(base_dir, exist_ok=True)
        config_lib.save_config(config, osp.join(base_dir, "config.yml"))
        print(f"[lsenerf-torch] run dir: {base_dir}")

    col, evs, eval_ds, sp = build_datasets(config, parser_cfg)
    # each rank samples its share of the global batch with its own seed
    dm = MultiCamDataManager(dm_cfg, col, evs, seed=config.machine.seed + rank)
    all_cameras = None
    if sp is not None and trainer_cfg.col_cam_opt.optim_type == "spline":
        all_cameras = sp.all_color_cameras()
    trainer = Trainer(trainer_cfg, model_cfg, dm, device=device, all_cameras=all_cameras, dp=dp)
    trainer.setup()

    param_eval = config.pipeline.model.embed_config.eval_mode == "param"
    if config.is_eval and not config.do_pretrain and param_eval:
        # emb_eval stage 2: the slot exists before the restore, so the
        # pretrain's learned row grafts in from the checkpoint
        graft_test_embedding(trainer)

    if config.load_checkpoint and not config.is_eval:
        path = str(config.load_checkpoint)
        m = ckpt_lib.STEP_NAME.match(osp.basename(path))
        loaded_step, params, occ, opt, rng = ckpt_lib.load_checkpoint_full(
            osp.dirname(path), step=int(m.group(1)) if m else None)
        restored = ckpt_lib.restore_into_state(trainer, params, occ, loaded_step, opt=opt, rng=rng)
        print(f"[lsenerf-torch] restored checkpoint step {loaded_step} (exact resume: optimizer "
              f"state {'restored' if restored else 'not in the checkpoint or another shape'})")
    elif config.load_dir or config.load_checkpoint:
        load_dir = str(config.load_dir or osp.dirname(config.load_checkpoint))
        step = None if config.load_step < 0 else config.load_step
        loaded_step, params, occ = ckpt_lib.load_checkpoint(
            load_dir, step=step, strip_cameras=config.is_eval and not config.do_pretrain)
        ckpt_lib.restore_into_state(trainer, params, occ, loaded_step)
        print(f"[lsenerf-torch] restored checkpoint step {loaded_step}")

    if config.do_pretrain:
        # emb_eval stage 1: the test row is seeded from the restored table
        graft_test_embedding(trainer)

    logger = None
    if main_rank:
        logger = ScalarLogger(base_dir, use_tensorboard=config.vis == "tensorboard")
        logger.log(0, {"commit": 0.0})
        print(f"[lsenerf-torch] git {get_git_hash()[:12]}, device {device}"
              + ("" if dp is None else f", {dp.world_size} ranks"))
    ckpt_dir = osp.join(base_dir, "checkpoints")
    evs_only = config.pipeline.datamanager.rgb_frac == 0
    chunk = config.pipeline.model.eval_num_rays_per_chunk
    loop_kwargs = dict(
        logger=logger, eval_ds=eval_ds, eval_chunk=chunk,
        eval_batch_rays=config.pipeline.datamanager.eval_num_rays_per_batch, ckpt_dir=ckpt_dir,
        base_dir=base_dir, apply_cam_opt=config.is_eval, evs_only=evs_only,
        profile_dir=os.environ.get("LSENERF_PROFILE_DIR"), is_render=config.is_render,
        scan_steps=config.machine.scan_steps)

    total = config.max_num_iterations
    warmup = int(config.pipeline.model.proposal_warmup_steps)
    if (warmup > 0 and model_cfg.proposal_samples > 0 and not config.is_eval
            and not config.is_render and trainer.step_count < warmup):
        # annealed F: train without the proposal (every occupancy slot a
        # sample) while the grid's EMA is still noise, then at F. The
        # parameters and Adam's state do not depend on F, so the same
        # trainer carries them across
        k1 = min(warmup - trainer.step_count, total)
        if main_rank:
            print(f"[lsenerf-torch] proposal warmup: {k1} steps at max_samples="
                  f"{model_cfg.max_samples} slots, then F={model_cfg.proposal_samples}")
        with trainer.model_override(proposal_samples=0):
            run_training_loop(trainer, num_steps=k1, **loop_kwargs)
        total -= k1

    if total > 0:
        run_training_loop(trainer, num_steps=total, **loop_kwargs)
    elif eval_ds is not None and not config.is_render:
        # nothing left to train (a resume at its target): the full eval is
        # the run's result, and the final save keeps the run dir whole,
        # under the last completed step (the loaded one)
        from lsenerf_tpu_torch.engine import evaluation

        if main_rank:
            means = evaluation.average_eval_metrics(trainer, eval_ds, base_dir, chunk=chunk,
                                                    apply_cam_opt=config.is_eval,
                                                    evs_only=evs_only)
            print("[eval @ resume] " + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
        ckpt_lib.save_checkpoint(ckpt_dir, max(trainer.step_count - 1, 0), trainer)
    if logger is not None:
        logger.close()
        print("[lsenerf-torch] done")
    return base_dir


if __name__ == "__main__":
    main(sys.argv[1:])
