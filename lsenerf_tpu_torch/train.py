"""Train and eval entry point of the PyTorch port. Port of the repo's
train.py: dotted CLI flags in the reference's spellings, the eval-mode
surgery (--is_eval, --do_pretrain, --load-dir, --load-config), config.yml,
checkpoints with exact resume (--load-checkpoint), the eval cadences and
the full-image eval that writes eval_metrics.json and eval_mean.json.

    python -m lsenerf_tpu_torch.train lsenerf --data <scene_dir> --max-num-iterations 30000
    python -m lsenerf_tpu_torch.train lsenerf --is_eval True --load-dir <run>/checkpoints \\
        --load-config <run>/config.yml
    python -m lsenerf_tpu_torch.train lsenerf --data <scene_dir> --device cpu   # plain PyTorch

It runs on the CUDA card unless `--device cpu` is given, and raises
without a card. Options the port does not have yet raise
NotImplementedError (engine/config.py check_supported).
"""

from __future__ import annotations

import datetime
import os
import os.path as osp
import sys


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
    from lsenerf_tpu_torch import resolve_device
    from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
    from lsenerf_tpu_torch.engine import checkpoints as ckpt_lib
    from lsenerf_tpu_torch.engine import config as config_lib
    from lsenerf_tpu_torch.engine.loop import run_training_loop
    from lsenerf_tpu_torch.engine.trainer import Trainer
    from lsenerf_tpu_torch.engine.writer import ScalarLogger, get_git_hash

    device, argv = _pop_device(sys.argv[1:] if argv is None else argv)
    device = resolve_device(device)

    config = config_lib.parse_cli(argv)
    config.timestamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
    config = config_lib.modify_config(config)
    trainer_cfg, model_cfg, dm_cfg, parser_cfg = config_lib.build_runtime_configs(config)
    if config.data and not config.experiment_name or config.experiment_name == "unnamed":
        config.experiment_name = osp.basename(str(config.data).rstrip("/")) or "synthetic"

    base_dir = config.base_dir()
    os.makedirs(base_dir, exist_ok=True)
    config_lib.save_config(config, osp.join(base_dir, "config.yml"))
    print(f"[lsenerf-torch] run dir: {base_dir}")

    col, evs, eval_ds, sp = build_datasets(config, parser_cfg)
    dm = MultiCamDataManager(dm_cfg, col, evs, seed=config.machine.seed)
    all_cameras = None
    if sp is not None and trainer_cfg.col_cam_opt.optim_type == "spline":
        all_cameras = sp.all_color_cameras()
    trainer = Trainer(trainer_cfg, model_cfg, dm, device=device, all_cameras=all_cameras)
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

    logger = ScalarLogger(base_dir, use_tensorboard=config.vis == "tensorboard")
    logger.log(0, {"commit": 0.0})
    print(f"[lsenerf-torch] git {get_git_hash()[:12]}, device {device}")
    ckpt_dir = osp.join(base_dir, "checkpoints")
    evs_only = config.pipeline.datamanager.rgb_frac == 0
    chunk = config.pipeline.model.eval_num_rays_per_chunk

    if config.max_num_iterations > 0:
        run_training_loop(
            trainer, num_steps=config.max_num_iterations, logger=logger, eval_ds=eval_ds,
            eval_chunk=chunk, eval_batch_rays=config.pipeline.datamanager.eval_num_rays_per_batch,
            ckpt_dir=ckpt_dir, base_dir=base_dir, apply_cam_opt=config.is_eval,
            evs_only=evs_only, profile_dir=os.environ.get("LSENERF_PROFILE_DIR"))
    elif eval_ds is not None:
        # nothing left to train (a resume at its target): the full eval is
        # the run's result, and the final save keeps the run dir whole,
        # under the last completed step (the loaded one)
        from lsenerf_tpu_torch.engine import evaluation

        means = evaluation.average_eval_metrics(trainer, eval_ds, base_dir, chunk=chunk,
                                                apply_cam_opt=config.is_eval, evs_only=evs_only)
        print("[eval @ resume] " + ", ".join(f"{k}={v:.4f}" for k, v in means.items()))
        ckpt_lib.save_checkpoint(ckpt_dir, max(trainer.step_count - 1, 0), trainer)
    logger.close()
    print("[lsenerf-torch] done")
    return base_dir


if __name__ == "__main__":
    main(sys.argv[1:])
