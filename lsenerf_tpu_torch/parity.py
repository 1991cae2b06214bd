"""Metric-parity harness of the port: scripts/parity.py --tiny's golden
through the port's CLI. It writes the golden scene (the synthetic sphere
in the LSENeRF-formatter layout) to --workdir, runs parse -> train ->
eval -> eval_mean.json once a seed, and holds the mean PSNR and SSIM over
the seeds to the JAX package's own runs of the same protocol
(`tiny_gate`). chip_smoke.py's phase 4f and the slow CPU test apply the
same gate.

    python -m lsenerf_tpu_torch.parity                   # on the card
    python -m lsenerf_tpu_torch.parity --device cpu      # plain PyTorch
    python -m lsenerf_tpu_torch.parity --device cpu --steps 150  # a control

Exit code 0 = within the gate, 1 = regression.

`--real-scale ngpf32` runs scripts/golden_real_scale.py's protocol for the
real_scale_badnerf_ngpf32 golden instead (one seed, 96): the 200-frame
640x480 reference scene, 8000 training steps under the headline flags plus
the golden's (RGB only, no mapping, the ngp layout, f32), then eval.sh's
6010-step camera refinement and full eval. It records PSNR and SSIM beside
the golden's; it is a record, not a gate (exit code 0 once both stages
wrote eval_mean.json).

    python -m lsenerf_tpu_torch.parity --real-scale ngpf32 [--steps N --evalsh-steps M]
"""

from __future__ import annotations

import argparse
import json
import math
import os.path as osp
import statistics
import sys

# scripts/parity.py --tiny: the fixture-scale model, with a white
# background so that the metric tracks the field, not the blend noise
TINY = [
    "--pipeline.model.num-levels", "4", "--pipeline.model.log2-hashmap-size", "10",
    "--pipeline.model.base-res", "8", "--pipeline.model.max-res", "64",
    "--pipeline.model.max-samples", "16", "--pipeline.model.max-candidates", "64",
    "--pipeline.model.grid-resolution", "16", "--pipeline.model.grid-levels", "1",
    "--pipeline.datamanager.train-num-rays-per-batch", "256",
    "--pipeline.model.background-color", "white",
]

# The JAX package's PSNR and SSIM under `python scripts/parity.py --tiny
# --seed S` on a CPU (1500 steps), S = 96, 1, 2, 4-15. One run's spread
# (SD 0.63 dB / 0.029) is wider than parity.py's tolerances, and
# golden_parity.json's 10.409 / 0.505 lies 0.8 / 1.0 SD below these means,
# so a single run cannot be held to that file: the gate compares means.
JAX_TINY_RUNS = {
    "psnr": (11.190538, 10.625446, 10.591197, 11.060024, 9.817720, 11.922898, 11.141852,
             10.758559, 10.741899, 10.949806, 11.014945, 12.018864, 9.639530, 10.982790,
             11.151469),
    "ssim": (0.528195, 0.553096, 0.525584, 0.493423, 0.510642, 0.574119, 0.544765,
             0.511379, 0.542308, 0.549699, 0.530395, 0.587306, 0.479050, 0.542042,
             0.547831),
}
TINY_SEEDS = (96, 1, 2, 3)

# scripts/golden_real_scale.py: the headline protocol (train_lse_data.sh)
HEADLINE = [
    "--pipeline.model.rgb-loss-type", "deblur",
    "--pipeline.model.ev-one-dim", "gt",
    "--pipeline.model.use-mapping", "True",
    "--pipeline.model.mapping-method", "identity",
    "--pipeline.model.evs-mapping-method", "powpow",
    "--pipeline.model.map-mode", "co_map",
    "--pipeline.datamanager.col-cam-optimizer.mode", "SO3xR3",
    "--pipeline.datamanager.col-cam-optimizer.optim-type", "spline",
    "--pipeline.datamanager.col-cam-optimizer.exp-t", "30000",
    "--pipeline.datamanager.evs-cam-optimizer.mode", "SO3xR3",
]
# the extra flags of scripts/golden_parity.json's real_scale_badnerf_ngpf32
NGPF32 = [
    "--pipeline.datamanager.rgb_frac", "1.0",
    "--pipeline.model.use-mapping", "False",
    "--pipeline.model.map-mode", "None",
    "--pipeline.model.evs-mapping-method", "None",
    "--pipeline.model.hash-layout", "ngp",
    "--pipeline.model.compute-dtype", "float32",
]
# its PSNR / SSIM after training (8000 steps) and after eval.sh (JAX, on a TPU)
GOLDEN_NGPF32 = {"train_eval": (20.5683856010437, 0.7579276859760284),
                 "evalsh_eval": (21.884725093841553, 0.787766695022583)}
# scripts/golden_real_scale.py's scene
REAL_SCENE = dict(n_cams=200, h=480, w=640, focal=0.9 * 640, n_val=4, with_prevnext=True,
                  with_msk=True, with_full_camera=True, texture_freq=24.0)
# |port mean - JAX mean| at most GATE_Z standard errors of the difference,
# both sides' per-run spread taken as JAX's sample SD
GATE_Z = 3.0


def run(workdir: str, seed: int = 96, steps: int = 1500, extra=(), device=None) -> dict:
    """Write the golden scene into `workdir` unless it is there, train
    `steps` steps of the tiny model with an eval of every view at the
    last, and return eval_mean.json."""
    from lsenerf_tpu_torch import train
    from lsenerf_tpu_torch.data.synthetic import write_reference_scene

    data = osp.join(workdir, "golden_scene")
    if not osp.exists(osp.join(data, "colcam_set", "dataset.json")):
        write_reference_scene(data)
    argv = ["lsenerf", "--data", data, "--output-dir", osp.join(workdir, f"run_seed{seed}"),
            "--machine.seed", str(seed), "--max-num-iterations", str(steps),
            "--steps-per-eval-all-images", str(steps), "--steps-per-save", str(steps),
            "--steps-per-eval-image", str(10 * steps), "--pipeline.datamanager.rgb_frac", "0.66"]
    argv += TINY + list(extra)
    if device is not None:
        argv += ["--device", device]
    run_dir = train.main(argv)
    with open(osp.join(run_dir, "eval_mean.json")) as f:
        return json.load(f)


def real_scale(workdir: str, steps: int = 8000, evalsh_steps: int = 6010, seed: int = 96,
               device=None, extra=(), scene=None) -> dict:
    """scripts/golden_real_scale.py's protocol with the ngpf32 golden's
    flags: write the reference scene into `workdir` unless it is there,
    train `steps` steps, then eval.sh's `evalsh_steps`-step refinement and
    full eval. Returns {"train_eval", "evalsh_eval" (eval_mean.json each),
    "train_wall_s", "evalsh_wall_s", "scene_s"}."""
    import time

    from lsenerf_tpu_torch import train
    from lsenerf_tpu_torch.data.synthetic import write_reference_scene

    dev = [] if device is None else ["--device", device]
    data = osp.join(workdir, "scene")
    t0 = time.time()
    if not osp.exists(osp.join(data, "colcam_set", "dataset.json")):
        write_reference_scene(data, **(scene or REAL_SCENE))
    out = {"scene_s": time.time() - t0}
    t0 = time.time()
    run_dir = train.main([
        "lsenerf", "--data", data, "--output-dir", osp.join(workdir, "run"),
        "--machine.seed", str(seed), "--max-num-iterations", str(steps),
        "--steps-per-save", str(min(5000, steps)),
        "--steps-per-eval-image", str(steps // 3), "--steps-per-eval-all-images", str(steps),
        "--steps-per-eval-batch", str(steps // 3), "--pipeline.datamanager.rgb_frac", "0.66",
    ] + HEADLINE + NGPF32 + list(extra) + dev)
    out["train_wall_s"] = time.time() - t0
    with open(osp.join(run_dir, "eval_mean.json")) as f:
        out["train_eval"] = json.load(f)
    t0 = time.time()
    eval_dir = train.main([
        "lsenerf", "--max-num-iterations", str(evalsh_steps), "--steps-per-eval-image", "100000",
        "--load-dir", osp.join(run_dir, "checkpoints"),
        "--load-config", osp.join(run_dir, "config.yml"), "--is_eval", "True",
        "--emb_eval_mode", "zero", "--output-dir", osp.join(workdir, "eval_run"),
        "--pipeline.model.eval-num-rays-per-chunk", "4096",
    ] + dev)
    out["evalsh_wall_s"] = time.time() - t0
    with open(osp.join(eval_dir, "eval_mean.json")) as f:
        out["evalsh_eval"] = json.load(f)
    return out


def real_scale_lines(out: dict) -> list:
    """Lines of a real_scale() result beside the golden's PSNR / SSIM."""
    lines = []
    for k in ("train_eval", "evalsh_eval"):
        m, (gp, gs) = out[k], GOLDEN_NGPF32[k]
        lines.append(f"{k}: psnr {m['psnr']:.4f} (golden {gp:.4f}, {m['psnr'] - gp:+.4f}), "
                     f"ssim {m['ssim']:.4f} (golden {gs:.4f}, {m['ssim'] - gs:+.4f}), "
                     f"rays/s {m['num_rays_per_sec']:.0f}, fps {m['fps']:.3f}")
    lines.append(f"walls: scene {out['scene_s']:.1f} s, train {out['train_wall_s']:.1f} s, "
                 f"eval.sh {out['evalsh_wall_s']:.1f} s")
    return lines


def tiny_gate(runs: list) -> dict:
    """{metric: (port mean, JAX mean, z, within)} of the port's eval_mean
    dicts against JAX_TINY_RUNS."""
    out = {}
    for k, ref in JAX_TINY_RUNS.items():
        have = [r[k] for r in runs]
        mean, ref_mean = statistics.fmean(have), statistics.fmean(ref)
        se = statistics.stdev(ref) * math.sqrt(1 / len(ref) + 1 / len(have))
        z = (mean - ref_mean) / se
        out[k] = (mean, ref_mean, z, math.isfinite(z) and abs(z) <= GATE_Z)
    return out


def gate_line(gate: dict) -> str:
    return "; ".join(f"{k} mean {m:.4f} against JAX's {r:.4f}: z {z:+.2f} "
                     f"({'within' if ok else 'outside'} +-{GATE_Z:g})"
                     for k, (m, r, z, ok) in gate.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m lsenerf_tpu_torch.parity")
    ap.add_argument("--workdir", default="outputs/parity_torch")
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (1500; 8000 with --real-scale)")
    ap.add_argument("--seeds", type=int, nargs="+", default=None,
                    help=f"seeds ({' '.join(map(str, TINY_SEEDS))}; 96 with --real-scale)")
    ap.add_argument("--device", default=None, help="cpu for the plain PyTorch path")
    ap.add_argument("--real-scale", choices=["ngpf32"], default=None,
                    help="the real_scale_badnerf_ngpf32 protocol in place of --tiny's")
    ap.add_argument("--evalsh-steps", type=int, default=6010)
    args, extra = ap.parse_known_args(argv)

    if args.real_scale:
        steps, seed = args.steps or 8000, (args.seeds or [96])[0]
        out = real_scale(args.workdir, steps, args.evalsh_steps, seed, args.device, extra)
        for line in real_scale_lines(out):
            print(f"[parity] real_scale_badnerf_ngpf32, seed {seed}, {steps} + "
                  f"{args.evalsh_steps} steps: {line}")
        print(json.dumps({"real_scale_badnerf_ngpf32": out}))
        return 0

    runs = []
    for seed in args.seeds or TINY_SEEDS:
        got = run(args.workdir, seed, args.steps or 1500, extra, args.device)
        runs.append(got)
        print(f"[parity] seed {seed}: psnr {got['psnr']:.4f}, ssim {got['ssim']:.4f}")
    gate = tiny_gate(runs)
    ok = all(g[3] for g in gate.values())
    print(f"[parity] {gate_line(gate)}")
    print("[parity] OK" if ok else "[parity] FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
