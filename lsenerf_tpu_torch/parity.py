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
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(TINY_SEEDS))
    ap.add_argument("--device", default=None, help="cpu for the plain PyTorch path")
    args, extra = ap.parse_known_args(argv)

    runs = []
    for seed in args.seeds:
        got = run(args.workdir, seed, args.steps, extra, args.device)
        runs.append(got)
        print(f"[parity] seed {seed}: psnr {got['psnr']:.4f}, ssim {got['ssim']:.4f}")
    gate = tiny_gate(runs)
    ok = all(g[3] for g in gate.values())
    print(f"[parity] {gate_line(gate)}")
    print("[parity] OK" if ok else "[parity] FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
