"""The port's CLI end to end on the CPU: `python -m lsenerf_tpu_torch.train
... --device cpu` through scripts/train_lse_data.sh's flags, then
scripts/eval.sh's run on the lsenerf preset and scripts/emb_eval.sh's two
stages on the lsenerf_emb preset, each as the script runs it (its own
flags, fewer steps, a tiny model); the zero-step resume; and the card
requirement. The slow test runs scripts/parity.py --tiny's golden through
the port on the CPU."""

import json
import os
import os.path as osp
import subprocess
import sys

import pytest
import torch

from lsenerf_tpu_torch import train
from lsenerf_tpu_torch.data.synthetic import write_reference_scene

from test_torch_config import ROOT, script_invocations, train_argv

TINY_MODEL = ["--pipeline.model.num-levels", "4", "--pipeline.model.base-res", "8",
              "--pipeline.model.max-res", "64", "--pipeline.model.max-samples", "16",
              "--pipeline.model.max-candidates", "64", "--pipeline.model.grid-resolution", "16",
              "--pipeline.model.grid-levels", "1", "--pipeline.datamanager.train-num-rays-per-batch",
              "256", "--vis", "none"]


def _cli(argv, cwd):
    """One `python -m lsenerf_tpu_torch.train` process on the CPU; returns
    the run dir it printed."""
    out = subprocess.run([sys.executable, "-m", "lsenerf_tpu_torch.train"] + argv + ["--device", "cpu"],
                         cwd=cwd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    run = [line.split("run dir: ", 1)[1] for line in out.stdout.splitlines() if "run dir: " in line]
    return osp.join(cwd, run[0])


def _steps(argv, n):
    """argv with its --max-num-iterations set to n."""
    argv = list(argv)
    argv[argv.index("--max-num-iterations") + 1] = str(n)
    return argv


def _has_run_files(run, evaluated=True):
    assert osp.exists(osp.join(run, "config.yml"))
    assert any(f.startswith("step-") for f in os.listdir(osp.join(run, "checkpoints")))
    if evaluated:
        means = json.load(open(osp.join(run, "eval_mean.json")))
        assert {"psnr", "ssim", "num_rays_per_sec", "fps"} <= set(means)


def test_cli_train_eval_sh_emb_eval_sh(tmp_path):
    data = str(tmp_path / "scene")
    write_reference_scene(data, n_cams=8, h=16, w=16, focal=20.0, n_val=2, with_prevnext=True,
                          with_msk=True, with_full_camera=True, texture_freq=3.0)
    cadence = ["--max-num-iterations", "12", "--steps-per-save", "6", "--steps-per-eval-batch", "6",
               "--steps-per-eval-image", "6", "--steps-per-eval-all-images", "12"]
    runs = {}
    for preset in ("lsenerf", "lsenerf_emb"):
        runs[preset] = _cli(train_argv(preset, data) + cadence + TINY_MODEL, str(tmp_path))
        _has_run_files(runs[preset])
        assert sorted(os.listdir(osp.join(runs[preset], "checkpoints"))) == [
            "step-000000005", "step-000000011"]

    # scripts/eval.sh on the lsenerf run: <run>_eval_zero/<timestamp>
    (argv,) = script_invocations("eval.sh", {"EXP_PATH": runs["lsenerf"]})
    ev = _cli(_steps(argv, 8), str(tmp_path))
    assert osp.dirname(ev) == runs["lsenerf"] + "_eval_zero"
    _has_run_files(ev)

    # scripts/emb_eval.sh on the lsenerf_emb run, stage 2 finding stage 1's
    # run by the script's rule
    exp = runs["lsenerf_emb"]
    stage1, _ = script_invocations("emb_eval.sh", {"EXP_PATH": exp})
    pre = _cli(_steps(stage1, 4), str(tmp_path))
    _has_run_files(pre, evaluated=False)
    last = sorted(d for d in os.listdir(exp + "_eval_param") if "_eval_param" not in d)[-1]
    assert osp.join(exp + "_eval_param", last) == pre
    _, stage2 = script_invocations("emb_eval.sh", {"EXP_PATH": exp, "LAST_DIR": last})
    post = _cli(_steps(stage2, 8), str(tmp_path))
    assert osp.dirname(post) == pre + "_eval_param"
    _has_run_files(post)
    pre_table = torch.load(osp.join(pre, "checkpoints", "step-000000015"),
                           weights_only=True)["params"]["model"]["field"]["appearance"]["test_table"]
    post_table = torch.load(osp.join(post, "checkpoints", "step-000000023"),
                            weights_only=True)["params"]["model"]["field"]["appearance"]["test_table"]
    assert torch.equal(pre_table, post_table)

    # a resume with nothing left to train evaluates and saves under the loaded step
    zero = train.main(["lsenerf", "--data", data, "--output-dir", str(tmp_path / "zero"),
                       "--max-num-iterations", "0", "--load-checkpoint",
                       osp.join(runs["lsenerf"], "checkpoints", "step-000000011"),
                       "--device", "cpu"] + TINY_MODEL)
    _has_run_files(zero)
    assert os.listdir(osp.join(zero, "checkpoints")) == ["step-000000011"]
    # --load-dir restores weights only, from --load-step where it is given
    named = train.main(["lsenerf", "--data", data, "--output-dir", str(tmp_path / "named"),
                        "--max-num-iterations", "0", "--load-step", "5", "--load-dir",
                        osp.join(runs["lsenerf"], "checkpoints"), "--device", "cpu"] + TINY_MODEL)
    assert os.listdir(osp.join(named, "checkpoints")) == ["step-000000005"]
    saved = torch.load(osp.join(named, "checkpoints", "step-000000005"), weights_only=True)
    assert saved["opt"]["adam"] == {} and saved["opt"]["count"] == 0


def test_cli_needs_the_card_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["lsenerf", "--data", "synthetic", "--output-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_tiny_gate_compares_means_with_jax():
    from lsenerf_tpu_torch import parity

    ref = parity.JAX_TINY_RUNS
    gate = parity.tiny_gate([dict(psnr=p, ssim=s) for p, s in zip(ref["psnr"], ref["ssim"])])
    assert all(ok and abs(z) < 1e-9 for _, _, z, ok in gate.values())
    # four runs at JAX's mean SSIM, their PSNR 1.1 dB above its mean (3.1
    # standard errors): PSNR alone fails; a NaN fails
    mean = {k: sum(v) / len(v) for k, v in ref.items()}
    runs = [dict(psnr=mean["psnr"] + 1.1, ssim=mean["ssim"])] * 4
    gate = parity.tiny_gate(runs)
    assert not gate["psnr"][3] and gate["ssim"][3]
    assert 3.0 < gate["psnr"][2] < 3.2
    gate = parity.tiny_gate(runs[:3] + [dict(psnr=float("nan"), ssim=mean["ssim"])])
    assert not gate["psnr"][3]


@pytest.mark.slow
def test_tiny_golden_on_cpu(tmp_path):
    """scripts/parity.py --tiny through the port's parse -> train -> eval
    (lsenerf_tpu_torch/parity.py): 1500 steps at each of the gate's seeds
    on the 64x64 golden scene, the means within parity.tiny_gate."""
    from lsenerf_tpu_torch import parity

    runs = [parity.run(str(tmp_path), seed, device="cpu") for seed in parity.TINY_SEEDS]
    gate = parity.tiny_gate(runs)
    assert all(g[3] for g in gate.values()), parity.gate_line(gate)
