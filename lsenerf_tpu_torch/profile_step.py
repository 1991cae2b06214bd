"""Where the flagship train step's time goes on the card.

    python -m lsenerf_tpu_torch.profile_step [--production | --preset NAME] [--warm 20] [--steps 8] [--out outputs/profile]
        [--hash-layout ngp] [--compute-dtype float32]

Runs the flagship trainer (flagship.py), with `--production` the
production protocol's (RGB spline + deblur x4), or with `--preset` one of
the four presets' (flagship.preset_trainer: lsenerf, lsenerf_emb, badnerf,
badnerf_emb; `--hash-layout` and `--compute-dtype` change its field as
the CLI's flags do), for `--warm` steps, then traces
`--steps` steps with torch.profiler (CPU and CUDA activities, no occupancy
update inside the window). Prints the step time from CUDA events, the
device's busy time per step (the union of kernel intervals on the card),
its idle share, the device time of the encode kernels (K1/K2 blocked,
K7a/K7b ngp) and of the
index kernels (the spline's knot gathers; under evs_emb also the
appearance lookup's index_select and index_add), and the top
kernels by device time; writes the full table and a Chrome trace under
`--out` (profile_step[_production|_NAME][_LAYOUT_DTYPE].txt and
..._trace.json.gz).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys


def _busy_ms(events) -> float:
    """Union length of the device intervals (ms)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3  # us -> ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--production", action="store_true",
                      help="trace the production protocol's trainer")
    mode.add_argument("--preset", choices=["lsenerf", "lsenerf_emb", "badnerf", "badnerf_emb"],
                      help="trace this preset's trainer (train_lse_data.sh's protocol)")
    ap.add_argument("--hash-layout", choices=["blocked", "ngp"], default="blocked")
    ap.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16")
    ap.add_argument("--warm", type=int, default=20)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default="outputs/profile")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lsenerf_tpu_torch.flagship import preset_trainer

    if not torch.cuda.is_available():
        print("profile_step: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    field = dict(hash_layout=args.hash_layout, compute_dtype=args.compute_dtype)
    if args.preset:
        trainer, label = preset_trainer(args.preset, **field), args.preset
    else:
        trainer = preset_trainer("lsenerf", args.production, **field)
        label = "production" if args.production else "flagship"
    if args.hash_layout != "blocked" or args.compute_dtype != "bfloat16":
        label += f"_{args.hash_layout}_{args.compute_dtype}"
    interval = trainer.model_config.grid.update_interval
    n = args.warm + args.steps
    batches = [trainer.dm.next_train(i) for i in range(n)]
    if args.warm // interval != (n - 1) // interval:
        print("profile_step: the traced window holds an occupancy update", file=sys.stderr)
    for b in batches[: args.warm]:
        trainer.step(b)
    torch.cuda.synchronize()

    a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for b in batches[args.warm :]:
            trainer.step(b)
        z.record()
        torch.cuda.synchronize()
    step_ms = a.elapsed_time(z) / args.steps

    # device-side events, without the user-annotation spans (such as
    # Optimizer.step) that cover other kernels
    dev_events = [
        e for e in prof.events()
        if e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)
        and not e.name.startswith("Optimizer.")
    ]
    busy = _busy_ms(dev_events) / args.steps
    kern = {}
    for e in dev_events:
        k = kern.setdefault(e.name, [0.0, 0])
        k[0] += (e.time_range.end - e.time_range.start) / 1e3
        k[1] += 1
    total_dev = sum(v[0] for v in kern.values()) / args.steps
    rays = trainer.num_rays(batches[0])
    print(f"card: {card}")
    print(f"{label} step {step_ms:.3f} ms ({rays / step_ms * 1e3:.0f} rays/s) over "
          f"{args.steps} traced steps; device busy {busy:.3f} ms/step, idle share "
          f"{1 - busy / step_ms:.3f}; kernel time sum {total_dev:.3f} ms/step; "
          f"{len(dev_events) / args.steps:.0f} device events/step")
    names = {"encode_fwd_kernel": "K1", "encode_bwd_kernel": "K2", "ngp_fwd_kernel": "K7a",
             "ngp_bwd_kernel": "K7b"}
    for k, (t, c) in kern.items():
        for key, short in names.items():
            if key in k:
                print(f"  {short}: {t / args.steps:.4f} ms/step, {c / args.steps:.1f} launches/step")
    # the index kernels: the spline's knot gathers and, under evs_emb, the
    # appearance lookup (index_select forward, index_add backward)
    for k, (t, c) in kern.items():
        if "index" in k.lower():
            print(f"  index kernel {k[:70]}: {t / args.steps:.4f} ms/step, "
                  f"{c / args.steps:.1f} launches/step")
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])
    print("top device time per step:")
    for name, (t, c) in top[:15]:
        print(f"  {t / args.steps:8.4f} ms  {c / args.steps:6.1f}x  {name[:90]}")
    os.makedirs(args.out, exist_ok=True)
    name = "profile_step" if label == "flagship" else f"profile_step_{label}"
    with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
        f.write(f"card: {card}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(args.out, f"{name}_trace.json.gz"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
