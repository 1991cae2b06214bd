#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. the card's name and power limit, torch and CUDA versions; TF32 off;
  2. build the kernels (lsenerf_tpu_torch/csrc) with nvcc;
  3. hold K1 (blocked_encode_fwd) and K2 (blocked_encode_bwd) against their
     plain PyTorch versions at flagship shapes and time both; then one
     small train step on the card against the same step on the CPU through
     the plain versions;
  4. the flagship train step (flagship.py) for STEPS steps on the card, with
     every kernel launch counter set to 0 just before and read just after;
  5. a `kernels` JSON line, the card line, and the result line
     {"ok": true, "device": {...}} last.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 26  # the occupancy update runs at steps 0 and 16
TIMED_FROM = 17  # ms/step over steps 17..STEPS-1 (no occupancy update)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() over reps, each between CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def check_kernels(dev):
    """Phase 3a: K1/K2 against their plain versions at flagship shapes."""
    import torch

    from lsenerf_tpu_torch.flagship import flagship_model_config
    from lsenerf_tpu_torch.ops import combine
    from lsenerf_tpu_torch.ops import hash_encoding as he

    hcfg = flagship_model_config().field.hash
    lv = he.levels_for(hcfg, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    n = 3512 * 16  # rays x proposal samples per flagship step
    L = hcfg.num_levels
    pos = torch.rand((n, 3), generator=gen, device=dev)
    table = (torch.rand((hcfg.total_rows, 64), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    gfeat = torch.randn((n, L * combine.F), generator=gen, device=dev)

    out = combine.encode_fwd(pos, table, lv)
    want = combine.encode_fwd_plain(pos, table, lv)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    err1 = float((out - want).abs().max())
    dpos, dtab = combine.encode_bwd(pos, table, gfeat, lv)
    wdpos, wdtab = combine.encode_bwd_plain(pos, table, gfeat, lv)
    torch.cuda.synchronize()
    # dpos sums 16 level terms of up to ~1e3 (scale x dw) that cancel: a
    # summation-order error relative to the element is unbounded where they
    # do, so atol scales with the largest element, as dtable's does
    torch.testing.assert_close(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
    # atomics add in an order that changes from run to run
    torch.testing.assert_close(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))
    err2 = max(float((dpos - wdpos).abs().max()), float((dtab - wdtab).abs().max()))

    # the bound: bytes each function must move (inputs once, outputs once;
    # the table's rows counted as the distinct rows this input touches, 54
    # used bf16 values each) and its f32 operations, at the card's peaks
    keys = combine.keys_fracs(pos, lv)[0]
    rows = int(torch.unique(keys).numel())
    row_bytes = rows * 54 * 2
    m = n * L
    k1_bytes = n * 3 * 4 + row_bytes + m * combine.F * 4
    k1_ops = m * (3 * 4 + 9 + 27 + 27 * 2 * 2)  # fracs, weights, 54 FMAs
    k2_bytes = n * 3 * 4 + row_bytes + m * combine.F * 4 + n * 3 * 4 + hcfg.total_rows * 64 * 4
    k2_ops = m * (3 * 4 + 27 * 4 + 27 * 3 * 3 + 27 * 2 + 8 * 2 * 2 + 3 * 4)

    def bound(b, ops):
        tb, to = b / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    res = {}
    for k, err, fn, plain, (b_ms, b_by) in (
        (combine.K1, err1, lambda: combine.encode_fwd(pos, table, lv),
         lambda: combine.encode_fwd_plain(pos, table, lv), bound(k1_bytes, k1_ops)),
        (combine.K2, err2, lambda: combine.encode_bwd(pos, table, gfeat, lv),
         lambda: combine.encode_bwd_plain(pos, table, gfeat, lv), bound(k2_bytes, k2_ops)),
    ):
        res[k.name] = dict(
            max_abs_err=err, ms=time_ms(fn, 20), plain_ms=time_ms(plain, 5),
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        )
        r = res[k.name]
        print(f"{k.name}: max_abs_err {err:.3e}, {r['ms']:.4f} ms (plain "
              f"{r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}); "
              f"{rows} distinct rows at n={n}, L={L}")
    return res


def check_small_step(dev):
    """Phase 3b: one train step of a small configuration on the card (K1/K2)
    against the same step on the CPU (plain versions), in f32."""
    import numpy as np
    import torch

    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
    from lsenerf_tpu_torch.engine.trainer import CameraOptConfig, Trainer, TrainerConfig
    from lsenerf_tpu_torch.models import field as field_lib
    from lsenerf_tpu_torch.models import lsenerf as model_lib
    from lsenerf_tpu_torch.ops import hash_encoding as he
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    mcfg = model_lib.ModelConfig(
        field=field_lib.FieldConfig(hash=he.HashEncodingConfig(
            num_levels=6, base_res=4, max_res=128, blocked_rows_log2=10)),
        grid=occ_lib.OccGridConfig(resolution=32, levels=2),
        max_samples=16, max_candidates=256, proposal_samples=8,
    )
    cam = CameraOptConfig(mode="SO3xR3")
    jitter = torch.rand((2, 32, 32, 32), generator=torch.Generator().manual_seed(2))
    out, params, bg = {}, None, None
    for d in ("cpu", dev):
        col, evs = make_synthetic_scene(n_cams=6, h=16, w=16, focal=20.0)
        dm = MultiCamDataManager(DataManagerConfig(train_num_rays_per_batch=96), col, evs)
        tr = Trainer(TrainerConfig(col_cam_opt=cam, evs_cam_opt=cam), mcfg, dm, device=d)
        # fresh params from the seed on the CPU, the same ones on the card
        tr.setup(params=params, occ=occ_lib.init_occ_grid(mcfg.grid, d, jitter=jitter))
        params = tr.params
        batch = tr.batch_to_device(dm.next_train(0))
        if bg is None:
            bg = torch.rand((tr.num_rays(batch), 3), generator=torch.Generator().manual_seed(1))
        loss, _, grads = tr.grads(batch, bg_color=bg.to(d))
        out[d] = (float(loss.detach()), {p: g.detach().cpu() for p, g in grads.items()})
    (l0, g0), (l1, g1) = out["cpu"], out[dev]
    if not np.isfinite(l1) or abs(l1 - l0) > 1e-4 * abs(l0):
        fail(f"small step: loss on the card {l1} vs CPU {l0}")
    worst = 0.0
    for p, g in g0.items():
        rel = float((g1[p] - g).norm() / (g.norm() + 1e-12))
        worst = max(worst, rel)
        if rel > 1e-3:
            fail(f"small step: gradient {p} differs by {rel:.2e} (relative L2)")
    print(f"small step card vs CPU: loss {l1:.6f} vs {l0:.6f}, worst gradient "
          f"relative L2 difference {worst:.2e}")


def run_flagship(dev, card: str):
    """Phase 4: the flagship trainer for STEPS steps on the card."""
    import math

    import torch

    from lsenerf_tpu_torch.flagship import flagship_trainer
    from lsenerf_tpu_torch.ops import combine

    t0 = time.time()
    trainer = flagship_trainer(device=dev)
    batches = [trainer.dm.next_train(i) for i in range(STEPS)]
    print(f"flagship set-up {time.time() - t0:.1f} s; {trainer.model_config.field.hash.total_rows} "
          f"table rows, batch {trainer.num_rays(batches[0])} rays")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in combine.KERNELS:
        k.launches = 0
    metrics = []
    ev = {}
    for i, b in enumerate(batches):
        if i == TIMED_FROM:
            ev["a"] = torch.cuda.Event(enable_timing=True)
            ev["a"].record()
        metrics.append(trainer.step(b))
    ev["b"] = torch.cuda.Event(enable_timing=True)
    ev["b"].record()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in combine.KERNELS}
    ms = ev["a"].elapsed_time(ev["b"]) / (STEPS - TIMED_FROM)
    losses = [float(m["loss"]) for m in metrics]
    psnr = float(metrics[-1]["psnr"])
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(psnr):
        fail(f"non-finite flagship loss or psnr: {losses}, psnr {psnr}")
    n_occ = (STEPS + 15) // 16
    chunks = -(-trainer.model_config.grid.levels * 65536 // 131072)
    if launches["blocked_encode_fwd"] < STEPS + n_occ * chunks or launches["blocked_encode_bwd"] < STEPS:
        fail(f"kernel launch counts too low for {STEPS} steps: {launches}")
    rays = trainer.num_rays(batches[0])
    print(f"flagship: {STEPS} steps, loss {losses[0]:.5f} -> {losses[-1]:.5f}, psnr {psnr:.3f}, "
          f"samples/ray {float(metrics[-1]['num_samples_per_ray']):.2f}")
    print(f"flagship step: {ms:.3f} ms/step, {rays / ms * 1e3:.0f} rays/s over steps "
          f"{TIMED_FROM}..{STEPS - 1}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches} ({STEPS} steps, {n_occ} occupancy updates); {card}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    try:
        from lsenerf_tpu_torch.ops import combine
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}: {e}")

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.time()
    path, log = combine.build()
    print(f"kernels built in {time.time() - t0:.1f} s: {os.path.relpath(path, ROOT)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    res = check_kernels(dev)
    check_small_step(dev)
    launches = run_flagship(dev, card)

    kernels = []
    for k, src_line in ((combine.K1, 58), (combine.K2, 76)):
        kernels.append(dict(
            name=k.name, route="cuda", source="lsenerf_tpu_torch/csrc/blocked_encode.cu",
            replaces=f"lsenerf_tpu/ops/pallas_combine.py:{src_line}",
            launches=launches[k.name], **res[k.name],
        ))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
