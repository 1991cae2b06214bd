#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for sm_90a).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1):
  1. the card's name and power limit, torch and CUDA versions; TF32 off;
  2. build the kernels (lsenerf_tpu_torch/csrc/*.cu) with nvcc, one
     process per source, all started together;
  3. hold K1 (blocked_encode_fwd) and K2 (blocked_encode_bwd) against their
     plain PyTorch versions and time both, at three inputs: uniform random
     positions at the flagship's shape, and the positions and cotangent
     that K2 is given in one real flagship train step and in one real
     lsenerf_emb step (168,480 samples, 48 a ray) (3a), with K1's row loads
     and K2's atomics per launch as worked out from the designs; then small
     train steps on the card against the same steps on the CPU through the
     plain versions (3b): the flagship's model under `ns` deltas and under
     the production protocol's camera and loss (RGB spline + deblur x4)
     with SE3 event deltas; evs_rgb with an `rgb_mlp` mapper, the learned
     reducer, enerf_norm_loss and a white background; rgb_evs with
     `rgb_mlp`, denerf, the flat march and the last-sample background; and
     the mappers' identity pretrain on the card, timed;
  3c. the gather probe (lsenerf_tpu_torch/gather_probe.py: every case of
     scripts/pallas_probe*.py) on the card, with the gather kernels' launch
     counters set to 0 just before and read just after; then G1 (row_gather),
     G2 (take_along) and G3 (gather_sum) against their plain versions at the
     probes' shapes, each timed beside its plain version and the PyTorch
     call that computes the same function, with G3's L2 bytes per launch as
     worked out from its design;
  4. the flagship train step (flagship.py) for STEPS steps on the card, with
     K1's and K2's launch counters set to 0 just before and read just after;
  4b. the same for the production protocol's train step (flagship.py with
     production=True: RGB spline + deblur x4, 3510 rays), which must also
     move the spline's knots;
  4c. the same for the lsenerf_emb preset (flagship.preset_trainer: one
     appearance row per image, F=0, 3510 rays x 48 samples);
  4d. the same for the badnerf preset (RGB only, no mapping, 878 pixels x
     4 = 3512 rays);
  4e. the CLI path (lsenerf_tpu_torch.train.main, in process) on the
     reference scene at the real-scale profile (200 frames of 640x480 with
     prev/next event cameras, masks and the full trajectory): 200 steps of
     the headline protocol with every cadence, an exact resume from step 99
     (the restored state and one batch's loss equal the saved ones bit for
     bit), scripts/eval.sh's refinement and full eval (the field bit for bit
     unchanged, view 0's SSIM on the card within 1e-4 of the CPU's), and an
     lsenerf_emb run through scripts/emb_eval.sh's two stages (stage 1 moves
     only the test embedding; stage 2 finds stage 1's run by the script's
     rule); K1's and K2's counters are set to 0 before each stage;
  4f. scripts/parity.py --tiny through the same CLI (lsenerf_tpu_torch/
     parity.py): 1500 steps on the 64x64 golden scene at each of four
     seeds; the mean PSNR and SSIM must lie within parity.tiny_gate's
     three standard errors of the JAX package's own runs (the distance
     to scripts/golden_parity.json is printed beside them);
  5. a `kernels` JSON line (K1/K2 launches summed over phases 4 to 4f),
     the card line, and the result line {"ok": true, "device": {...}} last.

Every kernel and library call is timed three ways (lsenerf_tpu_torch/
timing.py): `ms`, the median of single calls between CUDA events, which
holds the wrapper's host time wherever that exceeds the kernel's;
`device_ms`, the card alone (20 calls captured in one CUDA graph, replayed
between CUDA events); `host_us`, the host's cost per call (400 calls
enqueued with no synchronise). The timing runs after the launch counters
are read, or before they are set to 0.

Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
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


def timings(fn, plain, library=None, reps=20, plain_reps=5):
    """ms (single calls between CUDA events), device_ms and host_us of fn,
    the plain version's ms, and the library call's ms, device_ms and
    host_us (None where there is no library call)."""
    from lsenerf_tpu_torch.timing import device_ms, host_us, time_ms

    r = dict(ms=time_ms(fn, reps), device_ms=device_ms(fn), host_us=host_us(fn),
             plain_ms=time_ms(plain, plain_reps))
    r["library_ms"] = r["library_device_ms"] = r["library_host_us"] = None
    if library is not None:
        r.update(library_ms=time_ms(library, reps), library_device_ms=device_ms(library),
                 library_host_us=host_us(library))
    return r


def fmt(r):
    s = (f"{r['ms']:.4f} ms per call, {r['device_ms']:.5f} ms on the device, "
         f"{r['host_us']:.1f} us of host per call")
    s += f"; plain {r['plain_ms']:.4f} ms"
    if r["library_ms"] is not None:
        s += (f"; library {r['library_ms']:.4f} ms, {r['library_device_ms']:.5f} ms on the "
              f"device, {r['library_host_us']:.1f} us of host")
    if r.get("bound_ms") is not None:
        s += f"; bound {r['bound_ms']:.5f} ms by {r['bound_by']}"
    return s


def atomics_per_launch(pos, lv):
    """K2's table-gradient atomics per launch on these inputs, worked out
    from the two designs, not measured. One thread per sample (the earlier K2):
    2 scalar atomics per vertex of nonzero weight, each its own L2 request.
    Lanes per level (this K2): each sample-level's 16 values go out as one
    entry, two entries per warp instruction, and one L2 request per 32-byte
    sector that an entry's values fall in. Returns (scalar atomics, warp
    instructions, sector requests)."""
    import torch

    from lsenerf_tpu_torch.ops import combine

    _, o, w = combine.keys_fracs(pos, lv)
    nonzero = torch.ones_like(w[0], dtype=torch.int64)
    for d in range(3):
        nonzero = nonzero * ((w[d] != 1.0).long() + (w[d] != 0.0).long())
    scalar = 2 * int(nonzero.sum())
    n = pos.shape[0]
    instructions = lv.num * (16 * (n // 32) + (n % 32 + 1) // 2)
    # sectors of one entry's 16 columns, by its parities (rows are 256-byte
    # aligned): columns 2v .. 2v+3 for v = ((ox+a)*3 + oy+b)*3 + oz
    sectors = torch.tensor([
        len({(2 * (((oc >> 2) + a) * 3 + ((oc >> 1) & 1) + b) * 3 + 2 * (oc & 1) + e) // 8
             for a in (0, 1) for b in (0, 1) for e in range(4)})
        for oc in range(8)], device=pos.device)
    requests = int(sectors[o[0] * 4 + o[1] * 2 + o[2]].sum())
    return scalar, instructions, requests


def k1_requests(pos, lv):
    """K1's L1 wavefronts and L2 sector requests per launch on these
    positions with a bf16 table, worked out from the two designs, not
    measured. A warp's load instruction costs one L1 wavefront per distinct
    128-byte line (one bf16 row) it touches; L1 keeps a line between the
    instructions of one warp that read it, and each distinct 32-byte
    sector of those lines is one L2 request. One thread per sample-level
    (K1 before this design): a warp on 32 consecutive sample-levels, 7
    16-byte loads each of its row's first 112 bytes (sectors 0-3). Groups
    of 4 lanes (this K1): two 4-byte load instructions on 8 neighbouring
    samples of one level, each reading a sample's 16 weighted values.
    Returns (wavefronts, sectors) before and now."""
    import torch

    from lsenerf_tpu_torch.ops import combine

    keys, o, _ = combine.keys_fracs(pos, lv)  # (L, n)
    L, n = keys.shape

    def distinct(groups):  # the distinct values in each row, summed
        s = groups.sort(dim=1).values
        return int(groups.shape[0] + (s[:, 1:] != s[:, :-1]).sum())

    def pad(x, g, dim):  # repeat the last entry along dim up to a multiple of g
        extra = -x.shape[dim] % g
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        return torch.cat([x, last.expand(*[extra if d == dim else -1 for d in range(x.dim())])], dim)

    old_rows = distinct(pad(keys.T.reshape(-1), 32, 0).reshape(-1, 32))
    new_rows = distinct(pad(keys, 8, 1).reshape(-1, 8))
    # the sectors of one sample's weighted words v0 + {0, 1, 3, 4, 9, 10, 12,
    # 13} (2 or 3 of the row's 4), by parities, padded to 3 with repeats
    table = []
    for oc in range(8):
        v0 = ((oc >> 2) * 3 + ((oc >> 1) & 1)) * 3 + (oc & 1)
        sec = sorted({(v0 + d) // 8 for d in (0, 1, 3, 4, 9, 10, 12, 13)})
        table.append(sec + sec[-1:] * (3 - len(sec)))
    sectors = torch.tensor(table, device=pos.device)[o[0] * 4 + o[1] * 2 + o[2]]  # (L, n, 3)
    codes = pad(keys[..., None] * 4 + sectors, 8, 1).reshape(L, -1, 24)
    return (7 * old_rows, 4 * old_rows), (2 * new_rows, distinct(codes.reshape(-1, 24)))


def g3_bytes(R, n, W):
    """G3's bytes per launch through L2, worked out from the design (not
    measured): every gathered row piece and every index once."""
    return R * n * W * 4 + R * n * 4


def encode_bounds(pos, lv):
    """The bounds of K1 and K2 on these positions: bytes each function must
    move (inputs once, outputs once; the table's rows counted as the
    distinct rows this input touches, 54 used bf16 values each; K2 writes
    the whole f32 gradient table) and its f32 operations, at the card's
    peaks. Returns (K1's, K2's, distinct rows)."""
    import torch

    from lsenerf_tpu_torch.ops import combine

    n, L = pos.shape[0], lv.num
    keys = combine.keys_fracs(pos, lv)[0]
    rows = int(torch.unique(keys).numel())
    row_bytes = rows * 54 * 2
    m = n * L
    k1_bytes = n * 3 * 4 + row_bytes + m * combine.F * 4
    k1_ops = m * (3 * 4 + 9 + 27 + 27 * 2 * 2)  # fracs, weights, 54 FMAs
    k2_bytes = n * 3 * 4 + row_bytes + m * combine.F * 4 + n * 3 * 4 + lv.total_rows * 64 * 4
    k2_ops = m * (3 * 4 + 27 * 4 + 27 * 3 * 3 + 27 * 2 + 8 * 2 * 2 + 3 * 4)
    return bound(k1_bytes, k1_ops), bound(k2_bytes, k2_ops), rows


def check_encode(name, pos, table, gfeat, lv):
    """K1 and K2 against their plain versions on one input, then timed.
    Returns {kernel name: result}."""
    import torch

    from lsenerf_tpu_torch.ops import combine

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
    dpos2, _ = combine.encode_bwd(pos, table, gfeat, lv)
    torch.cuda.synchronize()
    if not torch.equal(dpos, dpos2):
        fail(f"K2 at {name}: dpos differs between two calls on the same inputs")
    del out, want, dpos, dtab, wdpos, wdtab, dpos2

    (b1, b2, rows) = encode_bounds(pos, lv)
    scalar, instructions, requests = atomics_per_launch(pos, lv)
    res = {}
    for k, err, fn, plain, (b_ms, b_by) in (
        (combine.K1, err1, lambda: combine.encode_fwd(pos, table, lv),
         lambda: combine.encode_fwd_plain(pos, table, lv), b1),
        (combine.K2, err2, lambda: combine.encode_bwd(pos, table, gfeat, lv),
         lambda: combine.encode_bwd_plain(pos, table, gfeat, lv), b2),
    ):
        r = res[k.name] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                               **timings(fn, plain))
        print(f"{k.name} at {name}: max_abs_err {err:.3e}, {fmt(r)}; {rows} distinct "
              f"rows at n={pos.shape[0]}, L={lv.num}")
    print(f"K2 table-gradient atomics per launch at {name}, worked out from the designs (not "
          f"measured): one thread per sample, {scalar} scalar atomics ({scalar} L2 requests); "
          f"lanes per level, {instructions} warp instructions ({requests} L2 sector requests)")
    (w0, s0), (w1, s1) = k1_requests(pos, lv)
    print(f"K1 row loads per launch at {name}, worked out from the designs (not measured): one "
          f"thread per sample-level, {w0} L1 wavefronts and {s0} L2 sector requests; groups of 4 "
          f"lanes, {w1} L1 wavefronts and {s1} L2 sector requests "
          f"({w1 / pos.shape[0] / lv.num:.2f} and {s1 / pos.shape[0] / lv.num:.2f} per sample-level)")
    return res


def check_kernels(dev):
    """Phase 3a: K1/K2 against their plain versions at the flagship's shape,
    on uniform random positions, on one real flagship step's inputs and on
    one real lsenerf_emb step's (48 samples a ray). Returns the uniform
    shape's results, with the steps' under "shapes" ("step", "step_emb")."""
    import torch

    from lsenerf_tpu_torch.flagship import flagship_model_config, step_encode_inputs
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
    res = check_encode("uniform positions", pos, table, gfeat, lv)
    del pos, table, gfeat

    t0 = time.time()
    spos, stable, sgfeat, slv = step_encode_inputs(dev)
    print(f"one flagship step for K2's inputs: {time.time() - t0:.1f} s, n={spos.shape[0]}")
    step = check_encode("one flagship step's inputs", spos, stable, sgfeat, slv)
    del spos, stable, sgfeat
    t0 = time.time()
    epos, etable, egfeat, elv = step_encode_inputs(dev, preset="lsenerf_emb")
    print(f"one lsenerf_emb step for K2's inputs: {time.time() - t0:.1f} s, n={epos.shape[0]}")
    if epos.shape[0] != 3510 * 48:
        fail(f"an lsenerf_emb step gave K2 {epos.shape[0]} samples, not 3510 x 48")
    emb = check_encode("one lsenerf_emb step's inputs", epos, etable, egfeat, elv)
    for k in res:
        res[k]["shapes"] = {"step": step[k], "step_emb": emb[k]}
    return res


def bound(nbytes, ops):
    """The least time for the work: the larger of bytes over the memory rate
    and f32 operations over the peak f32 rate, in ms, and which bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# the flagship's model modes, which the small steps change by `model`
FLAGSHIP_MODES = dict(use_mapping=True, map_mode="co_map", mapping_method="identity",
                      evs_mapping_method="powpow", ev_one_dim="gt")


def check_small_step(dev, label, col_cam, evs_cam, deblur=False, model=None):
    """Phase 3b: one train step of a small configuration on the card (K1/K2)
    against the same step on the CPU (plain versions), in f32, with the
    given camera optimizers (CameraOptConfig), with `deblur` deblur x4 RGB
    rays, and the flagship's model modes updated by `model` (ModelConfig
    fields). A mapper MLP is pretrained on the CPU and moved to the card."""
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
        rgb_loss_type="deblur" if deblur else "linspace", **dict(FLAGSHIP_MODES, **(model or {})),
    )
    dmc = DataManagerConfig(train_num_rays_per_batch=96, rgb_loss_mode="deblur" if deblur else "mse")
    jitter = torch.rand((2, 32, 32, 32), generator=torch.Generator().manual_seed(2))
    out, params, bg = {}, None, None
    for d in ("cpu", dev):
        col, evs = make_synthetic_scene(n_cams=6, h=16, w=16, focal=20.0)
        dm = MultiCamDataManager(dmc, col, evs)
        tr = Trainer(TrainerConfig(col_cam_opt=col_cam, evs_cam_opt=evs_cam), mcfg, dm, device=d)
        # fresh params from the seed on the CPU, the same ones on the card
        tr.setup(params=params, occ=occ_lib.init_occ_grid(mcfg.grid, d, jitter=jitter))
        params = tr.params
        batch = tr.batch_to_device(dm.next_train(0))
        if bg is None and mcfg.background_color == "random":
            bg = torch.rand((tr.num_rays(batch), 3), generator=torch.Generator().manual_seed(1))
        loss, _, grads = tr.grads(batch, bg_color=None if bg is None else bg.to(d))
        out[d] = (float(loss.detach()), {p: g.detach().cpu() for p, g in grads.items()})
    (l0, g0), (l1, g1) = out["cpu"], out[dev]
    if not np.isfinite(l1) or abs(l1 - l0) > 1e-4 * abs(l0):
        fail(f"small step ({label}): loss on the card {l1} vs CPU {l0}")
    worst = 0.0
    for p, g in g0.items():
        rel = float((g1[p] - g).norm() / (g.norm() + 1e-12))
        worst = max(worst, rel)
        if rel > 1e-3:
            fail(f"small step ({label}): gradient {p} differs by {rel:.2e} (relative L2)")
    print(f"small step ({label}) card vs CPU: loss {l1:.6f} vs {l0:.6f}, worst gradient "
          f"relative L2 difference {worst:.2e} over {len(g0)} leaves")


def check_pretrain(dev):
    """Phase 3b: the mappers' identity pretrain (5000 Adam steps of a 4 x 16
    MLP) on the card and on the CPU, timed, each from its device's
    generator: each fit within 0.05 of the identity on the 100-point
    linspace. Fits drift apart chaotically with rounding, as torch's and
    optax's do (tests/test_torch_mappers_losses.py), and land 0.010-0.035
    from it."""
    import torch

    from lsenerf_tpu_torch.models import mappers as mapper_lib

    x = torch.linspace(0, 1, 100)[:, None]
    for name, d in (("mlp", 1), ("rgb_mlp", 3)):
        for dv in (dev, "cpu"):
            torch.cuda.synchronize()
            t0 = time.time()
            fit = mapper_lib.init_mapper(name, torch.Generator(device=dv).manual_seed(0), dv)
            torch.cuda.synchronize()
            secs = time.time() - t0
            err = float((mapper_lib.apply_mapper(name, fit, x.expand(100, d).to(dv)).cpu()
                         - x).abs().max())
            if not err < 0.05:
                fail(f"{name} pretrain on {dv}: {err} from the identity")
            print(f"{name} identity pretrain on {dv}: {secs:.2f} s for {mapper_lib.PRETRAIN_STEPS} "
                  f"steps, max |fit - identity| {err:.4f} on the linspace")


def check_gathers(dev):
    """Phase 3c: the gather probe on the card, then G1-G3 against their plain
    versions and library calls at the probes' shapes. Returns the per-kernel
    results and the launch counts of the probe's run."""
    import itertools

    import torch
    import torch.nn.functional as tF

    from lsenerf_tpu_torch import gather_probe
    from lsenerf_tpu_torch.ops import gather as g

    t0 = time.time()
    for k in g.KERNELS:
        k.launches = 0
    cases = gather_probe.run(dev)
    launches = {k.name: k.launches for k in g.KERNELS}
    wrong = [c["name"] for c in cases if not c["ok"]]
    if wrong:
        fail(f"gather probe: WRONG {wrong}")
    if min(launches.values()) == 0:
        fail(f"gather probe: a kernel was never launched: {launches}")
    print(f"gather probe: {len(cases)}/{len(cases)} cases OK in {time.time() - t0:.1f} s; "
          f"launches {launches}")

    gen = torch.Generator(device=dev).manual_seed(0)

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev, dtype=torch.int32)

    def exact(name, got, want):
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            fail(f"{name}: kernel and plain version differ")
        return float((got.float() - want.float()).abs().max())

    def distinct(idx):
        return int(torch.unique(idx).numel())

    res = {}

    # G1 at P5-C: the flagship's 2,697,216 row gathers from a 199,680 x 64
    # bf16 table, with a fresh index each launch
    T, W, m = 199680, 64, gather_probe.P5_FLAGSHIP_ROWS
    table = torch.randn((T, W), generator=gen, device=dev).to(torch.bfloat16)
    idxs = [ints(T, (m,)) for _ in range(12)]
    err = exact("row_gather", g.row_gather(table, idxs[0]), g.row_gather_plain(table, idxs[0]))
    fresh = itertools.cycle(idxs)
    res["row_gather"] = dict(
        max_abs_err=err, **timings(lambda: g.row_gather(table, next(fresh)),
                                   lambda: g.row_gather_plain(table, next(fresh)),
                                   lambda: torch.index_select(table, 0, next(fresh)),
                                   reps=10, plain_reps=10))
    res["row_gather"]["bound_ms"], res["row_gather"]["bound_by"] = bound(
        m * 4 + m * W * 2 + distinct(idxs[0]) * W * 2, 0)
    print(f"row_gather at P5-C: max_abs_err {err:.3e}, {fmt(res['row_gather'])}")
    del idxs, fresh

    # G2 at E2 (axis 0, the row index broadcast over 128 columns), M3 (axis
    # 1) and R1 (the roll by 64 lanes); E2's numbers head the kernels line
    R = 2048
    t_e2 = torch.randn((R, 128), generator=gen, device=dev)
    i_e2 = ints(R, (R, 1)).expand(R, 128).contiguous()
    t_m3 = torch.randn((1024, 128), generator=gen, device=dev)
    i_m3 = ints(128, (1024, 128))
    t_r1 = torch.randn((8, 128), generator=gen, device=dev)
    i_r1 = ((torch.arange(128, device=dev) - 64) % 128).int().expand(8, 128).contiguous()
    shapes = {}
    for name, t, idx, axis in (("E2", t_e2, i_e2, 0), ("M3", t_m3, i_m3, 1), ("R1", t_r1, i_r1, 1)):
        err = exact(f"take_along {name}", g.take_along(t, idx, axis),
                    g.take_along_plain(t, idx, axis))
        idx64 = idx.long()
        if name == "R1":
            exact("take_along R1", g.take_along(t, idx, axis), torch.roll(t, 64, 1))
            library = lambda t=t: torch.roll(t, 64, 1)  # noqa: E731
        else:
            library = lambda t=t, axis=axis, idx64=idx64: torch.gather(t, axis, idx64)  # noqa: E731
        rows, cols = torch.arange(t.shape[0], device=dev)[:, None], torch.arange(t.shape[1], device=dev)
        touched = idx64 * t.shape[1] + cols if axis == 0 else rows * t.shape[1] + idx64
        r = shapes[name] = dict(max_abs_err=err, **timings(
            lambda t=t, idx=idx, axis=axis: g.take_along(t, idx, axis),
            lambda t=t, idx=idx, axis=axis: g.take_along_plain(t, idx, axis),
            library, plain_reps=20))
        # the index read and the output written (4 bytes each), and each
        # element of t that the index touches read once
        r["bound_ms"], r["bound_by"] = bound(idx.numel() * 8 + distinct(touched) * 4, 0)
        lib_name = "torch.roll" if name == "R1" else "torch.gather"
        print(f"take_along {name} {tuple(t.shape)} axis {axis} ({lib_name} as the library): {fmt(r)}")
    res["take_along"] = dict(shapes.pop("E2"), shapes=shapes)

    # G3 at H: 64 gathers of 8192 rows from 8192 x 128 f32, summed in order
    TH, WH, REPS, NH = 8192, 128, 64, 8192
    th = torch.randn((TH, WH), generator=gen, device=dev)
    ih = ints(TH, (REPS, NH))
    want = g.gather_sum_plain(th, ih)
    err = exact("gather_sum", g.gather_sum(th, ih), want)
    bags = ih.T.contiguous().long()
    # embedding_bag sums in another order: two sums of the same R terms
    # differ by at most 2 * (R - 1) * 2^-24 * sum|x|
    lib = tF.embedding_bag(bags, th, mode="sum")
    atol = 2 * REPS * 2.0**-24 * float(g.gather_sum_plain(th.abs(), ih).max())
    torch.testing.assert_close(lib, want, rtol=0, atol=atol)
    del want, lib
    r = res["gather_sum"] = dict(max_abs_err=err, **timings(
        lambda: g.gather_sum(th, ih), lambda: g.gather_sum_plain(th, ih),
        lambda: tF.embedding_bag(bags, th, mode="sum"), plain_reps=10))
    r["bound_ms"], r["bound_by"] = bound(
        ih.numel() * 4 + NH * WH * 4 + distinct(ih) * WH * 4, REPS * NH * WH)
    print(f"gather_sum at H: max_abs_err {err:.3e}, {fmt(r)}")
    print(f"gather_sum at H per launch, worked out from the design (not measured): "
          f"{g3_bytes(REPS, NH, WH) / 1e6:.1f} MB from L2")

    rows_per_s = m / (res["row_gather"]["ms"] * 1e-3)
    print(f"row_gather at P5-C: {rows_per_s:.4e} rows/s; gather phase {time.time() - t0:.1f} s")
    return res, launches


def run_path(dev, card: str, label: str, make):
    """Phases 4-4d: the trainer `make(device)` builds for STEPS steps on the
    card. Returns K1's and K2's launches in the run."""
    import math

    import torch

    from lsenerf_tpu_torch.ops import combine

    t0 = time.time()
    trainer = make(dev)
    batches = [trainer.dm.next_train(i) for i in range(STEPS)]
    print(f"{label} set-up {time.time() - t0:.1f} s; {trainer.model_config.field.hash.total_rows} "
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
        fail(f"non-finite {label} loss or psnr: {losses}, psnr {psnr}")
    n_occ = (STEPS + 15) // 16
    chunks = -(-trainer.model_config.grid.levels * 65536 // 131072)
    if launches["blocked_encode_fwd"] < STEPS + n_occ * chunks or launches["blocked_encode_bwd"] < STEPS:
        fail(f"{label}: kernel launch counts too low for {STEPS} steps: {launches}")
    rays = trainer.num_rays(batches[0])
    print(f"{label}: {STEPS} steps, loss {losses[0]:.5f} -> {losses[-1]:.5f}, psnr {psnr:.3f}, "
          f"samples/ray {float(metrics[-1]['num_samples_per_ray']):.2f}")
    if trainer.config.col_cam_opt.optim_type == "spline":
        # gradients reached the knots on the card: they left their init
        drift = [float(metrics[-1][f"camera_opt_{k}_col"]) for k in ("translation", "rotation")]
        if not all(math.isfinite(x) and x > 0 for x in drift):
            fail(f"{label}: spline knot drift {drift} after {STEPS} steps")
        print(f"{label}: spline knot drift after {STEPS} steps: translation {drift[0]:.3e}, "
              f"rotation {drift[1]:.3e}")
    print(f"{label} step: {ms:.3f} ms/step, {rays / ms * 1e3:.0f} rays/s over steps "
          f"{TIMED_FROM}..{STEPS - 1}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches} ({STEPS} steps, {n_occ} occupancy updates); {card}")
    return launches


# scripts/golden_real_scale.py's headline protocol (scripts/train_lse_data.sh)
HEADLINE = [
    "--machine.seed", "96",
    "--pipeline.datamanager.rgb_frac", "0.66",
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
# scripts/eval.sh's and scripts/emb_eval.sh's flags besides the loads
EVAL_FLAGS = [
    "--steps-per-eval-image", "10000", "--is_eval", "True",
    "--pipeline.datamanager.col-dataparser.image-type", "clear",
    "--pipeline.datamanager.col-dataparser.quality", "",
]


def leaves(tree, prefix=""):
    """{path: tensor on the CPU} of a nested dict of tensors."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(leaves(v, path) if isinstance(v, dict) else {path: v.detach().cpu().clone()})
    return out


def trainer_state(trainer) -> dict:
    """Everything a checkpoint holds, copied to the CPU."""
    return dict(params=leaves(trainer.params), adam=trainer.adam_state(),
                opt_count=trainer.opt_count, step_count=trainer.step_count,
                occs=trainer.occ.occs.cpu().clone(), binaries=trainer.occ.binaries.cpu().clone(),
                rng=trainer._gen.get_state().clone())


def fixed_batch_loss(trainer) -> float:
    """The loss of one batch that the run's sampler never draws (its own
    sampler seed) with a fixed background: a forward pass only, whose K1
    launch is a check's and is left out of the launch counts."""
    import torch

    from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager
    from lsenerf_tpu_torch.ops import combine

    counts = [k.launches for k in combine.KERNELS]
    dm = MultiCamDataManager(trainer.dm.config, trainer.dm.col, trainer.dm.evs, seed=1234)
    batch = trainer.batch_to_device(dm.next_train(0))
    gen = torch.Generator(device=trainer.device).manual_seed(5)
    bg = torch.rand((trainer.num_rays(batch), 3), generator=gen, device=trainer.device)
    with torch.no_grad():
        loss, _ = trainer.loss_fn(trainer.params, trainer.occ, batch, trainer.step_count, bg)
    for k, n in zip(combine.KERNELS, counts):
        k.launches = n
    return float(loss)


def same_state(a: dict, b: dict) -> list:
    """The entries of two trainer_state()s that differ, bit for bit."""
    import torch

    bad = [k for k in ("opt_count", "step_count") if a[k] != b[k]]
    bad += [k for k in ("occs", "binaries", "rng") if not torch.equal(a[k], b[k])]
    if set(a["params"]) != set(b["params"]):
        bad.append("params keys")
    bad += [p for p in a["params"] if p in b["params"] and not torch.equal(a["params"][p], b["params"][p])]
    if set(a["adam"]) != set(b["adam"]):
        bad.append("adam keys")
    bad += [f"adam {p} {k}" for p in a["adam"] if p in b["adam"] for k in a["adam"][p]
            if not torch.equal(a["adam"][p][k], b["adam"][p][k])]
    return bad


class CliProbe:
    """Hooks around the port's own functions for one `train.main` call,
    restored when it ends. It records a CUDA event as each train step
    starts and the step's loss; hands the loop's trainer to `before` and
    `after` (called around the training loop); snapshots the trainer's state
    and a fixed batch's loss when the loop saves step `snapshot_step`; and
    keeps the first SSIM call's inputs and result."""

    def __init__(self, before=None, after=None, snapshot_step=None):
        self.before, self.after, self.snapshot_step = before, after, snapshot_step
        self.events, self.losses, self.snapshot, self.ssim = [], [], None, None

    def __enter__(self):
        import torch

        from lsenerf_tpu_torch.engine import checkpoints, loop
        from lsenerf_tpu_torch.engine.trainer import Trainer
        from lsenerf_tpu_torch.ops import metrics

        probe = self
        step0, loop0, save0, ssim0 = (Trainer.step, loop.run_training_loop,
                                      checkpoints.save_checkpoint, metrics.ssim)
        self._restore = [(Trainer, "step", step0), (loop, "run_training_loop", loop0),
                         (checkpoints, "save_checkpoint", save0), (metrics, "ssim", ssim0)]

        def step(trainer, batch, bg_color=None):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            probe.events.append((trainer.step_count, ev))
            out = step0(trainer, batch, bg_color)
            probe.losses.append(out["loss"])
            return out

        def run_loop(trainer, **kw):
            if probe.before is not None:
                probe.before(trainer)
            out = loop0(trainer, **kw)
            if probe.after is not None:
                probe.after(trainer)
            return out

        def save(ckpt_dir, step, trainer):
            if step == probe.snapshot_step and probe.snapshot is None:
                probe.snapshot = (trainer_state(trainer), fixed_batch_loss(trainer))
            return save0(ckpt_dir, step, trainer)

        def ssim(gt, pred, *a, **k):
            out = ssim0(gt, pred, *a, **k)
            if probe.ssim is None:
                probe.ssim = (gt.detach().cpu().clone(), pred.detach().cpu().clone(), float(out))
            return out

        Trainer.step, loop.run_training_loop = step, run_loop
        checkpoints.save_checkpoint, metrics.ssim = save, ssim
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._restore:
            setattr(obj, name, fn)
        return False

    def step_ms(self, skip: set) -> list:
        """ms of each train step i (its start to the next one's) for the
        steps after the first 16 that run no occupancy update (i % 16) and
        are not in `skip` (steps followed by an eval or a save)."""
        out = []
        for (i, a), (_, b) in zip(self.events, self.events[1:]):
            if i >= 16 and i % 16 and i not in skip:
                out.append(a.elapsed_time(b))
        return out


@contextlib.contextmanager
def torch_defaults():
    """cuDNN's TF32 back at PyTorch's default (on), as a user's process
    has it, for the CLI phases: the eval's SSIM must not depend on phase
    1's switch."""
    import torch

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def launches_run(fn):
    """fn() with K1's and K2's launch counters set to 0 just before and read
    just after: (result, {kernel name: launches}, wall seconds)."""
    import torch

    from lsenerf_tpu_torch.ops import combine

    for k in combine.KERNELS:
        k.launches = 0
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in combine.KERNELS}, time.time() - t0


def eval_mean(run_dir: str, keys=("psnr", "ssim", "num_rays_per_sec", "fps")) -> dict:
    """The run's eval_mean.json; every key in `keys` must be finite."""
    import math

    path = os.path.join(run_dir, "eval_mean.json")
    if not os.path.exists(path):
        fail(f"{run_dir} has no eval_mean.json")
    with open(path) as f:
        means = json.load(f)
    bad = [k for k in keys if not math.isfinite(means.get(k, float("nan")))]
    if bad:
        fail(f"{path}: {bad} missing or not finite: {means}")
    return means


def cli_path(card: str, steps=(200, 100, 60, 100, 30, 60), scene=None, device_flag=()):
    """Phase 4e: the CLI path (lsenerf_tpu_torch.train.main, in process) on
    the reference scene at the real-scale profile of
    scripts/golden_real_scale.py: train with the headline protocol and its
    cadences, resume exactly from the middle checkpoint, the eval.sh
    protocol, and an lsenerf_emb run through emb_eval.sh's two stages.
    `steps`: train, resume, eval.sh, emb train, emb stage 1, emb stage 2.
    Returns K1's and K2's launches summed over the stages."""
    import math
    import statistics
    import tempfile

    import torch

    from lsenerf_tpu_torch import train
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig
    from lsenerf_tpu_torch.data.synthetic import write_reference_scene
    from lsenerf_tpu_torch.ops import metrics

    n_train, n_resume, n_eval, n_emb, n_pre, n_post = steps
    scene = scene or dict(n_cams=200, h=480, w=640, focal=0.9 * 640, n_val=4, texture_freq=24.0)
    total = {}
    peak = 0

    def stage(label, argv, probe):
        nonlocal peak
        torch.cuda.reset_peak_memory_stats()
        with probe:
            run_dir, launches, secs = launches_run(lambda: train.main(list(argv) + list(device_flag)))
        peak = max(peak, torch.cuda.max_memory_allocated())
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if min(launches.values()) == 0:
            fail(f"{label}: a kernel was never launched: {launches}")
        bad = [i for i, l in enumerate(probe.losses) if not math.isfinite(float(l))]
        if bad or not probe.losses:
            fail(f"{label}: {len(probe.losses)} steps, non-finite loss at {bad[:5]}")
        print(f"{label}: {secs:.1f} s wall, {len(probe.losses)} steps, launches {launches}; {card}")
        return run_dir

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as work, torch_defaults():
        data = os.path.join(work, "scene")
        t0 = time.time()
        write_reference_scene(data, with_prevnext=True, with_msk=True, with_full_camera=True, **scene)
        print(f"4e scene: {scene['n_cams']} frames of {scene['w']}x{scene['h']} written in "
              f"{time.time() - t0:.1f} s; {card}")

        # train, saving the middle step's state for the resume
        mid = n_train // 2 - 1
        train_argv = ["lsenerf", "--data", data, "--output-dir", os.path.join(work, "run"),
                      "--max-num-iterations", str(n_train)] + HEADLINE
        cadence = ["--steps-per-save", str(n_train // 2), "--steps-per-eval-batch", str(n_train // 2),
                   "--steps-per-eval-image", str(n_train // 2),
                   "--steps-per-eval-all-images", str(n_train)]
        probe = CliProbe(snapshot_step=mid)
        run = stage("4e train", train_argv + cadence, probe)
        if probe.snapshot is None:
            fail(f"4e train: no checkpoint at step {mid}")
        ms = probe.step_ms(skip={i for i in range(n_train) if (i + 1) % (n_train // 2) == 0})
        means = eval_mean(run)
        # rays a step: deblur's 4 RGB rays a pixel and the prev and next event rays
        dmc = DataManagerConfig(rgb_frac=0.66, rgb_loss_mode="deblur")
        rays = 4 * dmc.train_num_col_rays_per_batch + 2 * dmc.train_num_evs_rays_per_batch
        step_ms = statistics.median(ms)
        print(f"4e train step (untraced, CUDA events, {len(ms)} steps with no occupancy update or "
              f"cadence): median {step_ms:.3f} ms/step, mean {statistics.mean(ms):.3f}, min "
              f"{min(ms):.3f}, max {max(ms):.3f}; {rays} rays a step, "
              f"{rays / step_ms * 1e3:.0f} rays/s; {card}")
        print(f"4e train eval_mean.json ({n_train} steps, {scene['w']}x{scene['h']}): "
              f"{json.dumps(means)}; {card}")

        # exact resume from the middle checkpoint
        saved, saved_loss = probe.snapshot
        del probe
        checks = {}

        def check_restore(t):
            bad = same_state(saved, trainer_state(t))
            if bad:
                fail(f"4e resume: the restored state differs from the saved one: {bad[:8]}")
            loss = fixed_batch_loss(t)
            if loss != saved_loss:
                fail(f"4e resume: fixed-batch loss {loss!r} after the restore, {saved_loss!r} saved")
            checks["resume"] = loss

        ckpt = os.path.join(run, "checkpoints", f"step-{mid:09d}")
        stage("4e resume", ["lsenerf", "--data", data, "--output-dir", os.path.join(work, "resume"),
                            "--max-num-iterations", str(n_resume), "--load-checkpoint", ckpt]
              + HEADLINE + cadence, CliProbe(before=check_restore))
        print(f"4e resume from step {mid}: params, Adam moments and count, step, occupancy grid "
              f"and generator bit for bit; fixed-batch loss {checks['resume']!r} equal bit for bit")
        del saved

        # the eval.sh protocol: camera refinement on the frozen field, then the full eval
        final = torch.load(os.path.join(run, "checkpoints", f"step-{n_train - 1:09d}"),
                           map_location="cpu", weights_only=True)["params"]["model"]
        field = leaves(final, "model")

        def check_frozen(t):
            now = leaves(t.params)
            bad = [p for p in field if not torch.equal(now.get(p, torch.empty(0)), field[p])]
            extra = [p for p in now if p.startswith("model/") and p not in field]
            if bad or extra:
                fail(f"4e eval.sh: field leaves moved or appeared: {(bad + extra)[:8]}")
            cam = now["camera_opt/col/pose_adjustment"]
            if not float(cam.abs().max()) > 0:
                fail("4e eval.sh: the eval cameras' pose deltas did not move")
            checks["cam"] = float(cam.norm())

        probe = CliProbe(after=check_frozen)
        ev_run = stage("4e eval.sh", [
            "lsenerf", "--max-num-iterations", str(n_eval),
            "--load-dir", os.path.join(run, "checkpoints"), "--load-config", os.path.join(run, "config.yml"),
            "--emb_eval_mode", "zero", "--pipeline.model.eval-num-rays-per-chunk", "4096",
        ] + EVAL_FLAGS, probe)
        ev_means = eval_mean(ev_run)
        gt, pred, card_ssim = probe.ssim
        cpu_ssim = float(metrics.ssim(gt, pred))
        if not abs(card_ssim - cpu_ssim) <= 1e-4:
            fail(f"4e eval.sh: SSIM of view 0 on the card {card_ssim} vs the CPU {cpu_ssim}")
        print(f"4e eval.sh ({n_eval} refinement steps, field bit for bit unchanged, pose deltas' "
              f"norm {checks['cam']:.3e}): {json.dumps(ev_means)}; view 0 SSIM card {card_ssim:.6f} "
              f"vs CPU {cpu_ssim:.6f}; {card}")

        # emb_eval.sh: an lsenerf_emb run, then its two stages
        emb = stage("4e lsenerf_emb train", [
            "lsenerf", "--data", data, "--output-dir", os.path.join(work, "emb"),
            "--max-num-iterations", str(n_emb), "--steps-per-save", str(n_emb),
            "--steps-per-eval-batch", "100000", "--steps-per-eval-image", "100000",
            "--steps-per-eval-all-images", "100000",
            "--pipeline.model.embed-config.embedding-type", "evs_emb"] + HEADLINE, CliProbe())
        snap = {}

        def only_test_table(t):
            now = leaves(t.params)
            moved = sorted(p for p in now if not torch.equal(now[p], snap["pre"][p]))
            if moved != ["model/field/appearance/test_table"]:
                fail(f"4e emb_eval stage 1: moved {moved[:8]}, not the test embedding alone")
            snap["table"] = now["model/field/appearance/test_table"]

        stage("4e emb_eval stage 1", [
            "lsenerf", "--max-num-iterations", str(n_pre),
            "--load-dir", os.path.join(emb, "checkpoints"), "--load-config", os.path.join(emb, "config.yml"),
            "--emb_eval_mode", "param", "--do_pretrain", "True",
            "--pipeline.model.eval-num-rays-per-chunk", "2048"] + EVAL_FLAGS,
            CliProbe(before=lambda t: snap.setdefault("pre", leaves(t.params)), after=only_test_table))
        # the script's own rule: the newest entry of ${EXP_PATH}_eval_param
        # that is not itself an _eval_param run
        param_path = emb + "_eval_param"
        last = sorted(d for d in os.listdir(param_path) if "_eval_param" not in d)[-1]
        full_dir = os.path.join(param_path, last)

        def grafted(t):
            if not torch.equal(leaves(t.params)["model/field/appearance/test_table"], snap["table"]):
                fail("4e emb_eval stage 2: the test embedding is not stage 1's")

        post = stage("4e emb_eval stage 2", [
            "lsenerf", "--max-num-iterations", str(n_post), "--emb_eval_mode", "param",
            "--load-dir", os.path.join(full_dir, "checkpoints"),
            "--load-config", os.path.join(full_dir, "config.yml"),
            "--pipeline.model.eval-num-rays-per-chunk", "2048"] + EVAL_FLAGS, CliProbe(before=grafted))
        post_means = eval_mean(post)
        print(f"4e emb_eval.sh ({n_pre} + {n_post} steps; stage 1 moved only the test embedding, "
              f"stage 2 found {os.path.relpath(full_dir, work)} by the script's rule): "
              f"{json.dumps(post_means)}; {card}")
    print(f"4e peak memory {peak / 2**30:.2f} GiB; launches {total}; {card}")
    return total


def tiny_golden(card: str, device=None):
    """Phase 4f: scripts/parity.py --tiny through the port's CLI
    (lsenerf_tpu_torch/parity.py): the 64x64 golden scene, 1500 steps at
    each of parity.TINY_SEEDS, an eval of every view at 1500. The mean
    PSNR and SSIM must pass parity.tiny_gate; the distance to the golden
    is printed. Returns K1's and K2's launches."""
    import tempfile

    from lsenerf_tpu_torch import parity

    with open(os.path.join(ROOT, "scripts", "golden_parity.json")) as f:
        golden = json.load(f)["metrics"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_golden_") as work, torch_defaults():
        runs, launches, secs = launches_run(
            lambda: [parity.run(work, seed, device=device) for seed in parity.TINY_SEEDS])
    if min(launches.values()) == 0:
        fail(f"4f tiny golden: a kernel was never launched: {launches}")
    for seed, r in zip(parity.TINY_SEEDS, runs):
        print(f"4f tiny golden, seed {seed}: psnr {r['psnr']:.4f}, ssim {r['ssim']:.4f}")
    gate = parity.tiny_gate(runs)
    d = {k: gate[k][0] - golden[k] for k in ("psnr", "ssim")}
    print(f"4f tiny golden: {len(runs)} x 1500 steps in {secs:.1f} s wall (scene written and "
          f"parsed); {parity.gate_line(gate)}; the means lie {d['psnr']:+.4f} dB / "
          f"{d['ssim']:+.4f} from scripts/golden_parity.json's {golden['psnr']:.4f} / "
          f"{golden['ssim']:.4f}; launches {launches}; {card}")
    if not all(g[3] for g in gate.values()):
        fail(f"4f tiny golden: outside parity.tiny_gate: {parity.gate_line(gate)}")
    return launches


def main() -> int:
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    try:
        from lsenerf_tpu_torch.ops import combine, cuda_build
        from lsenerf_tpu_torch.ops import gather
    except ImportError as e:
        fail(f"the port is not importable from {ROOT}: {e}")

    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.time()
    built = cuda_build.build_all()
    print(f"kernels built in {time.time() - t0:.1f} s ({len(built)} sources, in parallel)")
    for path, log in built.values():
        print(f"  {os.path.relpath(path, ROOT)}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    from lsenerf_tpu_torch.engine.trainer import CameraOptConfig

    from lsenerf_tpu_torch.flagship import flagship_trainer, preset_trainer

    res = check_kernels(dev)
    so3 = CameraOptConfig(mode="SO3xR3")
    check_small_step(dev, "ns SO3xR3", so3, so3)
    check_small_step(dev, "spline + deblur, SE3 event deltas",
                     CameraOptConfig(mode="SO3xR3", optim_type="spline"), CameraOptConfig(mode="SE3"),
                     deblur=True)
    check_small_step(dev, "evs_rgb, rgb_mlp, learned reducer, enerf_norm_loss, white", so3, so3,
                     model=dict(map_mode="evs_rgb", mapping_method="rgb_mlp", evs_mapping_method=None,
                                ev_one_dim="learned", event_loss_type="enerf_norm_loss",
                                background_color="white"))
    check_small_step(dev, "rgb_evs, rgb_mlp, denerf, flat march, last_sample", so3, so3,
                     model=dict(map_mode="rgb_evs", mapping_method="rgb_mlp", evs_mapping_method=None,
                                ev_one_dim=None, event_loss_type="denerf",
                                background_color="last_sample", hierarchical_march=False))
    check_pretrain(dev)
    g_res, g_launches = check_gathers(dev)
    paths = {
        "flagship": flagship_trainer,
        "production": lambda d: flagship_trainer(d, production=True),
        "lsenerf_emb": lambda d: preset_trainer("lsenerf_emb", device=d),
        "badnerf": lambda d: preset_trainer("badnerf", device=d),
    }
    by_path = {p: run_path(dev, card, p, make) for p, make in paths.items()}
    by_path["cli"] = cli_path(card)
    by_path["tiny_golden"] = tiny_golden(card)
    launches = {k: sum(n[k] for n in by_path.values()) for k in by_path["flagship"]}

    kernels = []
    for k, src_line in ((combine.K1, 58), (combine.K2, 76)):
        kernels.append(dict(
            name=k.name, route="cuda", source="lsenerf_tpu_torch/csrc/blocked_encode.cu",
            replaces=f"lsenerf_tpu/ops/pallas_combine.py:{src_line}",
            launches=launches[k.name], **res[k.name],
        ))
    # each gather kernel replaces several probe kernels; `replaces` names the
    # first of them and `also_replaces` the rest
    for k, (first, *rest) in (
        (gather.G1, ["scripts/pallas_probe4.py:33", "scripts/pallas_probe.py:44",
                     "scripts/pallas_probe.py:58", "scripts/pallas_probe.py:73",
                     "scripts/pallas_probe.py:91", "scripts/pallas_probe.py:108",
                     "scripts/pallas_probe2.py:73", "scripts/pallas_probe3.py:92",
                     "scripts/pallas_probe3.py:116"]),
        (gather.G2, ["scripts/pallas_probe2.py:40", "scripts/pallas_probe2.py:59",
                     "scripts/pallas_probe2.py:90", "scripts/pallas_probe3.py:41",
                     "scripts/pallas_probe3.py:57", "scripts/pallas_probe3.py:74",
                     "scripts/pallas_probe3.py:136"]),
        (gather.G3, ["scripts/pallas_probe2.py:108"]),
    ):
        kernels.append(dict(
            name=k.name, route="cuda", source="lsenerf_tpu_torch/csrc/gather.cu",
            replaces=first, also_replaces=rest, launches=g_launches[k.name],
            **g_res[k.name],
        ))
    print(f"chip_smoke: every phase passed in {time.time() - t_start:.1f} s")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
