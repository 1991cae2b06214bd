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
     Then K7a (ngp_encode_fwd) and K7b (ngp_encode_bwd), the ngp layout's
     kernels, against their plain versions and timed: uniform positions at
     the badnerf preset's shape (56,192 samples, 16 levels of 2^19 entries)
     with an f32 and a bf16 table, the same with the level window [4, 16),
     and the positions and cotangent of one real ngp f32 badnerf step; K7a
     also at the inputs of that trainer's eval render chunk (4096 rays x 48
     samples) and of its step-0 occupancy update's first density chunk
     (131,072 cells); K7a bit for bit at every shape, timed warm and with
     a cold L2 (128 MiB written before each call), with its table loads
     per launch as worked out from its two designs (k7a_requests); and
     a fifth small step, ngp f32 with coarse_stride 2 and the aabb field in
     place of the scene contraction, and a sixth with compact_chunk 128
     (the field on the live chunks of the validity-sorted samples) (3b);
     then (3a-F) the generic encode kernels K1g/K2g (blocked_encode_fwd_f/
     _bwd_f) and K7ag/K7bg (ngp_encode_fwd_f/_bwd_f) against their plain
     versions at features_per_level F = 1, 3, 4, 6, 8 and 16 (56,192
     uniform positions, 8 levels; K7ag bit for bit), and at F = 4 on one
     real step of each 4v path, each timed warm, with a cold L2 and beside
     its bound, K2g and K7bg beside their L2 atomic requests a launch as
     encode_requests.requests works them out from the designs, K1g and K7ag
     beside their table loads' L1 wavefronts and L2 sector requests
     (encode_requests.fwd_requests);
     and two more small steps (3b), 8 levels of F = 4 in each layout;
  3d. K3 (march_ts, csrc/march.cu) against march_ts_plain at the flagship
     trainer's real march inputs (flagship.march_composite_calls: step
     16, right after its occupancy update) in nine cases
     (flagship.march_cases): that step's grid; the fresh all-ones grid,
     where every ray strides; a 20%-occupied random grid; half the rays
     missing the aabb; with nears/fars; the flat march, the unpacked phase
     2 and cone_angle 0; and nears past t_crit, where every candidate reads
     the cone angle's growth table. In each the
     selection before the proposal must be the plain version's bits, and
     with the proposal (F=16) at most 1e-4 of the samples may differ, each
     a bin flip with its quantile within 1e-6 of a CDF step (the count is
     printed); the same past K3's static layout (flagship.WIDE_MARCHES:
     96 slots, 96 coarse segments, 4096 candidates, each alone and all
     three with F=80, in dynamic shared memory), with segments wider than
     a warp (coarse_factor 64 on the step's grid doubled to 256^3) and
     with its scratch in the global workspace (3000 slots over 4096 flat
     candidates); the last three timed once, beside their bounds. Then
     K5a/K5b (composite_fwd/_bwd, csrc/composite.cu) against their plain
     versions at that step's densities, colours and cotangents (3512 x
     16), at 3510 x 48 and at an eval chunk's 4096 x 48, and at that
     chunk's rays cut or walked on to 1-200 samples (every layout's edges
     and the tiled walk past 128), for every background and both
     alpha_thre forms (forward rtol 1e-5 / atol 1e-6, gradients rtol 1e-4
     / atol 1e-6). Each kernel is timed beside its plain version and its
     bound (K3's the larger of its bytes and its f32 operations,
     march_ops), K5a/K5b also beside the launch floor (an empty kernel on
     their grid), at 96 and 200 samples too;
  3e. Adam alone on the 64 MiB f32 table of both train cells and a few small
     leaves (check_adam): the foreach capturable update build_optimizer
     made before against its fused capturable one, device ms a step as
     graph replays beside the bound of one pass, host us a step, and one
     eager step of each traced (its kernels);
  3f. K8a (rays_fwd) and K8b (rays_bwd), the camera rays of a step and
     their backward, at one step's inputs of each train cell's preset,
     against the plain version on the card and timed alone beside it
     (check_bundles);
  3g. K9a (head_fwd) and K9b (head_bwd), the field's MLP head, at the
     three train cells' shapes, the occupancy update's density chunk and
     widths of no preset, against the plain version on the card, the same
     bits twice, timed alone beside its FMA bound and the plain head, and
     the plain head with TF32 products refused by the limits (check_head);
  3c. the gather probe (lsenerf_tpu_torch/gather_probe.py: every case of
     scripts/pallas_probe*.py) on the card, with the gather kernels' launch
     counters set to 0 just before and read just after; then G1 (row_gather),
     G2 (take_along) and G3 (gather_sum) against their plain versions at the
     probes' shapes, each timed beside its plain version and the PyTorch
     call that computes the same function, with G3's L2 bytes per launch as
     worked out from its design;
  4. the flagship train step (flagship.py) for STEPS steps on the card, with
     the launch counters of the encode kernels, K3, K5a and K5b set to 0
     just before and read just after (every path of 4-4k must launch K3,
     K5a and, where a backward runs, K5b);
  4b. the same for the production protocol's train step (flagship.py with
     production=True: RGB spline + deblur x4, 3510 rays), which must also
     move the spline's knots;
  4c. the same for the lsenerf_emb preset (flagship.preset_trainer: one
     appearance row per image, F=0, 3510 rays x 48 samples);
  4d. the same for the badnerf preset (RGB only, no mapping, 878 pixels x
     4 = 3512 rays);
  4g. the same for the badnerf preset with the ngp layout in f32 (the
     real_scale_badnerf_ngpf32 golden's model), through K7a/K7b, with its
     peak memory;
  4v. the flagship's encode width (out_dim 32) as 8 levels of F = 4
     (flagship.FEATURES_4) in the flagship (blocked, bf16) and in the
     badnerf ngp f32 model: each path as in 4 and as in 4s below, through
     K1g/K2g and K7ag/K7bg; every path of 4-4v launches only its config's
     encode pair (check_encode_pair);
  4s. a scan phase for each of those five paths (scan_path): the steps in
     chunks of SCAN (16, the CLI's scan_steps) through
     Trainer.make_train_step_multi, steps 0-15 as the chunk graph's eager
     warm-up; from that state chunk 16-31 as one captured and replayed
     CUDA graph against 16 eager steps (each step's loss, the last step's
     metrics, the background generator's state bit for bit; the layout's
     encode pair, K3, K5a and K5b counted in the capture), then steps
     16-47 timed at scan_steps 1 and 16 (ms/step, rays/s, peak memory);
  4e. the CLI path (lsenerf_tpu_torch.train.main, in process) on the
     reference scene at the real-scale profile (200 frames of 640x480 with
     prev/next event cameras, masks and the full trajectory): 200 steps of
     the headline protocol with every cadence, an exact resume from step 99
     (the restored state and one batch's loss equal the saved ones bit for
     bit), scripts/eval.sh's refinement and full eval (the field bit for bit
     unchanged, view 0's SSIM on the card within 1e-4 of the CPU's), and an
     lsenerf_emb run through scripts/emb_eval.sh's two stages (stage 1 moves
     only the test embedding; stage 2 finds stage 1's run by the script's
     rule), every stage at the CLI's default scan_steps (16: chunks as
     replayed CUDA graphs; the resume loads the save at the end of the
     chunk holding step 99); then (4h) the real_scale_badnerf_ngpf32 golden's flags
     (lsenerf_tpu_torch/parity.py NGPF32) on the same scene: 200 training
     steps through K7a/K7b and eval.sh's 60; the path kernels' counters
     are set to 0 before each stage;
  4i. on a short scene of the same profile (4 frames, an 8-pose full
     trajectory), `python -m lsenerf_tpu_torch.render --traj full` with
     4h's checkpoint: every written frame must equal render_image's output
     for its view (ms a frame); then the viewer's HTTP server on
     127.0.0.1:0 in a thread over the same model: GET /, GET /info and POST
     /render at each resolution for rgb, depth and accumulation, a PNG
     reply decoding to exactly session.render's array (ms a request);
  4j. three short CLI runs on that scene: with use_native, whose first
     two batches must equal the native prefetcher's built directly at the
     same seed; with proposal_warmup_steps, whose steps must run without
     the proposal up to the switch and at F=16 after it; and with
     --pipeline.model.grid-resolution 256 --pipeline.model.coarse-factor
     64 --pipeline.model.max-candidates 4096, whose march must be the
     hierarchical one at segments wider than a warp, through K3; then a
     40-step run at --machine.scan-steps 12, whose chunks and occupancy
     interval do not align: three chunks (the second captured, the third
     replayed) and four single steps, the occupancy updates on JAX's
     steps (0, 12, 24);
  4f. scripts/parity.py --tiny through the same CLI (lsenerf_tpu_torch/
     parity.py): 1500 steps on the 64x64 golden scene at each of four
     seeds; the mean PSNR and SSIM must lie within parity.tiny_gate's
     three standard errors of the JAX package's own runs (the distance
     to scripts/golden_parity.json is printed beside them);
  4k. data parallel (lsenerf_tpu_torch/parallel/ddp.py): two gloo ranks,
     spawned, share the card (NCCL refuses two ranks on one device) and
     take 3 steps of the full-width badnerf ngp f32 trainer, each on its
     half of a fixed global batch and background, held against one
     process's steps on the whole batches (data_parallel's docstring has
     the tolerances); the ranks' grids after step 0's sharded occupancy
     update equal bit for bit; then one step under NCCL at world size 1;
  5. a `kernels` JSON line (K1/K2/K1g/K2g/K7a/K7b/K7ag/K7bg/K3/K5a/K5b/K8a/K8b
     launches summed over phases 4 to 4k, the ranks' included; G1-G3's
     from 3c; each kernel's `status`, ported or redesigned),
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
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STEPS = 26  # the occupancy update runs at steps 0 and 16
SCAN = 16  # the CLI's default scan_steps: train steps a chunk, one CUDA graph
SCAN_ODD = 12  # 4j's scan_steps, where chunks and the occupancy interval do not align
# a scan phase's graph-vs-eager tolerance on the losses past the chunk's
# first step, in training: two runs from one state drift apart chaotically
# (scan_path), so this is a gate against gross faults (a stale batch or a
# missing update moves the losses by far more); the eval mode holds the
# graph to the eager steps bit for bit
SCAN_RTOL = 0.2
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


def encode_bounds(pos, lv, table):
    """The bounds of K1 and K2 (K1g and K2g at F != 2) on these inputs:
    bytes each function must move (inputs once, outputs once; the table's
    rows counted as the distinct rows this input touches, 27 F used values
    each in the table's type; K2 writes the whole f32 gradient table) and
    its f32 operations, at the card's peaks. Returns (K1's, K2's, distinct
    rows)."""
    import torch

    from lsenerf_tpu_torch.ops import combine

    n, L, F = pos.shape[0], lv.num, lv.F
    keys = combine.keys_fracs(pos, lv)[0]
    rows = int(torch.unique(keys).numel())
    row_bytes = rows * 27 * F * table.element_size()
    m = n * L
    k1_bytes = n * 3 * 4 + row_bytes + m * F * 4
    k1_ops = m * (3 * 4 + 9 + 27 + 27 * F * 2)  # fracs, weights, 27 F FMAs
    k2_bytes = n * 3 * 4 + row_bytes + m * F * 4 + n * 3 * 4 + lv.total_rows * lv.row_width * 4
    k2_ops = m * (3 * 4 + 27 * 2 * F + 27 * 3 * 3 + 27 * 2 + 8 * F * 2 + 3 * 4)
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

    (b1, b2, rows) = encode_bounds(pos, lv, table)
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
    gfeat = torch.randn((n, L * lv.F), generator=gen, device=dev)
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


def ngp_bounds(pos, table, lv):
    """The bounds of K7a and K7b (K7ag and K7bg at F != 2) on these inputs:
    bytes each function must move (inputs once, outputs once; the table's
    entries counted as the distinct entries this input touches, F values
    each in the table's type; K7b writes the whole f32 gradient table) and
    its f32 operations (per sample-level: the fractions, 8 corner weights
    and 8 F-feature terms, the backward's chain rule), at the card's peaks.
    Returns (K7a's, K7b's, distinct entries)."""
    import torch

    from lsenerf_tpu_torch.ops import ngp

    n, L, F = pos.shape[0], lv.num, table.shape[1]
    keys = ngp.corners(pos, lv)[0]
    entries = int(torch.unique(keys).numel())
    entry_bytes = entries * F * table.element_size()
    m = n * L
    fwd_bytes = n * 3 * 4 + entry_bytes + m * F * 4
    fwd_ops = m * (3 * 3 + 3 + 8 * 2 + 8 * F * 2)
    bwd_bytes = n * 3 * 4 + entry_bytes + m * F * 4 + n * 3 * 4 + lv.table_rows * F * 4
    bwd_ops = m * (3 * 3 + 3 + 8 * 2 + 8 * (2 * F - 1 + 6 + 3 + F) + 3)
    return bound(fwd_bytes, fwd_ops), bound(bwd_bytes, bwd_ops), entries


def k7a_requests(pos, lv, entry_bytes):
    """K7a's table loads per launch on these positions, worked out from the
    two designs, not measured: L1 wavefronts (one per distinct 128-byte line
    a warp's load instruction touches) and L2 sector requests (each
    distinct 32-byte sector a warp reads, L1 keeping a line between the
    instructions of one warp). Entries are `entry_bytes` (8 f32, 4 bf16).
    A thread a (sample, level) (K7a before this design): a warp on 32
    consecutive sample-levels, one load instruction a corner. Level-grouped
    warps (this K7a): a warp on one level of 32 consecutive samples, one
    aligned two-entry load a (cy, cz) for the cx = 0 corner and its pair,
    and for lanes whose base x is odd one load of the cx = 1 corner,
    issued only where some lane needs it. Positions and outputs are not
    counted. Returns (wavefronts, sectors) before and now."""
    import torch

    from lsenerf_tpu_torch.ops import ngp

    keys = ngp.corners(pos, lv)[0]  # (8, L, n), corner c = cx*4 + cy*2 + cz
    L, n = keys.shape[1:]
    line = {8: 4, 4: 5}[entry_bytes]  # log2 of the entries a line
    sec = line - 2  # and a sector

    def distinct(g):  # the distinct values in each row of the last dim, -1 not counted
        s = g.sort(dim=-1).values
        d = 1 + (s[..., 1:] != s[..., :-1]).sum(-1)
        return int((d - (s[..., 0] < 0).long()).sum())

    def warps(x):  # (..., m) -> (..., W, 32), the last warp padded with its last lane
        extra = -x.shape[-1] % 32
        x = torch.cat([x, x[..., -1:].expand(*x.shape[:-1], extra)], -1)
        return x.reshape(*x.shape[:-1], -1, 32)

    old = warps(keys.permute(0, 2, 1).reshape(8, n * L))  # (8, W, 32)
    old_sec = (old >> sec).permute(1, 0, 2).reshape(old.shape[1], -1)
    new = warps(keys)  # (8, L, W, 32)
    odd = warps(torch.floor(pos[None, :, 0] * lv.scale[:, None]).long() % 2 == 1)  # (L, W, 32)
    single = torch.where(odd, new[4:], -1)  # -1: the lane loads nothing
    new_sec = torch.cat([new[:4] >> sec, single >> sec]).permute(1, 2, 0, 3).reshape(L, -1, 256)
    return ((distinct(old >> line), distinct(old_sec)),
            (distinct(new[:4] >> line) + distinct(single >> line), distinct(new_sec)))


def check_k7a(name, pos, table, lv):
    """K7a against its plain version on one input, bit for bit; then timed
    warm (`timings`) and with a cold L2 (`cold_ms`), beside its bound and
    its table loads per launch as worked out from the designs."""
    import torch

    from lsenerf_tpu_torch.ops import ngp
    from lsenerf_tpu_torch.timing import cold_ms

    out = ngp.encode_fwd(pos, table, lv)
    want = ngp.encode_fwd_plain(pos, table, lv)
    torch.cuda.synchronize()
    # the same keys, weights and order of the 8-corner sum: the same bits
    if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
        fail(f"K7a at {name}: not the plain version's bits (max abs err "
             f"{float((out - want).abs().max()):.3e})")
    del out, want
    (b_ms, b_by), _, entries = ngp_bounds(pos, table, lv)
    fn = lambda: ngp.encode_fwd(pos, table, lv)  # noqa: E731
    r = dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
             **timings(fn, lambda: ngp.encode_fwd_plain(pos, table, lv)))
    r["cold_ms"] = cold_ms(fn)
    print(f"{ngp.K7A.name} at {name}: max_abs_err 0 (the same bits), {fmt(r)}; cold L2 "
          f"{r['cold_ms']:.5f} ms; {entries} distinct entries ({table.dtype}) at n={pos.shape[0]}, "
          f"levels [{lv.lo}, {lv.lo + lv.num}) of {lv.levels} x 2^{lv.log2_T}")
    (w0, s0), (w1, s1) = k7a_requests(pos, lv, 2 * table.element_size())
    m = pos.shape[0] * lv.num
    print(f"K7a table loads per launch at {name}, worked out from the designs (not measured): a "
          f"thread a sample-level, {w0} L1 wavefronts and {s0} L2 sector requests; level-grouped "
          f"warps, {w1} L1 wavefronts and {s1} L2 sector requests ({s0 / m:.2f} and {s1 / m:.2f} "
          f"sectors per sample-level)")
    return r


def check_ngp_encode(name, pos, table, gfeat, lv):
    """K7a (check_k7a) and K7b against their plain versions on one input,
    then timed. Returns {kernel name: result}."""
    import torch

    from lsenerf_tpu_torch.ops import ngp

    res = {ngp.K7A.name: check_k7a(name, pos, table, lv)}
    dpos, dtab = ngp.encode_bwd(pos, table, gfeat, lv)
    wdpos, wdtab = ngp.encode_bwd_plain(pos, table, gfeat, lv)
    torch.cuda.synchronize()
    # dpos sums level terms that cancel: atol scales with its largest element
    torch.testing.assert_close(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
    # atomics add in an order that changes from run to run
    torch.testing.assert_close(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))
    lo, hi = lv.lo << lv.log2_T, (lv.lo + lv.num) << lv.log2_T
    if dtab[:lo].any() or dtab[hi:].any():
        fail(f"K7b at {name}: table gradient outside the level window [{lv.lo}, {lv.lo + lv.num})")
    err = max(float((dpos - wdpos).abs().max()), float((dtab - wdtab).abs().max()))
    dpos2, _ = ngp.encode_bwd(pos, table, gfeat, lv)
    torch.cuda.synchronize()
    if not torch.equal(dpos, dpos2):
        fail(f"K7b at {name}: dpos differs between two calls on the same inputs")
    del dpos, dtab, wdpos, wdtab, dpos2

    _, (b_ms, b_by), entries = ngp_bounds(pos, table, lv)
    r = res[ngp.K7B.name] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **timings(
        lambda: ngp.encode_bwd(pos, table, gfeat, lv),
        lambda: ngp.encode_bwd_plain(pos, table, gfeat, lv)))
    print(f"{ngp.K7B.name} at {name}: max_abs_err {err:.3e}, {fmt(r)}; {entries} distinct entries "
          f"({table.dtype}) at n={pos.shape[0]}, levels [{lv.lo}, {lv.lo + lv.num}) of "
          f"{lv.levels} x 2^{lv.log2_T}")
    return res


# flagship.ngp_encode_shapes' inputs, as 3a-ngp names them
NGP_SHAPES = {
    "uniform": "uniform positions, f32 table",
    "bf16": "uniform positions, bf16 table",
    "window_4_16": "uniform positions, f32 table, levels [4, 16)",
    "step": "one ngp f32 badnerf step's inputs",
    "eval_chunk": "one eval render chunk (4096 rays x 48 samples)",
    "occupancy": "the step-0 occupancy update's first density chunk",
}


def check_ngp(dev):
    """Phase 3a, ngp: K7a (and K7b where a backward runs) against their
    plain versions at flagship.ngp_encode_shapes: the badnerf preset's
    shape with the golden's 16 levels of 2^19 entries, on uniform random
    positions with an f32 and a bf16 table and with the level window [4,
    16) (the strided field's fine encode), on one real ngp f32 badnerf
    step's inputs, and, for K7a alone, where most of its launches are: one
    eval render chunk of that trainer (4096 rays x 48 samples, ray-major)
    and its step-0 occupancy update. Returns the f32 uniform results, with
    the others under "shapes"."""
    from lsenerf_tpu_torch.flagship import ngp_encode_shapes
    from lsenerf_tpu_torch.ops import ngp

    t0 = time.time()
    inputs = ngp_encode_shapes(dev)
    print(f"the ngp shapes' inputs (one ngp f32 badnerf step and an eval chunk): "
          f"{time.time() - t0:.1f} s; n = {({k: v[0].shape[0] for k, v in inputs.items()})}")
    shapes = {}
    for name, (pos, table, gfeat, lv) in inputs.items():
        label = NGP_SHAPES[name]
        shapes[name] = (check_ngp_encode(label, pos, table, gfeat, lv) if gfeat is not None
                        else {ngp.K7A.name: check_k7a(label, pos, table, lv)})
    res = shapes.pop("uniform")
    for k in res:
        res[k]["shapes"] = {name: r[k] for name, r in shapes.items() if k in r}
    return res


# the generic encode kernels' phase (3a-F): F values, at 56,192 samples
# (the badnerf and flagship presets' 3512 rays x 16) and FEATURES_4's 8 levels
GENERIC_FEATURES = (1, 3, 4, 6, 8, 16)


def generic_pair(layout: str):
    """The generic (forward, backward) kernels of a layout: K1g/K2g or
    K7ag/K7bg."""
    from lsenerf_tpu_torch.ops import combine, ngp

    return (combine.K1G, combine.K2G) if layout == "blocked" else (ngp.K7AG, ngp.K7BG)


def check_generic_encode(name, layout, pos, table, gfeat, lv):
    """K1g and K2g (blocked) or K7ag and K7bg (ngp) against their plain
    versions on one input at F != 2, each launched once by its wrapper:
    K1g rtol 1e-5 / atol 1e-6 (3a's), K7ag the plain version's bits, the
    backwards as K2/K7b (dpos atol 1e-6 of its largest element, the table
    gradient 1e-5 of its largest, dpos the same bits twice). Then each is
    timed warm, with a cold L2 and beside its bound. Returns {kernel name:
    result}."""
    import torch

    from lsenerf_tpu_torch import encode_requests
    from lsenerf_tpu_torch.ops import combine, ngp
    from lsenerf_tpu_torch.timing import cold_ms

    mod = combine if layout == "blocked" else ngp
    kf, kb = generic_pair(layout)
    F = lv.F if layout == "blocked" else table.shape[1]
    before = kf.launches, kb.launches
    out = mod.encode_fwd(pos, table, lv)
    want = mod.encode_fwd_plain(pos, table, lv)
    dpos, dtab = mod.encode_bwd(pos, table, gfeat, lv)
    wdpos, wdtab = mod.encode_bwd_plain(pos, table, gfeat, lv)
    torch.cuda.synchronize()
    if (kf.launches, kb.launches) != (before[0] + 1, before[1] + 1):
        fail(f"{name}: the wrappers did not launch {kf.name} and {kb.name} at F = {F}")
    if layout == "ngp":
        if not same_bits(out, want):
            fail(f"{kf.name} at {name}: not the plain version's bits (max abs err "
                 f"{float((out - want).abs().max()):.3e})")
    else:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
    err1 = float((out - want).abs().max())
    torch.testing.assert_close(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
    torch.testing.assert_close(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))
    if layout == "blocked" and dtab[:, 27 * F:].any():
        fail(f"{kb.name} at {name}: the pad columns past 27 F moved")
    err2 = max(float((dpos - wdpos).abs().max()), float((dtab - wdtab).abs().max()))
    dpos2, _ = mod.encode_bwd(pos, table, gfeat, lv)
    torch.cuda.synchronize()
    if not torch.equal(dpos, dpos2):
        fail(f"{kb.name} at {name}: dpos differs between two calls on the same inputs")
    del out, want, dpos, dtab, wdpos, wdtab, dpos2

    if layout == "blocked":
        b1, b2, distinct = encode_bounds(pos, lv, table)
    else:
        b1, b2, distinct = ngp_bounds(pos, table, lv)
    res = {}
    for k, err, fn, plain, (b_ms, b_by) in (
        (kf, err1, lambda: mod.encode_fwd(pos, table, lv),
         lambda: mod.encode_fwd_plain(pos, table, lv), b1),
        (kb, err2, lambda: mod.encode_bwd(pos, table, gfeat, lv),
         lambda: mod.encode_bwd_plain(pos, table, gfeat, lv), b2),
    ):
        r = res[k.name] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by, **timings(fn, plain))
        r["cold_ms"] = cold_ms(fn)
        print(f"{k.name} at {name}: max_abs_err {err:.3e}, {fmt(r)}; cold L2 {r['cold_ms']:.5f} ms; "
              f"{distinct} distinct {'rows' if layout == 'blocked' else 'entries'} "
              f"({table.dtype}) at n={pos.shape[0]}, L={lv.num}, F={F}")
    # a model, not a measurement: printed only, kept out of the kernels line
    scalar, new = encode_requests.requests(layout, pos, table, gfeat, lv)
    ms, m = res[kb.name]["device_ms"], pos.shape[0] * lv.num
    print(f"{kb.name} L2 atomic requests a launch at {name}, worked out from the designs (not "
          f"measured): {new} ({new / m:.2f} a sample-level; the first design's scalar atomics "
          f"{scalar}, {scalar / m:.2f}): {new / ms / 1e6:.1f} G requests/s at "
          f"{ms:.5f} ms on the device")
    (w0, s0), (w1, s1) = encode_requests.fwd_requests(layout, pos, table, lv)
    ms = res[kf.name]["device_ms"]
    print(f"{kf.name} table loads a launch at {name}, worked out from the designs (not measured): "
          f"a thread a sample-level, {w0} L1 wavefronts and {s0} L2 sector requests ({s0 / m:.2f} "
          f"a sample-level); this design, {w1} and {s1} ({s1 / m:.2f}): {s1 / ms / 1e6:.1f} G "
          f"sector requests/s at {ms:.5f} ms on the device")
    return res


def check_generic(dev):
    """Phase 3a-F: K1g/K2g and K7ag/K7bg against their plain versions at
    GENERIC_FEATURES, on flagship.generic_encode_uniform's 56,192 uniform
    positions with 8 levels (the blocked layout's flagship grid with a bf16
    table, the ngp one's 8 levels of 2^19 entries with an f32 table), then
    at F = 4 on the inputs of one real step of each 4v path
    (flagship.generic_encode_steps). Returns the F = 4 uniform results, the
    others under "shapes"."""
    from lsenerf_tpu_torch.flagship import generic_encode_steps, generic_encode_uniform

    t0 = time.time()
    shapes = {}
    for layout, F, pos, table, gfeat, lv in generic_encode_uniform(GENERIC_FEATURES, dev):
        shapes[f"F{F}"] = dict(shapes.get(f"F{F}", {}), **check_generic_encode(
            f"uniform positions, F={F}", layout, pos, table, gfeat, lv))
        del table, gfeat
    steps = generic_encode_steps(dev)
    shapes["step"] = check_generic_encode("one flagship F=4 step's inputs", "blocked",
                                          *steps["blocked"])
    shapes["step"].update(check_generic_encode("one badnerf ngp f32 F=4 step's inputs", "ngp",
                                               *steps["ngp"]))
    del steps
    res = shapes.pop("F4")
    for k in res:
        res[k]["shapes"] = {name: r[k] for name, r in shapes.items()}
    print(f"phase 3a-F in {time.time() - t0:.1f} s")
    return res


def same_bits(a, b) -> bool:
    """a and b equal bit for bit (floats as their int32 words)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def march_ops(o, d, nears, fars, state, gcfg, cfg):
    """K3's f32 operations on these rays, from what the plain version's
    march needs of them. A ray's setup 30 (the slab test, t_lo, t_hi,
    n_lin, t_geo). Hierarchical: phase 1's boundaries up to the first at or
    past t_hi, each a t (2) and a supergrid cell (35: the point 6, its
    magnitude 5, the level 7 with logf, division, ceil and clamp, the
    level's half and 1/cell 5, three cell coordinates 4 each), then cf
    candidates in each selected segment; flat: the candidates whose t0
    lies before t_hi. A candidate: two t, its width and midpoint 4 and its
    cell. A selected slot: 2 for its t_end. With the proposal, a selected
    slot's EMA cell, width, midpoint, tau and alpha 8 and pdf 6, and 10 an
    output sample of a ray that has a selected slot."""
    import dataclasses

    import torch

    from lsenerf_tpu_torch.ops import march

    lookup, t = 35, 2
    t_lo, t_hi = march.ray_range(o, d, nears, fars, gcfg, cfg)
    ops = 30 * o.shape[0]
    if march.use_hierarchical(gcfg, cfg):
        tc, _, keep_c = march._phase1(o, d, t_lo, t_hi, state, gcfg, cfg)
        bounds = torch.clamp((tc[:, :-1] < t_hi[:, None]).sum(1) + 1, max=tc.shape[1])
        k1 = cfg.max_coarse_segments
        count = keep_c.sum(1)
        stride = torch.clamp((count + k1 - 1) // k1, min=1)
        cands = (count + stride - 1) // stride * cfg.coarse_factor
        ops += int(bounds.sum()) * (t + lookup)
    else:
        i = torch.arange(cfg.max_candidates, dtype=torch.float32, device=o.device)[None, :]
        cands = (march.ts_at_indices(t_lo, i, cfg) < t_hi[:, None]).sum(1)
    ops += int(cands.sum()) * (2 * t + 4 + lookup)
    pre = dataclasses.replace(cfg, proposal_samples=0)
    sel = march.march_ts_plain(o, d, nears, fars, state, gcfg, pre)[2].sum(1)
    ops += 2 * int(sel.sum())
    if march.uses_proposal(cfg):
        ops += int(sel.sum()) * (lookup + 8 + 6) + 10 * cfg.proposal_samples * int((sel > 0).sum())
    return ops


def march_bound(o, d, nears, fars, state, gcfg, cfg):
    """K3's least time on these rays: the larger of the bytes it must move
    (rays and nears/fars read once; each distinct grid cell its lookups
    read, a byte a bool and 4 a f32 EMA; the outputs written once) at the
    card's memory rate, and its f32 operations (march_ops) at the card's
    rate for them: each is a separate multiply, add or other instruction
    (no FMA), which issues at half the f32 FMA rate that F32_FLOPS counts in
    flops, so each counts as 2 of bound()'s flops. The distinct cells come from the plain version's lookups on
    these inputs (occupancy._take watched). Returns (ms, "bytes" or
    "operations", distinct cells by grid)."""
    import torch

    from lsenerf_tpu_torch.ops import march
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    seen, real = {}, occ_lib._take

    def watch(grid, flat):
        key = (grid.data_ptr(), grid.element_size(), tuple(grid.shape))
        seen.setdefault(key, []).append(flat.reshape(-1))
        return real(grid, flat)

    occ_lib._take = watch
    try:
        t_starts, _, _ = march.march_ts_plain(o, d, nears, fars, state, gcfg, cfg)
    finally:
        occ_lib._take = real
    cells = {f"{k[2]} x {k[1]} B": int(torch.unique(torch.cat(v)).numel()) for k, v in seen.items()}
    grid_bytes = sum(int(torch.unique(torch.cat(v)).numel()) * k[1] for k, v in seen.items())
    n, m = t_starts.shape
    nbytes = n * 24 + (n * 4 if nears is not None else 0) + (n * 4 if fars is not None else 0)
    nbytes += grid_bytes + n * m * 9
    ms, by = bound(nbytes, 2 * march_ops(o, d, nears, fars, state, gcfg, cfg))
    return ms, by, cells


def check_march_case(label, o, d, nears, fars, state, gcfg, cfg):
    """K3 against march_ts_plain on one input: the selection before the
    proposal (max_samples slots) the same bits, then with the proposal at
    most 1e-4 of the samples different, each a bin flip with its quantile
    within 1e-6 of a step of the plain version's CDF. Returns the flips."""
    import dataclasses

    import torch

    from lsenerf_tpu_torch.ops import march

    pre = dataclasses.replace(cfg, proposal_samples=0)
    got = march.march_ts(o, d, nears, fars, state, gcfg, pre)
    want = march.march_ts_plain(o, d, nears, fars, state, gcfg, pre)
    torch.cuda.synchronize()
    for name, g, w in zip(("t_starts", "t_ends", "mask"), got, want):
        if not same_bits(g, w):
            bad = int((g != w).sum())
            fail(f"K3 at {label}: {name} before the proposal is not the plain version's bits "
                 f"({bad} of {w.numel()} differ)")
    counts = want[2].sum(1)
    line = (f"K3 at {label}: {o.shape[0]} rays, the selection before the proposal the plain "
            f"version's bits ({float(counts.float().mean()):.2f} samples a ray, "
            f"{int((counts == 0).sum())} rays empty, {int((counts == pre.max_samples).sum())} full)")
    flips = 0
    if march.uses_proposal(cfg):
        got = march.march_ts(o, d, nears, fars, state, gcfg, cfg)
        wantf = march.march_ts_plain(o, d, nears, fars, state, gcfg, cfg)
        diff = torch.zeros_like(wantf[2])
        for g, w in zip(got, wantf):
            diff |= g.view(torch.int32) != w.view(torch.int32) if g.dtype == torch.float32 else g != w
        flips = int(diff.sum())
        if flips:
            _, cdf, u = march.proposal_cdf(*want, state, o, d, cfg, gcfg)
            gap = (u[None, :, None] - cdf[:, None, :]).abs().amin(-1)[diff]
            if flips > 1e-4 * diff.numel() or float(gap.max()) >= 1e-6:
                fail(f"K3 at {label}: {flips} of {diff.numel()} proposal samples differ, their "
                     f"quantiles up to {float(gap.max()):.3e} from a CDF step")
        line += (f"; with the proposal (F={cfg.proposal_samples}) {flips} of {diff.numel()} "
                 f"samples differ from the plain version's (bin flips, each within 1e-6 of a "
                 f"CDF step)")
    print(line)
    return flips


BACKGROUNDS = ("linear", "black", "white", "last_sample", "random")


def check_composite_case(label, args, cot):
    """K5a and K5b against their plain versions on one input, for each
    background and both forms of alpha_thre (a float and the 0-dim device
    tensor): forward to rtol 1e-5 / atol 1e-6, gradients to rtol 1e-4 /
    atol 1e-6 (sums over a ray's samples in another order), a ray whose
    transmittance ties early_stop_eps held to the plain version at eps
    nudged by composite.TIE either way (composite.rays_off_plain; the ties
    are counted), and the same bits on a second call. Returns the largest
    absolute errors (forward, backward) outside the ties."""
    import torch

    from lsenerf_tpu_torch.ops import composite

    density, rgb, ts, te, mask, alpha_thre, eps, bg, background = args
    n = mask.shape[0]
    gen = torch.Generator(device=density.device).manual_seed(5)
    bg = bg if bg is not None else torch.rand((n, 3), generator=gen, device=density.device)
    thre = float(alpha_thre) if isinstance(alpha_thre, torch.Tensor) else alpha_thre
    errs, ties = [0.0, 0.0], 0
    for back in BACKGROUNDS:
        for at in (thre, torch.tensor(thre, device=density.device)):
            a = (density, rgb, ts, te, mask, at, eps, bg if back == "random" else None, back)
            for i, (fn, plain, extra, rtol) in enumerate((
                    (composite.composite_fwd, composite.composite_fwd_plain, (), 1e-5),
                    (composite.composite_bwd, composite.composite_bwd_plain, cot, 1e-4))):
                got, again = fn(*a, *extra), fn(*a, *extra)
                off, tie = composite.rays_off_plain(got, plain, a, extra, rtol=rtol)
                torch.cuda.synchronize()
                what = f"K5{'ab'[i]} at {label}, {back}, alpha_thre {type(at).__name__}"
                if off.any():
                    fail(f"{what}: {int(off.sum())} rays off the plain version, e.g. "
                         f"{off.nonzero().flatten()[:4].tolist()}")
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    fail(f"{what}: other bits on a second call")
                ties += int(tie.sum())
                keep = ~tie
                for g, w in zip(got, plain(*a, *extra)):
                    errs[i] = max(errs[i], float((g - w)[keep].abs().max()) if keep.any() else 0.0)
    print(f"K5a/K5b at {label} ({n} rays x {mask.shape[1]} samples): every background x both "
          f"alpha_thre forms within tolerance, the same bits twice; max abs err {errs[0]:.3e} / "
          f"{errs[1]:.3e}; {ties} ray x case ties of early_stop_eps decided by a nudge")
    return errs


def composite_bounds(args, cot):
    """K5a's and K5b's least times: the bytes each must move (density, rgb,
    t_starts, t_ends and mask read once, the background colours and the
    cotangents where given; the outputs written once)."""
    density, rgb, ts, te, mask, alpha_thre, eps, bg, background = args
    n, k = mask.shape
    inputs = n * k * (4 + 12 + 4 + 4 + 1) + (n * 12 if bg is not None else 0)
    fwd = inputs + n * 20
    bwd = inputs + sum(g.numel() * 4 for g in cot if g is not None) + n * k * 16
    return bound(fwd, 0), bound(bwd, 0)


# K5a/K5b's samples a ray beyond the main path's 16 and 48: each layout's
# edges (8, 16, 32, 48, 64 a warp's lanes; 128 a tile) and the tiled walk
COMPOSITE_EDGES = (1, 2, 7, 15, 17, 31, 32, 33, 47, 63, 64, 65, 96, 200)


def composite_at_k(args, k):
    """The eval chunk's composite arguments (its first 4095 rays, so that
    the last warp is part full) cut to k samples a ray, or walked on past
    its last sample: its samples again, shifted in t by the ray's span."""
    import torch

    density, rgb, ts, te, mask, *rest = (x[:4095] if isinstance(x, torch.Tensor) and x.dim()
                                         else x for x in args)
    reps = -(-k // mask.shape[1])
    span = te[:, -1:] - ts[:, :1]
    ts = torch.cat([ts + r * span for r in range(reps)], 1)[:, :k].contiguous()
    te = torch.cat([te + r * span for r in range(reps)], 1)[:, :k].contiguous()
    density, rgb, mask = (x.repeat(1, reps, *(1,) * (x.dim() - 2))[:, :k].contiguous()
                          for x in (density, rgb, mask))
    return (density, rgb, ts, te, mask, *rest)


def check_march_composite(dev):
    """Phase 3d: K3 (march_ts) and K5a/K5b (composite_fwd/_bwd) against
    their plain versions at the flagship's inputs (flagship.
    march_composite_calls: step 16, right after its occupancy update, and
    an eval chunk). K3 in flagship.march_cases' nine cases: that step's
    rays and grid; the fresh all-ones grid, where every ray strides; a
    20%-occupied random grid; the step's rays with half of them turned to
    miss the aabb; with nears/fars; the flat march, the unpacked phase 2
    and cone_angle 0; and nears past t_crit (the whole growth table); then
    past its static layout (flagship.march_wide_cases: 96 slots, 96 coarse
    segments, 4096 flat candidates, coarse_factor 64 on the grid doubled to
    256^3, 3000 slots in the global workspace, then 96 slots, 96 segments
    and 4096 candidates with F=80; the last three timed, beside their
    bounds). K5a/K5b at the
    step's densities, colours and cotangents (3512 x 16), at 3510 x 48 and
    at the eval chunk's 4096 x 48 (flagship.composite_shapes), and at the
    eval chunk's rays cut or walked on to each of COMPOSITE_EDGES, for
    every background and both alpha_thre forms. Each kernel timed beside
    its plain version and its bound, K5a/K5b also beside the launch floor
    (an empty kernel on K5a's grid), at 96 and 200 samples too. Returns
    {kernel name: results}."""
    import torch

    from lsenerf_tpu_torch.flagship import (composite_shapes, march_cases,
                                            march_composite_calls, march_wide_cases)
    from lsenerf_tpu_torch.ops import composite, march
    from lsenerf_tpu_torch.timing import cold_ms, device_ms

    t0 = time.time()
    calls = march_composite_calls(dev)
    print(f"the flagship's step 16 and an eval chunk for K3/K5's inputs: {time.time() - t0:.1f} s")
    gcfg = calls["march"][5]
    cases = [(label, *rays, st, gcfg, c) for label, *rays, st, c in march_cases(calls)]
    wide = march_wide_cases(calls)
    flips = {label: check_march_case(label, *a) for label, *a in cases + wide}
    res = {}

    def timed(fn, plain, nbound):
        r = dict(max_abs_err=0.0, bound_ms=nbound[0], bound_by=nbound[1], **timings(fn, plain))
        r["cold_ms"] = cold_ms(fn)
        return r

    for key, label in (("march", "step 16"), ("eval_march", "an eval chunk (F=0)")):
        a = calls[key]
        b_ms, b_by, cells = march_bound(*a)
        r = timed(lambda: march.march_ts(*a), lambda: march.march_ts_plain(*a), (b_ms, b_by))
        r["distinct_cells"] = cells
        print(f"{march.K3.name} at {label}: {fmt(r)}; cold L2 {r['cold_ms']:.5f} ms; distinct "
              f"cells read {cells}")
        res.setdefault(march.K3.name, {}).setdefault("shapes", {})[key] = r
    for key, (label, *a) in zip(("cf64", "global", "wide"), wide[-3:]):
        b_ms, b_by, _ = march_bound(*a)
        ln = march._launch(a[5], a[6], dev.index or 0)
        r = dict(device_ms=device_ms(lambda: march.march_ts(*a)),
                 cold_ms=cold_ms(lambda: march.march_ts(*a)), bound_ms=b_ms, bound_by=b_by,
                 layout=ln.sc["wide"], workspace_bytes=a[0].shape[0] * ln.words * 4)
        print(f"{march.K3.name} at step 16 past its static layout ({label}; layout {r['layout']}, "
              f"a global workspace of {r['workspace_bytes']} bytes): {r['device_ms']:.5f} ms on "
              f"the device, cold L2 {r['cold_ms']:.5f} ms, bound {b_ms:.5f} ms ({b_by})")
        res[march.K3.name]["shapes"][key] = r
    k3 = res[march.K3.name]
    k3.update(k3["shapes"].pop("march"), proposal_flips=flips)

    shapes = composite_shapes(calls)
    rng = torch.Generator(device=dev).manual_seed(11)
    for k in COMPOSITE_EDGES:
        a = composite_at_k(calls["eval_composite"], k)
        m = a[4].shape[0]
        c = (torch.randn((m, 3), generator=rng, device=dev),
             torch.randn((m, 1), generator=rng, device=dev),
             torch.randn((m, 1), generator=rng, device=dev))
        shapes[f"k{k}"] = (a, c)
    for key, (a, c) in shapes.items():
        errs = check_composite_case(key, a, c)
        if key.startswith("k") and key not in ("k96", "k200"):
            continue  # checked, not timed
        (fb, bb) = composite_bounds(a, c)
        rf = timed(lambda: composite.composite_fwd(*a), lambda: composite.composite_fwd_plain(*a),
                   fb)
        rb = timed(lambda: composite.composite_bwd(*a, *c),
                   lambda: composite.composite_bwd_plain(*a, *c), bb)
        n, k = a[4].shape
        blocks = composite.launch_blocks(n, k)
        empty = lambda: composite.launch_empty(blocks, a[0])  # noqa: E731
        floor = dict(floor_device_ms=device_ms(empty), floor_cold_ms=cold_ms(empty))
        rf["max_abs_err"], rb["max_abs_err"] = errs
        for kern, r in ((composite.K5A, rf), (composite.K5B, rb)):
            r.update(floor)
            print(f"{kern.name} at {key} ({n} x {k}): {fmt(r)}; cold L2 {r['cold_ms']:.5f} ms; "
                  f"the launch floor (an empty kernel on its {blocks} blocks) "
                  f"{r['floor_device_ms']:.5f} ms, cold {r['floor_cold_ms']:.5f} ms")
            res.setdefault(kern.name, {}).setdefault("shapes", {})[key] = r
    for k in (composite.K5A, composite.K5B):
        res[k.name].update(res[k.name]["shapes"].pop("step"))
    print(f"phase 3d in {time.time() - t0:.1f} s")
    return res


# Adam's leaves in check_adam: the 64 MiB f32 table of both train cells
# (16 levels x 2^19 rows x F 2, the same 16.8 M values as 16 x 2^14 x 64)
# and leaves of the MLPs' and the cameras' sizes
ADAM_TABLE = (16 << 19, 2)
ADAM_SMALL = ((32, 64), (64,), (64, 64), (64, 16), (16,), (200, 6))


def check_adam(dev) -> dict:
    """Phase 3e: Adam alone on ADAM_TABLE and ADAM_SMALL, one gradient each
    (a quarter of the table's rows zero), the optimizer build_optimizer
    makes (fused, capturable, the lr a device tensor) against the foreach
    capturable one it made before: each one's device ms a step
    (timing.device_ms: 20 steps in one CUDA graph, replayed), beside the
    bound of one pass (parameter, gradient and both moments read, three
    written, at HBM_BYTES_PER_S), its host us a step, and one eager step
    traced (launches and the kernels by device time). The two updates'
    parity is the card tests' (tests/test_torch_kernels_card.py). Returns
    {"fused": ..., "foreach": ...}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lsenerf_tpu_torch.engine.trainer import TrainerConfig, build_optimizer, set_lrs
    from lsenerf_tpu_torch.timing import device_ms, host_us

    t0 = time.time()
    g = torch.Generator(device=dev).manual_seed(22)
    shapes = {"table": ADAM_TABLE, **{f"small{i}": s for i, s in enumerate(ADAM_SMALL)}}
    init = {k: torch.randn(s, generator=g, device=dev) * 1e-2 for k, s in shapes.items()}
    grads = {k: torch.randn(s, generator=g, device=dev) for k, s in shapes.items()}
    grads["table"][torch.rand(ADAM_TABLE[0], generator=g, device=dev) < 0.25] = 0.0
    nbytes = 7 * sum(v.numel() * v.element_size() for v in init.values())
    b_ms, b_by = bound(nbytes, 0)

    res = {}
    for kind in ("foreach", "fused"):
        params = {"model": {k: v.clone() for k, v in init.items()}, "camera_opt": {}}
        opt, schedules, _ = build_optimizer(TrainerConfig(), params)
        if kind == "foreach":
            groups = [{k: v for k, v in grp.items() if k in ("params", "lr", "eps", "name")}
                      for grp in opt.param_groups]
            opt = torch.optim.Adam(groups, betas=(0.9, 0.999), capturable=True, foreach=True)
            opt._warned_capturable_if_run_uncaptured = True
        for k, t in params["model"].items():
            t.grad = grads[k]
        set_lrs(opt, schedules, 0)
        group = opt.param_groups[0]
        r = res[kind] = dict(fused=bool(group["fused"]), capturable=bool(group["capturable"]),
                             device_ms=device_ms(opt.step), host_us=host_us(opt.step, calls=100),
                             bound_ms=b_ms, bound_by=b_by, bytes=nbytes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            opt.step()
            torch.cuda.synchronize()
        kern = {}
        for e in prof.events():
            if e.device_type.name == "CUDA":
                k = kern.setdefault(e.name, [0.0, 0])
                k[0] += (e.time_range.end - e.time_range.start) / 1e3
                k[1] += 1
        r["launches"] = sum(n for _, n in kern.values())
        r["kernels"] = sorted(((name[:90], ms, n) for name, (ms, n) in kern.items()),
                              key=lambda x: -x[1])[:8]
        print(f"Adam {kind} capturable on the 64 MiB table and {len(ADAM_SMALL)} small leaves: "
              f"{r['device_ms']:.5f} ms on the device a step (graph replay), {r['host_us']:.1f} us "
              f"of host a step; bound {b_ms:.5f} ms ({b_by}: {nbytes} bytes); one eager step "
              f"traced: {r['launches']} launches")
        for name, ms, n in r["kernels"]:
            print(f"    {ms:8.5f} ms {n:4d}x  {name}")
    print(f"phase 3e in {time.time() - t0:.1f} s")
    return res


# 3f's cells: (label, preset, field) of the three train cells' presets
BUNDLE_PRESETS = (("lsenerf", "lsenerf", {}), ("lsenerf_emb", "lsenerf_emb", {}),
                  ("badnerf ngp f32", "badnerf", dict(hash_layout="ngp", compute_dtype="float32")))


def kernels_of(fn) -> tuple:
    """(the device kernels one traced call of fn launches, the sum of their
    device ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return len(kern), sum(e.time_range.end - e.time_range.start for e in kern) / 1e3


def check_bundles(dev) -> dict:
    """Phase 3f: K8a (rays_fwd) and K8b (rays_bwd), the camera rays of a
    step and their backward (ops/bundles.py), at one step's inputs of each
    train cell's preset (its camera leaves moved off their start): the
    rays and the camera leaves' gradients under a fixed linear loss on the
    origins and directions against the plain version on the card (rtol 1e-5 / 2e-4 on the rays, the gradients
    within 2e-5 of their largest element), then timed alone: K8a (the
    forward, no autograd) and K8b (the backward of one K8a call: its two
    passes) as ms, device_ms (graph replay) and host_us, and the
    plain version's forward and forward + backward on the card as ms;
    beside each, the kernels one traced call launches and the sum of
    their device ms, and the bound (inputs and outputs once at
    HBM_BYTES_PER_S). Returns {"rays_fwd": ..., "rays_bwd": ...} of the first
    preset, the others under "shapes"."""
    import numpy as np
    import torch

    from lsenerf_tpu_torch.engine.trainer import tree_leaves
    from lsenerf_tpu_torch.flagship import preset_trainer
    from lsenerf_tpu_torch.ops import bundles
    from lsenerf_tpu_torch.timing import device_ms, host_us, time_ms

    t0 = time.time()
    res = {}
    rng = np.random.default_rng(24)
    for label, preset, field in BUNDLE_PRESETS:
        tr = preset_trainer(preset, device=dev, **field)
        cp = tr.params["camera_opt"]
        leaves = [t for _, t in tree_leaves(cp)]
        with torch.no_grad():  # knots ~0.03 rad and 3 cm off, deltas ~0.1
            for path, t in tree_leaves(cp):
                scale = 0.03 if path.endswith("ctrl_tangents") else 0.1
                t += torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32)
                                      * scale).to(dev)
        parts, batch = tr._parts(), tr.batch_to_device(tr.dm.next_train(0))
        spline, rgb_ts, ne = tr.col_spline_static, tr.rgb_ts, tr.dm.num_embd
        gates = (torch.ones((), device=dev), torch.ones((), device=dev))
        args = (parts, cp, batch, gates, spline, rgb_ts, ne)
        n = sum(batch[p.rows].shape[0] * p.rep for p in parts)
        cots = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)).to(dev)
                for _ in range(2)]

        def grads(big):
            loss = (big.origins * cots[0]).sum() + (big.directions * cots[1]).sum()
            return torch.autograd.grad(loss, leaves, allow_unused=True)

        big, _ = bundles.step_rays(*args)
        got = grads(big)
        want_big = bundles.step_rays_plain(*args)
        want = grads(want_big)
        for name, rtol in (("origins", 1e-5), ("directions", 1e-5), ("pixel_area", 2e-4)):
            if not torch.allclose(getattr(big, name), getattr(want_big, name), rtol=rtol,
                                  atol=1e-6 if rtol < 1e-4 else 1e-9):
                fail(f"3f {label}: K8a's {name} differ from the plain version's")
        for name in ("camera_indices", "times"):
            if not torch.equal(getattr(big, name), getattr(want_big, name)):
                fail(f"3f {label}: K8a's {name} differ from the plain version's")
        for g, w in zip(got, want):
            if (g is None) != (w is None):
                fail(f"3f {label}: K8b's gradients reach other leaves than the plain version's")
            if w is not None and not torch.allclose(g, w, rtol=1e-4,
                                                    atol=2e-5 * float(w.abs().max())):
                fail(f"3f {label}: K8b's gradients differ from the plain version's: "
                     f"{float((g - w).abs().max())} of {float(w.abs().max())}")

        sizes = [batch[p.rows].shape[0] * p.rep for p in parts]
        call = bundles._Call(parts, cp, batch, gates, spline, rgb_ts, ne, sizes,
                             batch[parts[0].rows].device)
        call.forward()
        wanted = [True] * len(call.leaves)

        def fwd():
            with torch.no_grad():
                bundles.step_rays(*args)

        def bwd():
            call.backward(cots[0], cots[1], None, wanted)

        def plain_fwd():
            with torch.no_grad():
                bundles.step_rays_plain(*args)

        def plain_both():
            grads(bundles.step_rays_plain(*args))

        # bytes: the index rows, appearance ids, camera tables and leaves
        # read once, the rays written once (origins, directions, area,
        # camera, time, appearance id: 44 bytes); K8b reads the inputs
        # again and two cotangents, writes and reads its terms (56 bytes a
        # ray) and writes the gradients
        ins = sum(batch[p.rows].numel() * 8 + batch[p.app].numel() * 8 for p in parts)
        ins += sum(c.numel() * 4 for c in {id(p.cams.camera_to_worlds): p.cams.camera_to_worlds
                                           for p in parts}.values())
        leaf_bytes = sum(t.numel() * 4 for t in call.leaves)
        f_ms, f_by = bound(ins + leaf_bytes + 44 * n, 0)
        b_ms, b_by = bound(ins + 2 * leaf_bytes + (24 + 2 * 56) * n, 0)
        # the plain version's device time is the sum of its kernels' in one
        # traced call (an autograd backward on the timing's side stream
        # cannot be captured beside the leaves' default-stream nodes)
        res_pairs = []
        for fn, plain, b in ((fwd, plain_fwd, (f_ms, f_by)), (bwd, plain_both, (b_ms, b_by))):
            (nk, kms), (npk, pkms) = kernels_of(fn), kernels_of(plain)
            res_pairs.append(dict(ms=time_ms(fn, 20), device_ms=device_ms(fn), host_us=host_us(fn),
                                  kernel_ms=kms, launches_a_call=nk, plain_ms=time_ms(plain, 5),
                                  plain_kernel_ms=pkms, plain_launches_a_call=npk,
                                  bound_ms=b[0], bound_by=b[1], rays=n))
        r_f, r_b = res_pairs
        for name, r in (("K8a rays_fwd", r_f), ("K8b rays_bwd, two passes", r_b)):
            print(f"3f {label} ({n} rays): {name} {r['ms']:.4f} ms per call, "
                  f"{r['device_ms']:.5f} ms on the device, {r['host_us']:.1f} us of host, "
                  f"{r['launches_a_call']} kernels a call ({r['kernel_ms']:.5f} ms); plain "
                  f"{'forward' if r is r_f else 'forward + backward'} {r['plain_ms']:.4f} ms, "
                  f"{r['plain_launches_a_call']} kernels a call ({r['plain_kernel_ms']:.5f} ms "
                  f"of kernels); bound {r['bound_ms']:.6f} ms by {r['bound_by']}")
        if not res:
            res = {"rays_fwd": dict(r_f, shapes={}), "rays_bwd": dict(r_b, shapes={})}
        res["rays_fwd"]["shapes"][label] = r_f
        res["rays_bwd"]["shapes"][label] = r_b
    print(f"phase 3f in {time.time() - t0:.1f} s")
    return res


def head_work(a, backward: bool) -> tuple:
    """(bytes, f32 operations) of one K9a (or K9b) call on head_fwd's
    arguments a: the multiply-adds of the base and colour MLPs at their
    widths, each 2 operations, a sample (the density alone without
    directions); K9b the input cotangents and the weight gradients, 2x as
    many. Bytes: the features, directions,
    selector and codes read and density and rgb written once (K9b: the
    cotangents read, the features', directions' and codes' gradients and
    the weights' written)."""
    from lsenerf_tpu_torch.ops import field_head as fh

    base, color, feats, sel, dirs, codes = a[:6]
    n, D = feats.shape
    E = 0 if codes is None else codes.shape[1]
    nbytes = feats.numel() * 4 + n + n * 4
    if dirs is not None:
        nbytes += n * (12 + 12) + (0 if codes is None else codes.shape[0] * E * 4)
    weights = sum(t.numel() * 4 for t in list(base.values()) + list((color or {}).values()))
    nbytes += weights
    if backward:
        nbytes += n * 16 + feats.numel() * 4 + n * 12 + weights + n * 832
    return nbytes, 2 * fh.macs(n, D, E, dirs is not None) * (2 if backward else 1)


def check_head(dev) -> dict:
    """Phase 3g: K9a (head_fwd) and K9b (head_bwd), the field's MLP head
    (ops/field_head.py), at flagship.head_shapes (the three train cells'
    steps: 56,160 bf16 samples with one code, 168,480 bf16 with a code a
    ray of 48, 56,192 f32 with one code; the occupancy update's 131,072
    density-only samples, K9a alone; 56,160 bf16 samples of 64 features
    and 16-wide codes, which no preset's compiled widths take): against the
    plain version on the card (field_head.off_plain: each output's error
    printed beside its limit), the same bits on a second call, then timed:
    ms, device_ms (graph replay), cold_ms and host_us (K9b: the backward of
    one prepared call, field_head.Call, that saved its activations), the
    plain version's forward (and forward + backward) ms and its kernels in
    one traced call, beside the bound (head_work: f32 FMA at F32_FLOPS) and
    K9b's beside its MMAs at the bf16 tensor-core rate (field_head.bounds_ms).
    Then the control: the plain version with TF32 products against itself
    in f32 must be off the limits at every train shape. Returns
    {"head_fwd": ..., "head_bwd": ...} of the first shape, the others
    under "shapes"."""
    import torch

    from lsenerf_tpu_torch.flagship import head_shapes
    from lsenerf_tpu_torch.models import field as field_lib
    from lsenerf_tpu_torch.ops import field_head as fh
    from lsenerf_tpu_torch.timing import cold_ms, device_ms, host_us, time_ms

    t0 = time.time()
    res = {}
    plain_fn = field_lib.head_plain
    for label, a in head_shapes(dev).items():
        fa = a[:8]
        for backward in (False, True):
            if backward and a[4] is None:
                continue
            args = a if backward else fa
            name = "K9b" if backward else "K9a"
            got, again = fh.run(*args), fh.run(*args)
            want = fh.run(*args, plain=plain_fn)
            errs = fh.errors(got, want, fh.GRADIENTS if backward else fh.OUTPUTS)
            off = fh.off_plain(got, want, a[7], backward)
            if off:
                fail(f"3g {label}: {name} is off the plain version: {off}")
            if not all((g is None and h is None) or same_bits(g, h) for g, h in zip(got, again)):
                fail(f"3g {label}: {name} gave other bits on a second call")
            if backward:
                # K9b alone: the backward of one prepared call that saved its activations
                prepared = fh.Call(*fa)
                prepared.forward(save=True)
                wanted = [True] * (3 + len(prepared.weights))

                def call(p=prepared, w=wanted):
                    p.backward(a[8], a[9], w)
            else:
                def call(args=fa):
                    fh.run(*args)

            def plain_call(args=args):
                fh.run(*args, plain=plain_fn)

            nbytes, ops = head_work(fa, backward)
            b_ms, b_by = bound(nbytes, ops)
            n, D = fa[2].shape
            tc_ms = fh.bounds_ms(n, D, 0 if fa[5] is None else fa[5].shape[1], fa[7],
                                 fa[4] is not None, backward).get("tensor_cores")
            (nk, kms), (npk, pkms) = kernels_of(call), kernels_of(plain_call)
            r = dict(ms=time_ms(call, 20), device_ms=device_ms(call), cold_ms=cold_ms(call),
                     host_us=host_us(call), kernel_ms=kms, launches_a_call=nk,
                     plain_ms=time_ms(plain_call, 5), plain_kernel_ms=pkms,
                     plain_launches_a_call=npk, bound_ms=b_ms, bound_by=b_by,
                     tensor_core_bound_ms=tc_ms, samples=fa[2].shape[0], errors=errs)
            limit = fh.TOLERANCE[bool(a[7])][int(backward)]
            print(f"3g {label} ({r['samples']} samples): {name} {r['ms']:.4f} ms per call, "
                  f"{r['device_ms']:.5f} ms on the device, cold L2 {r['cold_ms']:.5f}, "
                  f"{r['host_us']:.1f} us of host, {nk} kernels a call ({kms:.5f} ms); plain "
                  f"{'forward + backward' if backward else 'forward'} {r['plain_ms']:.4f} ms, "
                  f"{npk} kernels a call ({pkms:.5f} ms of kernels); bound {b_ms:.5f} ms by "
                  f"{b_by} ({100 * b_ms / r['device_ms']:.1f}% of it)"
                  + (f", its MMAs at the bf16 tensor-core rate {tc_ms:.5f} ms "
                     f"({100 * tc_ms / r['device_ms']:.1f}%)" if tc_ms else "") + "; errors (limit "
                  f"{limit:.0e}) " + ", ".join(f"{k} {e:.2e}" for k, e in errs.items()))
            key = "head_bwd" if backward else "head_fwd"
            if key not in res:
                res[key] = dict(r, shapes={})
            res[key]["shapes"][label] = r
            if a[4] is None or label == "other widths":
                continue
            # the control: TF32 products, which the limits must refuse
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                control = fh.run(*args, plain=plain_fn)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
            cerrs = fh.errors(control, want, fh.GRADIENTS if backward else fh.OUTPUTS)
            coff = fh.off_plain(control, want, a[7], backward)
            print(f"3g {label}: control, the plain {name} with TF32 products: off the limit "
                  f"{limit:.0e} at {sorted(coff)}; errors "
                  + ", ".join(f"{k} {e:.2e}" for k, e in cerrs.items()))
            if not coff:
                fail(f"3g {label}: the limits take the plain {name} with TF32 products")
            res[key]["shapes"][label]["tf32_errors"] = cerrs
    print(f"phase 3g in {time.time() - t0:.1f} s")
    return res


def bound(nbytes, ops):
    """The least time for the work: the larger of bytes over the memory rate
    and f32 operations over the peak f32 rate, in ms, and which bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# the flagship's model modes, which the small steps change by `model`
FLAGSHIP_MODES = dict(use_mapping=True, map_mode="co_map", mapping_method="identity",
                      evs_mapping_method="powpow", ev_one_dim="gt")


def check_small_step(dev, label, col_cam, evs_cam, deblur=False, model=None, hash=None,
                     field=None):
    """Phase 3b: one train step of a small configuration on the card (K1/K2,
    or K7a/K7b with hash=dict(layout="ngp")) against the same step on the
    CPU (plain versions), in f32, with the given camera optimizers
    (CameraOptConfig), with `deblur` deblur x4 RGB rays, the flagship's
    model modes updated by `model` (ModelConfig fields), the small hash
    grid updated by `hash` and FieldConfig fields from `field`. A mapper
    MLP is pretrained on the CPU and moved to the card."""
    import numpy as np
    import torch

    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig, MultiCamDataManager
    from lsenerf_tpu_torch.data.synthetic import make_synthetic_scene
    from lsenerf_tpu_torch.engine.trainer import CameraOptConfig, Trainer, TrainerConfig
    from lsenerf_tpu_torch.models import field as field_lib
    from lsenerf_tpu_torch.models import lsenerf as model_lib
    from lsenerf_tpu_torch.ops import hash_encoding as he
    from lsenerf_tpu_torch.ops import occupancy as occ_lib

    hcfg = dict(num_levels=6, base_res=4, max_res=128, layout="blocked", blocked_rows_log2=10,
                log2_hashmap_size=10)
    mcfg = model_lib.ModelConfig(
        field=field_lib.FieldConfig(hash=he.HashEncodingConfig(**dict(hcfg, **(hash or {}))),
                                    **(field or {})),
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


# the encode kernels of each hash layout at F = 2: (forward, backward)
LAYOUT_KERNELS = {"blocked": ("blocked_encode_fwd", "blocked_encode_bwd"),
                  "ngp": ("ngp_encode_fwd", "ngp_encode_bwd")}


def encode_pair(hcfg) -> tuple:
    """The names of the (forward, backward) encode kernels a HashEncodingConfig
    runs: its layout's F = 2 pair, or the generic one at another F."""
    if hcfg.features_per_level == 2:
        return LAYOUT_KERNELS[hcfg.layout]
    return tuple(k.name for k in generic_pair(hcfg.layout))


def check_encode_pair(label: str, hcfg, launches: dict) -> None:
    """Fail unless the run launched no encode kernel but its config's pair."""
    from lsenerf_tpu_torch.ops import combine, ngp

    pair = encode_pair(hcfg)
    others = {k.name: launches[k.name] for k in combine.KERNELS + ngp.KERNELS
              if k.name not in pair and launches[k.name]}
    if others:
        fail(f"{label}: encode kernels other than {pair} were launched: {others}")


# the kernels every render runs: K3, K5a and, where a backward runs, K5b
RENDER_KERNELS = ("march_ts", "composite_fwd", "composite_bwd")


def path_kernels():
    """K1, K2, K1g, K2g, K7a, K7b, K7ag, K7bg, K3, K5a, K5b, K8a, K8b, K9a
    and K9b (their launch counters)."""
    from lsenerf_tpu_torch.engine import chunk_graph

    return chunk_graph.path_kernels()


def check_render_kernels(label: str, launches: dict, backward: bool = True) -> None:
    """Fail unless the run launched K3 and K5a (and K5b with a backward)."""
    names = RENDER_KERNELS if backward else RENDER_KERNELS[:2]
    if min(launches[k] for k in names) == 0:
        fail(f"{label}: K3/K5a/K5b were not all launched: {launches}")


def run_path(dev, card: str, label: str, make):
    """Phases 4-4d and 4g: the trainer `make(device)` builds for STEPS steps
    on the card. Returns the path kernels' launches in the run."""
    import math

    import torch

    t0 = time.time()
    trainer = make(dev)
    hcfg = trainer.model_config.field.hash
    batches = [trainer.dm.next_train(i) for i in range(STEPS)]
    print(f"{label} set-up {time.time() - t0:.1f} s; {hcfg.layout} table {hcfg.table_shape}, "
          f"batch {trainer.num_rays(batches[0])} rays")
    gc.collect()  # an earlier phase's trainers and graphs, in cycles, out of the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in path_kernels():
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
    launches = {k.name: k.launches for k in path_kernels()}
    ms = ev["a"].elapsed_time(ev["b"]) / (STEPS - TIMED_FROM)
    losses = [float(m["loss"]) for m in metrics]
    psnr = float(metrics[-1]["psnr"])
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(psnr):
        fail(f"non-finite {label} loss or psnr: {losses}, psnr {psnr}")
    n_occ = (STEPS + 15) // 16
    chunks = -(-trainer.model_config.grid.levels * 65536 // 131072)
    fwd, bwd = encode_pair(hcfg)
    if launches[fwd] < STEPS + n_occ * chunks or launches[bwd] < STEPS:
        fail(f"{label}: kernel launch counts too low for {STEPS} steps: {launches}")
    check_encode_pair(label, hcfg, launches)
    if min(launches[k] for k in RENDER_KERNELS) < STEPS:
        fail(f"{label}: K3/K5a/K5b launched fewer than once a step: {launches}")
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


def rewind(trainer, snap: dict) -> None:
    """The trainer back at a trainer_state() snapshot in place: the same
    parameter and Adam tensors and generators, so that a captured chunk
    graph stays valid (restore_into_state replaces Adam's state, so it
    drops the graphs)."""
    import torch

    from lsenerf_tpu_torch.engine.trainer import tree_leaves
    from lsenerf_tpu_torch.ops.occupancy import OccGridState

    with torch.no_grad():
        for p, t in tree_leaves(trainer.params):
            t.copy_(snap["params"][p])
        for group, paths in zip(trainer.optimizer.param_groups, trainer.opt_paths):
            for p, t in zip(paths, group["params"]):
                for k, v in snap["adam"].get(p, {}).items():
                    trainer.optimizer.state[t][k].copy_(v)
    trainer.opt_count, trainer.step_count = snap["opt_count"], snap["step_count"]
    dev = trainer.device
    trainer.occ = OccGridState(occs=snap["occs"].to(dev), binaries=snap["binaries"].to(dev))
    n = trainer._gen.get_state().numel()
    trainer._gen.set_state(snap["rng"][:n].clone())
    trainer._bg_gen.set_state(snap["rng"][n:].clone())


def scan_path(dev, card: str, label: str, make) -> dict:
    """A scan phase: the trainer `make(device)` builds, in chunks of SCAN
    steps as the CLI runs them (Trainer.make_train_step_multi, the
    occupancy update before each chunk that covers one). Steps 0-15 run
    as the chunk graph's eager warm-up. From that state, chunk 16-31 is
    captured and replayed, then run as 16 eager Trainer.step calls twice
    (to print their own spread):
    the chunk's first loss must be the eager one bit for bit (the same
    state and inputs, a forward with no atomics), each later step's loss
    within SCAN_RTOL (K2's atomics add in no fixed order and Adam's eps
    turns the noise into steps of up to lr, so two eager runs drift apart
    chaotically; the last step's metrics, the camera norms among them,
    drift further, so they are printed beside the eager runs' own spread
    and held bit for bit in the eval mode below), the background
    generator's state bit for bit, and
    the capture must hold the layout's encode pair, K3, K5a and K5b once a
    step. Then steps 16-47 are timed at scan_steps 1 and SCAN from that
    state, with their peak memory. Last, in the eval mode (the field
    frozen, so that no atomics reach the parameters) a new graph's
    captured chunk must equal the eager steps from one state bit for bit:
    every loss, the last step's metrics and the whole state after it. Returns the path kernels' launches
    in the phase (the warm-up's, the eager steps' and the capture's; a
    replay runs no wrapper)."""
    import math

    import torch

    from lsenerf_tpu_torch.engine.loop import _covered

    t0 = time.time()
    for kn in path_kernels():
        kn.launches = 0
    trainer = make(dev)
    k = SCAN
    every = trainer.model_config.grid.update_interval
    stacks = [trainer.dm.next_train_stack(c * k, k) for c in range(3)]
    rays = trainer.num_rays({key: v[0] for key, v in stacks[0].items()})
    fn = trainer.make_train_step_multi(k)

    def chunk(c):
        if _covered(c * k, every, k):
            trainer.occ_update()
        return fn(stacks[c])

    def eager(c):
        if _covered(c * k, every, k):
            trainer.occ_update()
        out = [trainer.step({key: v[j] for key, v in stacks[c].items()}, update_occ=False)
               for j in range(k)]
        return out[-1], torch.stack([m["loss"] for m in out])

    chunk(0)  # the eager warm-up
    snap = trainer_state(trainer)
    gc.collect()  # an earlier phase's trainers and graphs, in cycles, out of the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = chunk(1)  # captured, then replayed
    graph_losses, graph_bg = trainer.chunk_losses.cpu(), trainer._bg_gen.get_state()
    cg = trainer._chunks[k]
    torch.cuda.synchronize()
    peak_capture = torch.cuda.max_memory_allocated()
    rewind(trainer, snap)
    want, eager_losses = eager(1)
    eager_losses, eager_bg = eager_losses.cpu(), trainer._bg_gen.get_state()
    rewind(trainer, snap)
    want_again, again = eager(1)
    again = again.cpu()

    def rel(a, b):
        return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())

    fwd, bwd = encode_pair(trainer.model_config.field.hash)
    need = (fwd, bwd) + RENDER_KERNELS
    # K2's (and K7b's) atomics add in no fixed order, and Adam's eps of 1e-15
    # makes steps of up to lr of the rounding noise, so two runs from one
    # state part a few steps in and drift apart chaotically, whichever is
    # the graph: on the H100 the losses up to ~4e-2 (the production path,
    # whose 12 spline knots move every RGB ray) and the camera norms up to
    # ~2e-1 relative by step 31. Past the first step the losses are held to
    # SCAN_RTOL
    if not torch.isfinite(graph_losses).all() or graph_losses[0] != eager_losses[0] or (
            (graph_losses - eager_losses).abs() > SCAN_RTOL * eager_losses.abs()).any():
        fail(f"scan {label}: the graph's losses {graph_losses.tolist()} vs eager "
             f"{eager_losses.tolist()} (eager again {again.tolist()})")
    if set(got) != set(want):
        fail(f"scan {label}: the graph's metrics {sorted(got)} vs eager {sorted(want)}")

    def metric_rel(a, b):
        return max(abs(float(a[n]) - float(b[n])) / max(abs(float(b[n])), 1e-12) for n in b)
    if not torch.equal(graph_bg, eager_bg):
        fail(f"scan {label}: the background generator's state after the graph differs from eager")
    if min(cg.launches[n] for n in need) < k:
        fail(f"scan {label}: the captured graph holds {cg.launches}, not {need} once a step")
    print(f"scan {label}: chunk 16-31 as one CUDA graph vs {k} eager steps from the same state: "
          f"the first loss bit for bit, losses rel {rel(graph_losses, eager_losses):.2e} (eager vs "
          f"eager {rel(again, eager_losses):.2e}), last-step metrics rel "
          f"{metric_rel(got, want):.2e} (eager vs eager {metric_rel(want_again, want):.2e}), "
          f"background generator bit for bit; captured launches {cg.launches}")

    times, peaks = {}, {}
    for scan in (1, k):
        rewind(trainer, snap)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for c in (1, 2):
            m = eager(c)[0] if scan == 1 else chunk(c)
        b.record()
        torch.cuda.synchronize()
        if not math.isfinite(float(m["loss"])):
            fail(f"scan {label}: non-finite loss at scan_steps {scan}")
        times[scan] = a.elapsed_time(b) / (2 * k)
        peaks[scan] = torch.cuda.max_memory_allocated()
    # the eval.sh refinement's mode (the field frozen: no atomics reach the
    # parameters), a new graph (warm-up, capture): the graph's chunk is the
    # eager steps' bit for bit, every loss, the last step's metrics and the
    # whole state after it
    from lsenerf_tpu_torch.engine.trainer import RunMode

    trainer.config.mode = RunMode.EVAL
    trainer.rebuild_optimizer()
    chunk(0)  # the new graph's warm-up
    snap_eval = trainer_state(trainer)
    got = chunk(1)
    eval_graph, after_graph = trainer.chunk_losses.cpu(), trainer_state(trainer)
    rewind(trainer, snap_eval)
    want, eval_eager = eager(1)
    bad = same_state(after_graph, trainer_state(trainer))
    bad += [n for n in want if not torch.equal(got[n], want[n].reshape(()))]
    if not torch.equal(eval_graph, eval_eager.cpu()) or bad or set(got) != set(want):
        fail(f"scan {label}: eval mode, the graph's chunk differs from the eager steps: losses "
             f"{eval_graph.tolist()} vs {eval_eager.tolist()}; {bad[:8]}")
    print(f"scan {label}: eval mode (the field frozen), a chunk of {k} as one graph vs eager from "
          f"one state: every loss, the last step's metrics, params, Adam's state, counts, grid and "
          f"generators bit for bit")
    launches = {kn.name: kn.launches for kn in path_kernels()}
    check_encode_pair(f"scan {label}", trainer.model_config.field.hash, launches)
    print(f"scan {label} step over steps 16-47 (2 occupancy updates): scan_steps 1 "
          f"{times[1]:.3f} ms/step, {rays / times[1] * 1e3:.0f} rays/s, peak {peaks[1] / 2**30:.2f} GiB; "
          f"scan_steps {k} {times[k]:.3f} ms/step, {rays / times[k] * 1e3:.0f} rays/s, peak "
          f"{peaks[k] / 2**30:.2f} GiB (capture {peak_capture / 2**30:.2f} GiB, reserved "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB); phase {time.time() - t0:.1f} s; {card}")
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
    import torch

    return dict(params=leaves(trainer.params), adam=trainer.adam_state(),
                opt_count=trainer.opt_count, step_count=trainer.step_count,
                occs=trainer.occ.occs.cpu().clone(), binaries=trainer.occ.binaries.cpu().clone(),
                rng=torch.cat([trainer._gen.get_state(), trainer._bg_gen.get_state()]))


def fixed_batch_loss(trainer) -> float:
    """The loss of one batch that the run's sampler never draws (its own
    sampler seed) with a fixed background: a forward pass only, whose K1
    launch is a check's and is left out of the launch counts."""
    import torch

    from lsenerf_tpu_torch.data.datamanager import MultiCamDataManager

    counts = [k.launches for k in path_kernels()]
    dm = MultiCamDataManager(trainer.dm.config, trainer.dm.col, trainer.dm.evs, seed=1234)
    batch = trainer.batch_to_device(dm.next_train(0))
    gen = torch.Generator(device=trainer.device).manual_seed(5)
    bg = torch.rand((trainer.num_rays(batch), 3), generator=gen, device=trainer.device)
    with torch.no_grad():
        loss, _ = trainer.loss_fn(trainer.params, trainer.occ, batch, trainer.step_count, bg)
    for k, n in zip(path_kernels(), counts):
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
    restored when it ends. It records a CUDA event as each train step or
    chunk of steps (Trainer.train_chunk) starts, each step's number, loss
    and the proposal's sample count it ran at, the first `keep_batches`
    batches and the step at each occupancy update; hands the loop's
    trainer to `before` and `after` (called around the training loop);
    snapshots the trainer's state and a fixed batch's loss when the loop
    saves step `snapshot_step`; and keeps the first SSIM call's inputs and
    result."""

    def __init__(self, before=None, after=None, snapshot_step=None, keep_batches=0):
        self.before, self.after, self.snapshot_step = before, after, snapshot_step
        self.calls, self.steps, self.losses, self.snapshot, self.ssim = [], [], [], None, None
        self.keep_batches, self.batches, self.proposals, self.occ_steps = keep_batches, [], [], []

    def _record(self, trainer, batches: list) -> None:
        import numpy as np
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.calls.append((trainer.step_count, len(batches), ev))
        self.steps += range(trainer.step_count, trainer.step_count + len(batches))
        self.proposals += [trainer.model_config.proposal_samples] * len(batches)
        for b in batches[:max(0, self.keep_batches - len(self.batches))]:
            self.batches.append({k: np.array(v) for k, v in b.items()})

    def __enter__(self):
        from lsenerf_tpu_torch.engine import checkpoints, loop
        from lsenerf_tpu_torch.engine.trainer import Trainer
        from lsenerf_tpu_torch.ops import metrics

        probe = self
        step0, chunk0, occ0, loop0, save0, ssim0 = (
            Trainer.step, Trainer.train_chunk, Trainer.occ_update, loop.run_training_loop,
            checkpoints.save_checkpoint, metrics.ssim)
        self._restore = [(Trainer, "step", step0), (Trainer, "train_chunk", chunk0),
                         (Trainer, "occ_update", occ0), (loop, "run_training_loop", loop0),
                         (checkpoints, "save_checkpoint", save0), (metrics, "ssim", ssim0)]
        in_chunk = []

        def step(trainer, batch, bg_color=None, **kw):
            if not in_chunk:
                probe._record(trainer, [batch])
            out = step0(trainer, batch, bg_color, **kw)
            if not in_chunk:
                probe.losses.append(out["loss"])
            return out

        def train_chunk(trainer, stacked):
            k = len(next(iter(stacked.values())))
            probe._record(trainer, [{key: v[j] for key, v in stacked.items()} for j in range(k)])
            in_chunk.append(1)
            try:
                out = chunk0(trainer, stacked)
            finally:
                in_chunk.pop()
            probe.losses += list(trainer.chunk_losses)
            return out

        def occ_update(trainer, *a, **kw):
            probe.occ_steps.append(trainer.step_count)
            return occ0(trainer, *a, **kw)

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

        Trainer.step, Trainer.train_chunk, Trainer.occ_update = step, train_chunk, occ_update
        loop.run_training_loop = run_loop
        checkpoints.save_checkpoint, metrics.ssim = save, ssim
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._restore:
            setattr(obj, name, fn)
        return False

    def step_ms(self, skip: set) -> list:
        """ms a step of each call (its start to the next call's, over its
        steps) of the run's largest calls: single steps i after the first
        16 that run no occupancy update (i % 16); or chunks after a chunk
        graph's eager warm-up and its capture (the first two), each holding
        the next chunk's occupancy update. No call with a step in `skip`
        (steps followed by an eval or a save)."""
        n_max = max(n for _, n, _ in self.calls)
        out = []
        for (i, n, a), (_, _, b) in zip(self.calls, self.calls[1:]):
            if n != n_max or any(s in skip for s in range(i, i + n)):
                continue
            if (n == 1 and i >= 16 and i % 16) or (n > 1 and i >= 2 * n):
                out.append(a.elapsed_time(b) / n)
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
    """fn() with the path kernels' launch counters set to 0 just before
    and read just after: (result, {kernel name: launches}, wall seconds)."""
    import torch

    for k in path_kernels():
        k.launches = 0
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in path_kernels()}, time.time() - t0


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


def cli_path(card: str, steps=(200, 100, 60, 100, 30, 60, 200, 60, 20), scene=None,
             device_flag=()):
    """Phases 4e and 4h: the CLI path (lsenerf_tpu_torch.train.main, in
    process) on the reference scene at the real-scale profile of
    scripts/golden_real_scale.py: train with the headline protocol and its
    cadences, resume exactly from the middle checkpoint, the eval.sh
    protocol, and an lsenerf_emb run through emb_eval.sh's two stages
    (4e); then a run with the real_scale_badnerf_ngpf32 golden's flags and
    its eval.sh (4h); then on a short scene of the same profile the render
    and viewer entry points with the 4h run's checkpoint (4i), and three
    short runs with the native prefetcher, the proposal warmup and the
    hierarchical march at coarse_factor 64 on a 256^3 grid (4j).
    `steps`: train, resume, eval.sh, emb train, emb stage 1, emb stage 2,
    ngpf32 train, its eval.sh, each 4j run. Returns the path kernels'
    launches summed over the stages."""
    import math
    import statistics
    import tempfile

    import numpy as np
    import torch

    from lsenerf_tpu_torch import parity, train
    from lsenerf_tpu_torch.data.datamanager import DataManagerConfig
    from lsenerf_tpu_torch.data.synthetic import write_reference_scene
    from lsenerf_tpu_torch.engine.config import load_config
    from lsenerf_tpu_torch.ops import march, metrics

    n_train, n_resume, n_eval, n_emb, n_pre, n_post, n_ngp, n_ngp_eval, n_knob = steps
    scene = scene or dict(n_cams=200, h=480, w=640, focal=0.9 * 640, n_val=4, texture_freq=24.0)
    total = {}
    peak = 0

    def stage(label, argv, probe, layout="blocked"):
        nonlocal peak
        torch.cuda.reset_peak_memory_stats()
        with probe:
            run_dir, launches, secs = launches_run(lambda: train.main(list(argv) + list(device_flag)))
        peak = max(peak, torch.cuda.max_memory_allocated())
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if min(launches[k] for k in LAYOUT_KERNELS[layout]) == 0:
            fail(f"{label}: a kernel of the {layout} layout was never launched: {launches}")
        check_render_kernels(label, launches)
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

        # train, saving the middle step's state for the resume: the loop
        # saves at the last step of the chunk (the CLI's SCAN steps) that
        # holds step n_train // 2 - 1
        mid = min((n_train // 2 - 1) // SCAN * SCAN + SCAN - 1, n_train - 1)
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
        print(f"4e train step (untraced, CUDA events, {len(ms)} replayed chunks of {SCAN} steps with "
              f"no cadence, each holding the next chunk's occupancy update; a chunk's ms / {SCAN}): "
              f"median {step_ms:.3f} ms/step, mean {statistics.mean(ms):.3f}, min "
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

        # 4h: the real_scale_badnerf_ngpf32 golden's flags on the same scene,
        # with scripts/golden_real_scale.py's cadences, then eval.sh
        third = n_ngp // 3
        probe = CliProbe()
        ngp_run = stage("4h ngpf32 train", [
            "lsenerf", "--data", data, "--output-dir", os.path.join(work, "ngpf32"),
            "--max-num-iterations", str(n_ngp), "--steps-per-save", str(n_ngp),
            "--steps-per-eval-image", str(third), "--steps-per-eval-all-images", str(n_ngp),
            "--steps-per-eval-batch", str(third)] + HEADLINE + parity.NGPF32, probe, layout="ngp")
        cfg = load_config(os.path.join(ngp_run, "config.yml")).pipeline.model
        if (cfg.hash_layout, cfg.compute_dtype) != ("ngp", "float32"):
            fail(f"4h: the run's config has {cfg.hash_layout}/{cfg.compute_dtype}, not ngp/float32")
        ms = probe.step_ms(skip={i for i in range(n_ngp) if (i + 1) % third == 0})
        dmc = DataManagerConfig(rgb_frac=1.0, rgb_loss_mode="deblur")
        rays = 4 * dmc.train_num_col_rays_per_batch
        step_ms = statistics.median(ms)
        print(f"4h ngpf32 train step (untraced, CUDA events, {len(ms)} replayed chunks of {SCAN} "
              f"steps with no cadence, each holding the next chunk's occupancy update): median "
              f"{step_ms:.3f} ms/step, mean {statistics.mean(ms):.3f}, min "
              f"{min(ms):.3f}, max {max(ms):.3f}; {rays} rays a step, "
              f"{rays / step_ms * 1e3:.0f} rays/s; {card}")
        print(f"4h ngpf32 train eval_mean.json ({n_ngp} steps): {json.dumps(eval_mean(ngp_run))}; "
              f"{card}")
        ngp_eval = stage("4h ngpf32 eval.sh", [
            "lsenerf", "--max-num-iterations", str(n_ngp_eval),
            "--load-dir", os.path.join(ngp_run, "checkpoints"),
            "--load-config", os.path.join(ngp_run, "config.yml"),
            "--emb_eval_mode", "zero", "--pipeline.model.eval-num-rays-per-chunk", "4096",
        ] + EVAL_FLAGS, CliProbe(), layout="ngp")
        print(f"4h ngpf32 eval.sh ({n_ngp_eval} refinement steps): "
              f"{json.dumps(eval_mean(ngp_eval))}; {card}")

        # 4i-4j on a short reference scene of the same profile
        t0 = time.time()
        short = os.path.join(work, "short_scene")
        write_reference_scene(short, with_prevnext=True, with_msk=True, with_full_camera=True,
                              **dict(scene, n_cams=4, n_val=1))
        device = device_flag[1] if device_flag else None
        for k, v in render_viewer(card, ngp_run, short, os.path.join(work, "renders"),
                                  device).items():
            total[k] = total.get(k, 0) + v
        print(f"4i render + viewer: {time.time() - t0:.1f} s wall; {card}")

        # 4j: the native prefetcher's batches and the proposal warmup's switch
        t0 = time.time()
        knob = ["--data", short, "--steps-per-save", "100000", "--steps-per-eval-batch", "100000",
                "--steps-per-eval-image", "100000", "--steps-per-eval-all-images", "100000"] + HEADLINE
        direct = {}

        def native_direct(t):
            direct["batches"] = native_batches(t, seed=96, n=2)

        probe = CliProbe(keep_batches=2, after=native_direct)
        stage("4j use_native", ["lsenerf", "--output-dir", os.path.join(work, "native"),
                                "--max-num-iterations", str(n_knob),
                                "--pipeline.datamanager.use-native", "True"] + knob, probe)
        keys = ("col_indices", "col_rgb", "evs_indices", "evs_values")
        for i, (got, want) in enumerate(zip(probe.batches, direct["batches"])):
            bad = [k for k in keys if not np.array_equal(got[k], want[k])]
            if bad:
                fail(f"4j use_native: batch {i}'s {bad} differ from the native sampler's at seed 96")
        print(f"4j use_native: the run's first {len(probe.batches)} batches equal the native "
              f"prefetcher's at seed 96, array for array ({', '.join(keys)}); {card}")
        warm = n_knob // 2
        probe = CliProbe()
        stage("4j proposal warmup", ["lsenerf", "--output-dir", os.path.join(work, "warmup"),
                                     "--max-num-iterations", str(n_knob),
                                     "--pipeline.model.proposal-warmup-steps", str(warm)] + knob,
              probe)
        want = [0] * warm + [16] * (n_knob - warm)
        if probe.proposals != want or probe.steps != list(range(n_knob)):
            fail(f"4j proposal warmup: steps {probe.steps} ran at F {probe.proposals}, not {want}")
        print(f"4j proposal warmup: steps 0-{warm - 1} without the proposal, {warm}-{n_knob - 1} "
              f"at F=16, one trainer throughout; {card}")
        # segments wider than a warp: the hierarchical march at coarse_factor 64
        seen = {}

        def march_kind(t):
            mcfg = t.model_config.march_config()
            seen.update(hier=march.use_hierarchical(t.model_config.grid, mcfg),
                        cf=mcfg.coarse_factor, wide=march._scalars(t.model_config.grid, mcfg)["wide"])

        stage("4j coarse_factor 64", ["lsenerf", "--output-dir", os.path.join(work, "cf64"),
                                      "--max-num-iterations", str(n_knob),
                                      "--pipeline.model.grid-resolution", "256",
                                      "--pipeline.model.coarse-factor", "64",
                                      "--pipeline.model.max-candidates", "4096"] + knob,
              CliProbe(after=march_kind))
        if seen != dict(hier=True, cf=64, wide=march.STATIC):
            fail(f"4j coarse_factor 64: the run's march is {seen}, not hierarchical at 64")
        print(f"4j coarse_factor 64: {n_knob} steps on a 256^3 grid through K3's hierarchical march "
              f"(segments of 64 candidates, wider than a warp); {card}")
        # chunks of SCAN_ODD steps: the occupancy updates land on JAX's steps
        # (before each chunk that covers a multiple of the interval)
        from lsenerf_tpu_torch.engine.loop import _covered

        n_odd = 3 * SCAN_ODD + 4
        graphs = {}
        probe = CliProbe(after=lambda t: graphs.update(
            {k: (cg.graph is not None, cg.launches) for k, cg in t._chunks.items()}))
        stage(f"4j scan_steps {SCAN_ODD}", ["lsenerf", "--output-dir", os.path.join(work, "scan12"),
                                             "--max-num-iterations", str(n_odd),
                                             "--machine.scan-steps", str(SCAN_ODD)] + knob, probe)
        want = [it for it in range(0, n_odd, SCAN_ODD)
                if _covered(it, 16, min(SCAN_ODD, n_odd - it))]
        chunks = [(i, n) for i, n, _ in probe.calls]
        want_chunks = [(i, SCAN_ODD) for i in range(0, 3 * SCAN_ODD, SCAN_ODD)] + [
            (i, 1) for i in range(3 * SCAN_ODD, n_odd)]
        if probe.occ_steps != want or chunks != want_chunks or not graphs.get(SCAN_ODD, (0,))[0]:
            fail(f"4j scan_steps {SCAN_ODD}: occupancy updates at {probe.occ_steps} (JAX's: {want}), "
                 f"calls {chunks}, graphs {graphs}")
        print(f"4j scan_steps {SCAN_ODD}: {n_odd} steps as chunks at {[i for i, _ in chunks[:3]]} "
              f"(the second captured, the third replayed) and {n_odd - 3 * SCAN_ODD} single steps; "
              f"occupancy updates at steps {probe.occ_steps}, JAX's; launches captured "
              f"{graphs[SCAN_ODD][1]}; 4j {time.time() - t0:.1f} s wall; {card}")
    print(f"4e-4j peak memory {peak / 2**30:.2f} GiB; launches {total}; {card}")
    return total


def native_batches(trainer, seed: int, n: int) -> list:
    """The first n batches of the native prefetcher built directly over
    the trainer's datasets and budgets (what the data manager gives it)."""
    import numpy as np

    from lsenerf_tpu_torch.data.dataset import LazyFrameArray
    from lsenerf_tpu_torch.data.native_loader import NativePrefetcher

    dm = trainer.dm
    cfg = dm.config
    col_u8 = np.ascontiguousarray(np.clip(dm.col.images * 255, 0, 255).astype(np.uint8))
    eimgs = dm.evs.eimgs
    sel = None
    if isinstance(eimgs, LazyFrameArray) and eimgs.src.dtype == np.int16:
        evs, sel = eimgs.src, eimgs.sel
    else:
        evs = np.ascontiguousarray(np.asarray(eimgs, dtype=np.float32))
    limit = len(eimgs) if dm.evs.prev_cameras is not None else min(len(eimgs), len(dm.evs.cameras) - 1)
    pf = NativePrefetcher(col_u8, cfg.train_num_col_rays_per_batch, evs,
                          cfg.train_num_evs_rays_per_batch, limit, dm.evs.e_thresh, seed=seed,
                          evs_sel=sel)
    try:
        return [pf.next() for _ in range(n)]
    finally:
        pf.close()


def render_viewer(card: str, run_dir: str, data: str, out_dir: str, device=None) -> dict:
    """Phase 4i: `python -m lsenerf_tpu_torch.render` (in process) renders
    every camera of the full trajectory of `data` with the run's
    checkpoint, and each written frame must equal render_image's output for
    that view; then the viewer's HTTP server, on 127.0.0.1:0 in a thread,
    answers GET /, GET /info and POST /render at each resolution for each
    output, and a PNG reply must decode to exactly session.render's array.
    Returns the path kernels' launches of the render and the requests.
    `device` "cpu" rehearses it with the plain versions."""
    import http.client
    import statistics
    import threading

    import numpy as np
    import torch

    from lsenerf_tpu_torch import render
    from lsenerf_tpu_torch.data.imageio import decode_png, read_png
    from lsenerf_tpu_torch.engine import renderer, viewer

    ckpt, cfg = os.path.join(run_dir, "checkpoints"), os.path.join(run_dir, "config.yml")
    _, launches, secs = launches_run(lambda: render.main([
        "--load-dir", ckpt, "--load-config", cfg, "--data", data, "--traj", "full",
        "--output-dir", out_dir] + ([] if device is None else ["--device", device])))
    if launches["ngp_encode_fwd"] == 0:
        fail(f"4i render: K7a was never launched: {launches}")
    check_render_kernels("4i render", launches, backward=False)
    trainer, col, sp, _ = render.load_trained(ckpt, cfg, data, device)
    cams = sp.all_color_cameras().to(trainer.device)
    frames = sorted(os.listdir(os.path.join(out_dir, "eval_results", "img")))
    if frames != [f"{i:03d}.png" for i in range(len(cams))]:
        fail(f"4i render: wrote {frames}, not one frame a camera of {len(cams)}")
    ids = col.appearance_ids
    frame_ms = []
    for i in range(len(cams)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = renderer.render_image(trainer.params["model"], cams, i, trainer.occ,
                                    trainer.model_config, appearance_id=int(ids[min(i, len(ids) - 1)]))
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        img = read_png(os.path.join(out_dir, "eval_results", "img", frames[i]))
        want = np.clip(out["rgb"] * 255, 0, 255).astype(np.uint8)
        if not np.array_equal(img, want):
            fail(f"4i render: frame {i} differs from render_image in "
                 f"{int((img != want).any(-1).sum())} pixels (max {int(np.abs(img.astype(int) - want).max())})")
    print(f"4i render: {len(cams)} frames of {cams.width}x{cams.height} (the full trajectory of a "
          f"{len(col.cameras)}-frame scene) through `python -m lsenerf_tpu_torch.render` in "
          f"{secs:.1f} s wall (load included), each frame equal to render_image's; render_image "
          f"{statistics.median(frame_ms):.1f} ms a frame (median, host clock, synchronised; "
          f"{1e3 / statistics.median(frame_ms):.2f} fps); launches {launches}; {card}")

    session = viewer.ViewerSession(trainer.params["model"], col.cameras.to(trainer.device),
                                   trainer.occ, trainer.model_config,
                                   appearance_id=int(col.appearance_ids[0]), image_format="png")
    session.warmup()
    srv = viewer.make_server(session, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    replies = []

    def requests():
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=120)
        conn.request("GET", "/")
        r = conn.getresponse()
        if r.status != 200 or b"lsenerf_tpu_torch" not in r.read():
            fail("4i viewer: GET / did not serve the page")
        conn.request("GET", "/info")
        r = conn.getresponse()
        info = json.loads(r.read())
        if r.status != 200 or info["resolutions"] != list(session.resolutions):
            fail(f"4i viewer: GET /info answered {r.status} {info}")
        c2w = viewer.orbit_c2w(0.6, 0.3, info["radius"], info["target"]).tolist()
        for res in info["resolutions"]:
            for output in info["outputs"]:
                body = json.dumps({"c2w": c2w, "max_dim": res, "output": output, "seq": len(replies)})
                t0 = time.perf_counter()
                conn.request("POST", "/render", body=body)
                r = conn.getresponse()
                data = r.read()
                ms = (time.perf_counter() - t0) * 1e3
                if r.status != 200:
                    fail(f"4i viewer: POST /render {res} {output}: {r.status} {data[:200]}")
                replies.append((res, output, c2w, r.getheader("Content-Type"), data, ms,
                                float(r.getheader("X-Render-Ms"))))
        conn.close()

    try:
        _, v_launches, v_secs = launches_run(requests)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    check_render_kernels("4i viewer", v_launches, backward=False)
    for res, output, c2w, ctype, data, _, _ in replies:
        if ctype != "image/png" or not np.array_equal(decode_png(data), session.render(c2w, res, output)):
            fail(f"4i viewer: the {ctype} reply at {res} {output} is not session.render's array")
    per = {r: statistics.median(x[5] for x in replies if x[0] == r) for r in session.resolutions}
    render_ms = {r: statistics.median(x[6] for x in replies if x[0] == r) for r in session.resolutions}
    print(f"4i viewer: GET /, GET /info and {len(replies)} POST /render "
          f"({', '.join(session.OUTPUTS)} at {list(session.resolutions)}), each PNG reply "
          f"decoding to session.render's array; ms a request (median, client clock) "
          f"{ {r: round(v, 2) for r, v in per.items()} }, of it the render (X-Render-Ms) "
          f"{ {r: round(v, 2) for r, v in render_ms.items()} }; {v_secs:.1f} s wall; "
          f"launches {v_launches}; {card}")
    return {k: launches[k] + v_launches[k] for k in launches}


DP_WORLD, DP_STEPS = 2, 3


def dp_trainer(device, dp=None):
    """The data-parallel phase's trainer: the badnerf preset at full width
    with the ngp layout in f32 (the real_scale_badnerf_ngpf32 golden's
    model)."""
    from lsenerf_tpu_torch.flagship import preset_trainer

    return preset_trainer("badnerf", device=device, hash_layout="ngp", compute_dtype="float32", dp=dp)


def dp_rank(rank, world, init_method, device, batches, bgs, out_dir):
    """A rank of phase 4k, spawned: gloo on the card it shares with the
    other rank, DP_STEPS steps each on its share of the global batch and
    background; saves its losses, its grid after step 0's occupancy update,
    its step times and launches, and (rank 0) the params. `device` "cpu"
    rehearses it."""
    import torch

    sys.path.insert(0, ROOT)
    from lsenerf_tpu_torch.parallel import ddp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp = ddp.init(rank, world, "gloo", init_method)
    try:
        trainer = dp_trainer(device, dp)
        for k in path_kernels():
            k.launches = 0
        losses, grid, step_ms = [], None, []
        for i, (b, bg) in enumerate(zip(batches, bgs)):
            bg = ddp.shard_rays(torch.from_numpy(bg).to(device), trainer.bundle_sizes(b), rank, world)
            t0 = time.perf_counter()
            # float() of the loss waits for the step's work on the card
            losses.append(float(trainer.step(ddp.shard_batch(b, rank, world), bg_color=bg)["loss"]))
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:  # the grid of the sharded update, the averaged gradients
                grid = (trainer.occ.occs.cpu(), trainer.occ.binaries.cpu())
                grads = step_grads(trainer)
        torch.save(dict(losses=losses, occs=grid[0], binaries=grid[1], step_ms=step_ms,
                        grads=grads if rank == 0 else None,
                        launches={k.name: k.launches for k in path_kernels()},
                        params=leaves(trainer.params) if rank == 0 else None),
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        ddp.shutdown()


def step_grads(trainer) -> dict:
    """{path: the last step's gradient, on the CPU} of the leaves that
    have one."""
    from lsenerf_tpu_torch.engine.trainer import tree_leaves

    return {p: t.grad.detach().cpu().clone() for p, t in tree_leaves(trainer.params)
            if t.grad is not None}


def params_outside(got: dict, want: dict, rtol=2e-5, atol=2e-6) -> dict:
    """{path: (elements outside rtol/atol, the leaf's elements, the largest
    difference)} of two {path: tensor} trees, for the leaves with any."""
    out = {}
    for k, w in want.items():
        diff = (got[k].float() - w.float()).abs()
        n = int((diff > atol + rtol * w.float().abs()).sum())
        if n:
            out[k] = (n, w.numel(), float(diff.max()))
    return out


def data_parallel(dev, card: str) -> dict:
    """Phase 4k: two ranks share the card over gloo (NCCL refuses two ranks
    on one device) and take DP_STEPS steps of the full-width badnerf ngp
    f32 trainer, each on its half of a fixed global batch and background,
    held against one process's steps on the whole batches: each step's loss
    within rel 1e-5 (JAX's tolerance for its mesh step); step 0's gradients,
    averaged over the ranks, within 1e-5 of each leaf's largest gradient
    (the sums run in another order); the params after the last step within
    JAX's rtol 2e-5 / atol 2e-6 but for at most 1e-3 of a leaf's elements,
    none by more than 2 lr a step: Adam's eps of 1e-15 turns a gradient
    that cancels to rounding noise into a step of up to lr, whose sign the
    summation order picks. The ranks' grids after step 0's sharded
    occupancy update must be equal bit for bit. Then one step under an
    NCCL group of world size 1. Returns the path kernels' launches of the
    ranks and the NCCL step."""
    import tempfile

    import torch
    import torch.distributed as dist

    from lsenerf_tpu_torch.parallel import ddp

    t_phase = time.time()
    ref = dp_trainer(dev)
    batches = [ref.dm.next_train(i) for i in range(DP_STEPS)]
    gen = torch.Generator(device=dev).manual_seed(11)
    bgs = [torch.rand((ref.num_rays(b), 3), generator=gen, device=dev) for b in batches]
    ref_losses, ref_grid = [], None
    for i, (b, bg) in enumerate(zip(batches, bgs)):
        ref_losses.append(float(ref.step(b, bg_color=bg)["loss"]))
        if i == 0:
            ref_grid = (ref.occ.occs.cpu(), ref.occ.binaries.cpu())
            ref_grads = step_grads(ref)
    ref_params = leaves(ref.params)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as out:
        t0 = time.time()
        ddp.spawn(dp_rank, DP_WORLD, (DP_WORLD, f"tcp://localhost:{ddp.free_port()}", str(dev),
                                      batches, [bg.cpu().numpy() for bg in bgs], out))
        spawn_s = time.time() - t0
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=True)
                 for r in range(DP_WORLD)]
    a, b = ranks
    if not (torch.equal(a["occs"], b["occs"]) and torch.equal(a["binaries"], b["binaries"])):
        fail("4k data parallel: the ranks' occupancy grids after step 0 differ")
    grid_diff = float((a["occs"] - ref_grid[0]).abs().max())
    if a["losses"] != b["losses"]:
        fail(f"4k data parallel: the ranks report different losses {a['losses']} / {b['losses']}")
    rel = [abs(x - y) / abs(y) for x, y in zip(a["losses"], ref_losses)]
    outside = params_outside(a["params"], ref_params)
    gdiff = {p: float((a["grads"][p] - g).abs().max() / g.abs().max().clamp(min=1e-30))
             for p, g in ref_grads.items()}
    print(f"4k step 0 gradients, averaged over the ranks vs one process's: max |difference| / "
          f"max |gradient| per leaf {json.dumps({p: float(f'{v:.3e}') for p, v in gdiff.items()})}")
    print(f"4k data parallel (2 gloo ranks on one card, badnerf ngp f32, {DP_STEPS} steps of "
          f"{ref.num_rays(batches[0])} rays): losses {a['losses']} vs one process {ref_losses} "
          f"(relative {[f'{x:.2e}' for x in rel]}); params after {DP_STEPS} steps outside rtol "
          f"2e-5 / atol 2e-6 (elements, of, largest difference): {outside or 'none'}; grids after "
          f"step 0 equal across ranks bit for bit, "
          f"{'equal' if grid_diff == 0 else f'{grid_diff:.2e} from'} the one process's; "
          f"{card}")
    if max(rel) > 1e-5:
        fail(f"4k data parallel: loss relative differences {rel} above 1e-5")
    if max(gdiff.values()) > 1e-5:
        fail(f"4k data parallel: step 0's averaged gradients differ from one process's: {gdiff}")
    lr = ref.config.fields_optimizer.lr
    if any(n > 1e-3 * size or worst > 2 * lr * DP_STEPS for n, size, worst in outside.values()):
        fail(f"4k data parallel: params differ from one process's beyond the bound: {outside}")
    launches = {k: a["launches"][k] + b["launches"][k] for k in a["launches"]}
    if min(launches[k] for k in LAYOUT_KERNELS["ngp"]) == 0:
        fail(f"4k data parallel: a kernel of the ngp layout was never launched: {launches}")
    check_render_kernels("4k data parallel", launches)
    print(f"4k data parallel step times on rank 0 (a correctness run, not a speed: gloo copies "
          f"each all-reduce through the host; host clock to the loss's read): "
          f"{[round(x, 3) for x in a['step_ms']]} "
          f"ms (step 0 with the sharded occupancy update); spawn to join {spawn_s:.1f} s; "
          f"launches {launches}; {card}")

    # NCCL at world size 1: the same step 0 as the one process's
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{ddp.free_port()}", rank=0,
                            world_size=1)
    try:
        trainer = dp_trainer(dev, ddp.DataParallel(0, 1))
        (loss, *_), n_launches, _ = launches_run(
            lambda: [float(trainer.step(batches[0], bg_color=bgs[0])["loss"])])
    finally:
        ddp.shutdown()
    if abs(loss - ref_losses[0]) > 1e-6 * abs(ref_losses[0]):
        fail(f"4k NCCL world 1: loss {loss} vs one process's {ref_losses[0]}")
    print(f"4k {backend} world size 1: step 0 loss {loss} vs one process's {ref_losses[0]}; launches "
          f"{n_launches}; 4k {time.time() - t_phase:.1f} s wall; {card}")
    return {k: launches[k] + n_launches[k] for k in launches}


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
    if min(launches[k] for k in LAYOUT_KERNELS["blocked"]) == 0:
        fail(f"4f tiny golden: a kernel was never launched: {launches}")
    check_render_kernels("4f tiny golden", launches)
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


# each kernel's status: "ported" (its first design) or "redesigned" (PERF.md
# §6 gives each redesign and its times)
STATUS = {
    "blocked_encode_fwd": "redesigned",
    "blocked_encode_bwd": "redesigned",
    "blocked_encode_fwd_f": "redesigned",
    "blocked_encode_bwd_f": "redesigned",
    "ngp_encode_fwd": "redesigned",
    "ngp_encode_bwd": "redesigned",
    "ngp_encode_fwd_f": "redesigned",
    "ngp_encode_bwd_f": "redesigned",
    "march_ts": "redesigned",
    "composite_fwd": "redesigned",
    "composite_bwd": "redesigned",
    "row_gather": "ported",
    "take_along": "redesigned",
    "gather_sum": "ported (a shared-memory redesign was measured and dropped)",
    "rays_fwd": "ported",
    "rays_bwd": "ported",
    "head_fwd": "ported",
    "head_bwd": "ported",
}


def main() -> int:
    import torch

    t_start = time.time()
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    sys.path.insert(0, ROOT)
    try:
        from lsenerf_tpu_torch.ops import bundles, combine, composite, cuda_build
        from lsenerf_tpu_torch.ops import field_head, gather, march, ngp
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

    from lsenerf_tpu_torch.flagship import FEATURES_4, flagship_trainer, preset_trainer

    res = check_kernels(dev)
    res.update(check_ngp(dev))
    res.update(check_generic(dev))
    res.update(check_march_composite(dev))
    check_adam(dev)
    res.update(check_bundles(dev))
    res.update(check_head(dev))
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
    check_small_step(dev, "ngp f32, coarse_stride 2, aabb field", so3, so3,
                     hash=dict(layout="ngp"),
                     field=dict(coarse_stride=2, coarse_levels=2, use_contraction=False))
    check_small_step(dev, "compact_chunk 128", so3, so3, model=dict(compact_chunk=128))
    check_small_step(dev, "blocked, 8 levels of F=4 (K1g/K2g)", so3, so3,
                     hash=dict(num_levels=8, features_per_level=4))
    check_small_step(dev, "ngp f32, 8 levels of F=4 (K7ag/K7bg)", so3, so3,
                     hash=dict(layout="ngp", num_levels=8, features_per_level=4))
    check_pretrain(dev)
    g_res, g_launches = check_gathers(dev)
    paths = {
        "flagship": flagship_trainer,
        "production": lambda d: flagship_trainer(d, production=True),
        "lsenerf_emb": lambda d: preset_trainer("lsenerf_emb", device=d),
        "badnerf": lambda d: preset_trainer("badnerf", device=d),
        "badnerf ngp f32": lambda d: preset_trainer("badnerf", device=d, hash_layout="ngp",
                                                    compute_dtype="float32"),
    }
    by_path = {p: run_path(dev, card, p, make) for p, make in paths.items()}
    by_path.update({f"scan {p}": scan_path(dev, card, p, make) for p, make in paths.items()})
    # 4v: the flagship's encode width as 8 levels of F = 4, through the
    # generic kernels, eager and as replayed chunk graphs
    wide = {
        "flagship F=4": lambda d: preset_trainer("lsenerf", False, d, hash_fields=FEATURES_4),
        "badnerf ngp f32 F=4": lambda d: preset_trainer(
            "badnerf", device=d, hash_layout="ngp", compute_dtype="float32",
            hash_fields=FEATURES_4),
    }
    for p, make in wide.items():
        by_path[f"4v {p}"] = run_path(dev, card, f"4v {p}", make)
        by_path[f"4v scan {p}"] = scan_path(dev, card, f"4v {p}", make)
    by_path["cli"] = cli_path(card)
    by_path["tiny_golden"] = tiny_golden(card)
    by_path["data_parallel"] = data_parallel(dev, card)
    launches = {k: sum(n[k] for n in by_path.values()) for k in by_path["flagship"]}
    for k in path_kernels():
        if launches[k.name] == 0:
            fail(f"{k.name} was never launched on the main paths: {launches}")
    for p, n in by_path.items():
        check_render_kernels(p, n)

    kernels = []
    for k, src_line in ((combine.K1, 58), (combine.K2, 76), (combine.K1G, 58), (combine.K2G, 76)):
        kernels.append(dict(
            name=k.name, route="cuda", source="lsenerf_tpu_torch/csrc/blocked_encode.cu",
            replaces=f"lsenerf_tpu/ops/pallas_combine.py:{src_line}",
            launches=launches[k.name], **res[k.name],
        ))
    # K7a/K7b stand in for ops the JAX package shaped around the TPU (no
    # Pallas kernel): the ngp branch of hash_encode with take_cols' gather,
    # and take_cols' table gradient with the TPU's sort-and-window one
    for k, first, rest in (
        (ngp.K7A, "lsenerf_tpu/ops/hash_encoding.py:685", ["lsenerf_tpu/ops/fast_gather.py:290"]),
        (ngp.K7B, "lsenerf_tpu/ops/fast_gather.py:312", ["lsenerf_tpu/ops/fast_gather.py:113"]),
        (ngp.K7AG, "lsenerf_tpu/ops/hash_encoding.py:685", ["lsenerf_tpu/ops/fast_gather.py:290"]),
        (ngp.K7BG, "lsenerf_tpu/ops/fast_gather.py:312", ["lsenerf_tpu/ops/fast_gather.py:113"]),
    ):
        kernels.append(dict(
            name=k.name, route="cuda", source="lsenerf_tpu_torch/csrc/ngp_encode.cu",
            replaces=first, also_replaces=rest, launches=launches[k.name], **res[k.name],
        ))
    # K3 and K5a/K5b stand in for ops the JAX package shaped around the TPU
    # (no Pallas kernel): the march with its one-hot compactions and its
    # proposal, and the composite chain with its autodiff backward
    march_lines = ["lsenerf_tpu/ops/march.py:156", "lsenerf_tpu/ops/march.py:216"]
    chain = ["lsenerf_tpu/ops/composite.py:78", "lsenerf_tpu/ops/composite.py:83",
             "lsenerf_tpu/ops/composite.py:117", "lsenerf_tpu/ops/composite.py:127"]
    for k, src, first, rest in (
        (march.K3, "march.cu", "lsenerf_tpu/ops/march.py:298", march_lines),
        (composite.K5A, "composite.cu", "lsenerf_tpu/ops/composite.py:29", chain),
        (composite.K5B, "composite.cu", "lsenerf_tpu/ops/composite.py:29", chain),
    ):
        kernels.append(dict(
            name=k.name, route="cuda", source=f"lsenerf_tpu_torch/csrc/{src}", replaces=first,
            also_replaces=rest, launches=launches[k.name], **res[k.name],
        ))
    # K8a/K8b stand in for the chain of ops that makes a step's rays (no
    # Pallas kernel): the spline, the deltas, the rays and the concatenation
    bundle_chain = ["lsenerf_tpu/cameras/pose_opt.py:169", "lsenerf_tpu/cameras/pose_opt.py:180",
                    "lsenerf_tpu/cameras/pose_opt.py:193", "lsenerf_tpu/cameras/pose_opt.py:57",
                    "lsenerf_tpu/ops/interp.py:86", "lsenerf_tpu/ops/interp.py:101",
                    "lsenerf_tpu/cameras/cameras.py:161", "lsenerf_tpu/models/lsenerf.py:420"]
    for k in (bundles.K8A, bundles.K8B):
        kernels.append(dict(
            name=k.name, route="cuda", source="lsenerf_tpu_torch/csrc/bundles.cu",
            replaces="lsenerf_tpu/cameras/cameras.py:95", also_replaces=bundle_chain,
            launches=launches[k.name], **res[k.name],
        ))
    # K9a/K9b stand in for the field's MLP head (no Pallas kernel; XLA fuses
    # the JAX package's MLPs): the base MLP, trunc_exp, SH, the colour MLP
    head_chain = ["lsenerf_tpu/models/field.py:34", "lsenerf_tpu/ops/sh.py:16",
                  "lsenerf_tpu/models/field.py:280", "lsenerf_tpu/models/mlp.py:44"]
    for k in (field_head.K9A, field_head.K9B):
        kernels.append(dict(
            name=k.name, route="cuda", source="lsenerf_tpu_torch/csrc/field_head.cu",
            replaces="lsenerf_tpu/models/field.py:145", also_replaces=head_chain,
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
    for k in kernels:
        k["status"] = STATUS[k["name"]]
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
