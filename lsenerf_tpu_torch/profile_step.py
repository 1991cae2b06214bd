"""Where the flagship train step's time goes on the card.

    python -m lsenerf_tpu_torch.profile_step [--production | --preset NAME] [--warm 17] [--timed 8] [--steps 7]
        [--out outputs/profile] [--hash-layout ngp] [--compute-dtype float32] [--scan-steps 16]

Runs the flagship trainer (flagship.py), with `--production` the
production protocol's (RGB spline + deblur x4), or with `--preset` one of
the four presets' (flagship.preset_trainer: lsenerf, lsenerf_emb, badnerf,
badnerf_emb; `--hash-layout` and `--compute-dtype` change its field as
the CLI's flags do), for `--warm` steps (the occupancy updates at steps 0
and 16 among them), times `--timed` steps untraced (CUDA events), then
traces `--steps` steps with torch.profiler (CPU and CUDA activities; no
occupancy update in either window). Prints both step times, the
device's busy time per step (the union of kernel intervals on the card),
its idle share, the device time of the encode kernels (K1/K2 blocked,
K7a/K7b ngp) and of the
index kernels (the spline's knot gathers; under evs_emb also the
appearance lookup's index_select and index_add), and the top
kernels by device time; writes the full table and a Chrome trace under
`--out` (profile_step[_production|_NAME][_LAYOUT_DTYPE].txt and
..._trace.json.gz).

It also prints, for each layer of the step, its launches, device ms and
host ms a step: bundles (the rays), march, field, composite, losses (the
mappers' post-processing and the losses), backward (every kernel the
autograd backward launches, the composite's and the encode's included),
adam, and the rest ("other": batch copies, the background, metrics), each
with its top kernels by device time; then
one occupancy update, traced alone, and its share a step (1 in 16). The
layers are the program's own "layer:<name>" ranges (engine/spans.py),
which it opens while a profiler runs; a kernel counts in the outermost
layer range that was open on the host when its launching op started.
Beside that table it prints each layer's device ms a step from the
program's device marks, the events it records at each layer's end, and
the backward's launches and device ms split by the forward layer whose
ops made each autograd node (backward_split).

With `--scan-steps k` (k > 1) the steps run as the CLI runs them, k a
chunk through Trainer.make_train_step_multi (one replayed CUDA graph;
the occupancy update before each chunk that covers one): two chunks
warm up (the eager warm-up and the capture), one replayed chunk is timed
untraced and the next traced, each without its occupancy update. It
prints ms a step of both, the device's busy time a step and its idle
share over the traced chunk, the host's launches a chunk (graph launches,
kernel launches, copies) and the kernels the replay ran (the graph's
nodes), the kernels by device time, and from the program's store
(spans.snapshot()) the replay's device ms a step by layer (the marks the
graph records in its marked step, ChunkGraph.marked_steps), its counters
(steps, replays, launches with the replay's, staged bytes) and the host
ms of its spans.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import os
import subprocess
import sys

LAYERS = ("bundles", "march", "field", "composite", "losses", "backward", "adam",
          "occupancy update")


def _by_layer(events):
    """(outermost "layer:" ranges as (start, end, name), [(layer, op)] for
    each op that launched device kernels): an op counts in the outermost
    "layer:" range open on the host when it started ("other" where none
    was)."""
    ranges = sorted(
        (e.time_range.start, e.time_range.end, e.name[len("layer:"):]) for e in events
        if e.name.startswith("layer:") and e.device_type.name == "CPU")
    outer, end = [], float("-inf")
    for r in ranges:
        if r[0] >= end:
            outer.append(r)
            end = r[1]
    starts = [r[0] for r in outer]
    ops = []
    for e in events:
        if e.device_type.name != "CPU" or not e.kernels:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        ops.append((outer[i][2] if i >= 0 and e.time_range.start < outer[i][1] else "other", e))
    return outer, ops


def layer_table(events, steps: int) -> dict:
    """{layer: (launches, device ms, host ms) a step} of a trace's events:
    each device kernel counts in the outermost "layer:" range open on the
    host when the op that launched it started ("other" where none was)."""
    outer, ops = _by_layer(events)
    table = {name: [0, 0.0, 0.0] for name in LAYERS + ("other",)}
    for a, b, name in outer:
        table[name][2] += (b - a) / 1e3
    for name, e in ops:
        table[name][0] += len(e.kernels)
        table[name][1] += sum(k.duration for k in e.kernels) / 1e3
    return {k: (v[0] / steps, v[1] / steps, v[2] / steps) for k, v in table.items()}


def layer_kernels(events, steps: int, top: int = 4) -> dict:
    """{layer: its `top` kernels by device time, each (name, device ms,
    launches) a step}, kernels assigned to layers as layer_table does."""
    by = {}
    for name, e in _by_layer(events)[1]:
        for k in e.kernels:
            v = by.setdefault(name, {}).setdefault(k.name, [0.0, 0])
            v[0] += k.duration / 1e3
            v[1] += 1
    return {layer: [(k, ms / steps, n / steps) for k, (ms, n) in
                    sorted(ks.items(), key=lambda kv: -kv[1][0])[:top]]
            for layer, ks in by.items()}


def backward_split(events, steps: int, top: int = 4) -> dict:
    """{forward layer: (launches, device ms, its `top` kernels as (name, device
    ms, launches)) a step} of the backward's kernels: a kernel belongs to the
    autograd node whose range ("...Backward...") encloses the op that
    launched it, and the node to the layer of the forward op that made it
    (the same thread and sequence number: autograd's own link of a
    backward range to its forward op; ops that make no node record the
    number the next node will take, so the last forward op with a number is
    the one that made its node). Nodes with no forward op (AccumulateGrad)
    count as "accumulate grad", ops in no node's range as "no node"."""
    outer, ops = _by_layer(events)
    starts = [r[0] for r in outer]
    made = {}  # (thread, sequence number) -> the layer of the forward op
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type.name != "CPU" or e.sequence_nr < 0 or "Backward" in e.name:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i >= 0 and e.time_range.start < outer[i][1] and outer[i][2] != "backward":
            made[(e.thread, e.sequence_nr)] = outer[i][2]
    table = {}
    for layer, e in ops:
        if layer != "backward":
            continue
        node, p = None, e
        while p is not None and node is None:
            if "Backward" in p.name and p.sequence_nr >= 0:
                node = made.get((p.fwd_thread, p.sequence_nr), "no forward op")
            elif "AccumulateGrad" in p.name:
                node = "accumulate grad"
            p = p.cpu_parent
        v = table.setdefault(node or "no node", [0, 0.0, {}])
        v[0] += len(e.kernels)
        for k in e.kernels:
            v[1] += k.duration / 1e3
            kv = v[2].setdefault(k.name, [0.0, 0])
            kv[0] += k.duration / 1e3
            kv[1] += 1
    return {name: (n / steps, ms / steps,
                   [(k, kms / steps, kn / steps) for k, (kms, kn) in
                    sorted(ks.items(), key=lambda kv: -kv[1][0])[:top]])
            for name, (n, ms, ks) in sorted(table.items(), key=lambda kv: -kv[1][1])}


def print_backward_split(title: str, split: dict) -> None:
    print(f"{title}: the backward's launches and device ms a step by the forward layer "
          "whose ops made each autograd node")
    for name, (n, dev, kernels) in split.items():
        print(f"  {name:17s} {n:8.1f} launches  {dev:8.4f} ms device")
        for kname, ms, kn in kernels:
            print(f"      {ms:8.4f} ms {kn:6.1f}x  {kname[:90]}")


def print_layers(title: str, table: dict, kernels: dict = None) -> None:
    print(f"{title}: launches, device ms and host ms a step by layer")
    for name, (n, dev, host) in table.items():
        print(f"  {name:17s} {n:8.1f} launches  {dev:8.4f} ms device  {host:8.3f} ms host")
        for kname, ms, kn in (kernels or {}).get(name, []):
            print(f"      {ms:8.4f} ms {kn:6.1f}x  {kname[:90]}")
    tot = [sum(v[i] for v in table.values()) for i in range(2)]
    print(f"  {'total':17s} {tot[0]:8.1f} launches  {tot[1]:8.4f} ms device")


def print_marks(title: str, run: dict) -> None:
    """A run of the program's store (engine/spans.py): the device ms a
    marked step by layer from its device marks (all of them where it marks
    no step), its counters, and the host ms of its spans by name."""
    c = run["counters"]
    n = c["marked_steps"] or 1
    dev = run["device_ms"]
    print(f"{title}: device ms by layer from the program's marks, over {c['marked_steps']} "
          f"marked steps ({c['steps']} steps run)")
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1]):
        print(f"  {name:17s} {ms / n:8.4f} ms device")
    print(f"  {'marked':17s} {sum(dev.values()) / n:8.4f} ms device")
    print("  counters: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    host = {}
    for sp in run["spans"]:
        host[sp["name"]] = host.get(sp["name"], 0.0) + (sp["end_ns"] - sp["start_ns"]) / 1e6
    print("  host ms of its spans: " + ", ".join(f"{k} {v:.3f}" for k, v in host.items()))


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


def profile_chunk(trainer, label: str, card: str, args) -> int:
    """--scan-steps k: one replayed chunk untraced, then one traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from lsenerf_tpu_torch.engine import spans
    from lsenerf_tpu_torch.engine.loop import _covered

    k = args.scan_steps
    every = trainer.model_config.grid.update_interval
    stacks = [trainer.dm.next_train_stack(c * k, k) for c in range(4)]
    fn = trainer.make_train_step_multi(k)

    def occ(c):
        if _covered(c * k, every, k):
            trainer.occ_update()

    for c in (0, 1):  # the eager warm-up, then the capture and its replay
        occ(c)
        fn(stacks[c])
    cg = trainer._chunks[k]

    def timed(c):
        torch.cuda.synchronize()
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn(stacks[c])
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z) / k

    occ(2)
    untraced_ms = timed(2)
    occ(3)
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, spans.run():
        step_ms = timed(3)
    replay_run, = spans.snapshot()
    events = prof.events()
    dev_events = [e for e in events if e.device_type.name == "CUDA"
                  and not getattr(e, "is_user_annotation", False)]
    busy = _busy_ms(dev_events) / k
    host = {}
    for e in events:
        if e.device_type.name == "CPU" and e.name.startswith("cu"):
            host[e.name] = host.get(e.name, 0) + 1
    rays = trainer.num_rays({key: v[0] for key, v in stacks[0].items()})
    print(f"card: {card}")
    print(f"{label} chunk of {k} steps (one replayed CUDA graph) untraced {untraced_ms:.3f} ms/step "
          f"({rays / untraced_ms * 1e3:.0f} rays/s) over steps {2 * k}..{3 * k - 1}")
    print(f"{label} chunk traced {step_ms:.3f} ms/step ({rays / step_ms * 1e3:.0f} rays/s) over steps "
          f"{3 * k}..{4 * k - 1}; device busy {busy:.3f} ms/step, idle share "
          f"{1 - busy / step_ms:.3f}; {len(dev_events)} device events a chunk "
          f"({len(dev_events) / k:.0f} a step)")
    print(f"  host calls a chunk: " + ", ".join(f"{n} {c}" for n, c in sorted(host.items())))
    print(f"  kernels captured in the graph by the wrappers: {cg.launches}")
    print_marks(f"{label} replayed chunk", replay_run)
    kern = {}
    for e in dev_events:
        v = kern.setdefault(e.name, [0.0, 0])
        v[0] += (e.time_range.end - e.time_range.start) / 1e3
        v[1] += 1
    print("top device time per step:")
    for name, (t, c) in sorted(kern.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {t / k:8.4f} ms  {c / k:6.1f}x  {name[:90]}")
    os.makedirs(args.out, exist_ok=True)
    name = f"profile_chunk_{label}"
    with open(os.path.join(args.out, f"{name}.txt"), "w") as f:
        f.write(f"card: {card}\n")
        f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=60))
    prof.export_chrome_trace(os.path.join(args.out, f"{name}_trace.json.gz"))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--production", action="store_true",
                      help="trace the production protocol's trainer")
    mode.add_argument("--preset", choices=["lsenerf", "lsenerf_emb", "badnerf", "badnerf_emb"],
                      help="trace this preset's trainer (train_lse_data.sh's protocol)")
    ap.add_argument("--hash-layout", choices=["blocked", "ngp"], default="blocked")
    ap.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default="bfloat16")
    ap.add_argument("--warm", type=int, default=17)
    ap.add_argument("--timed", type=int, default=8)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--out", default="outputs/profile")
    ap.add_argument("--scan-steps", type=int, default=1,
                    help="k > 1: profile one replayed chunk of k steps (a CUDA graph)")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from lsenerf_tpu_torch.engine import spans
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
    if args.scan_steps > 1:
        return profile_chunk(trainer, label, card, args)
    interval = trainer.model_config.grid.update_interval
    traced_from = args.warm + args.timed
    n = traced_from + args.steps
    batches = [trainer.dm.next_train(i) for i in range(n)]
    if args.warm // interval != (n - 1) // interval:
        print("profile_step: the timed or traced window holds an occupancy update", file=sys.stderr)
    for b in batches[: args.warm]:
        trainer.step(b)
    torch.cuda.synchronize()

    def timed(steps):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for b in steps:
            trainer.step(b)
        z.record()
        torch.cuda.synchronize()
        return a.elapsed_time(z) / len(steps)

    untraced_ms = timed(batches[args.warm : traced_from])
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof, spans.run():
        step_ms = timed(batches[traced_from:])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as occ_prof, \
            spans.run():
        trainer.occ_update()
        torch.cuda.synchronize()
    steps_run, occ_run = spans.snapshot()

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
    print(f"{label} step untraced {untraced_ms:.3f} ms ({rays / untraced_ms * 1e3:.0f} rays/s) over "
          f"steps {args.warm}..{traced_from - 1}")
    print(f"{label} step {step_ms:.3f} ms ({rays / step_ms * 1e3:.0f} rays/s) over "
          f"{args.steps} traced steps; device busy {busy:.3f} ms/step, idle share "
          f"{1 - busy / step_ms:.3f}; kernel time sum {total_dev:.3f} ms/step; "
          f"{len(dev_events) / args.steps:.0f} device events/step")
    names = {"encode_fwd_kernel": "K1", "encode_bwd_kernel": "K2", "ngp_fwd_kernel": "K7a",
             "ngp_bwd_kernel": "K7b", "march_kernel": "K3", "composite_fwd_kernel": "K5a",
             "composite_bwd_kernel": "K5b", "rays_fwd_kernel": "K8a", "rays_bwd_kernel": "K8b",
             "rays_sum_kernel": "K8b's sums"}
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
    print_layers(f"{label} step, traced (layer ranges on)", layer_table(prof.events(), args.steps),
                 layer_kernels(prof.events(), args.steps))
    print_backward_split(f"{label} step's backward", backward_split(prof.events(), args.steps))
    print_marks(f"{label} step", steps_run)
    occ = layer_table(occ_prof.events(), 1)
    print_layers("one occupancy update, traced alone", occ)
    print_marks("one occupancy update", occ_run)
    n_occ, dev_occ = sum(v[0] for v in occ.values()), sum(v[1] for v in occ.values())
    print(f"  a step's share at 1 update in {interval} steps: {n_occ / interval:.1f} launches, "
          f"{dev_occ / interval:.4f} ms device")
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
