"""The readings that the limits in limits/<cell>.json are set from, taken
on the card at a cell's own sizes, many seeds in one process (the
benchmark's runs never run this):

  sound    the program against the reference, as a run's check compares
           them (the chunk replayed from the seed's start and the first
           chunk's first gradient, session.drive);
  control  the reference one step below the configuration's precision
           (the configuration's "control": fp8 for bfloat16, tf32 for
           float32) put in the program's place;
  faults   the reference put in the program's place with a fault
           planted: half of each batch left out (the mean over the
           rest).

    python3 perfbench/readings.py --workload lsenerf.train --seeds 1,2,3 \\
        --control-seeds 4,5,6 --out chiprun_out/readings

Each seed's numbers are a JSON line on standard output and in
<out>/<cell>.jsonl; the last line sums them up: the largest sound
reading and the smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def _free(dev):
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def half_batches(prog: dict) -> dict:
    """The program's readings with each batch cut to its first half of RGB
    pixels and event rays."""
    def cut(stacked):
        return {k: v[:, : max(1, v.shape[1] // 2)] for k, v in stacked.items()}

    return dict(prog, first_batches=cut(prog["first_batches"]), stacked=cut(prog["stacked"]))


def train_readings(cfg, tr, dev, seed, sc, control: bool, faults: bool) -> dict:
    from perfbench.frozen import presets
    from perfbench.frozen.ref import precision
    from perfbench.harness import checks, program, session

    ref = program.reference(cfg, sc, dev)
    params0 = program.draw_params(ref, seed)
    t = program.trainer(cfg, sc, seed, params0, dev)
    prog = session.drive(t, tr["scan_steps"], params0, tr["warm_chunks"])
    del t
    _free(dev)
    want = checks.reference_steps(ref, params0, seed, prog)
    got = {"seed": seed, "sound": _clean(checks.train_numbers(prog, want))}
    got["sound"]["batches"] = checks.check_batches([prog["first_batches"], prog["stacked"]], sc,
                                                   program.uses_events(cfg))
    got["losses"] = {"program": prog["losses"], "reference": want["losses"]}
    if control:
        with precision.lowered(cfg["control"]):
            low = checks.reference_steps(ref, params0, seed, prog)
        got["control"] = _clean(checks.train_numbers(low, want))
    if faults:
        n_col, n_evs = presets.ray_budget(cfg["preset"], cfg["rays_per_batch"])
        half = program.reference(cfg, sc, dev)
        half.s.n_col, half.s.n_evs = max(1, n_col // 2), n_evs // 2
        bad = checks.reference_steps(half, params0, seed, half_batches(prog))
        got["fault_half_batch"] = _clean(checks.train_numbers(bad, want))
    return got


def _clean(numbers: dict) -> dict:
    """The numbers, with the worst leaves moved under "leaves"."""
    numbers = dict(numbers)
    leaves = numbers.pop("_leaves", None)
    if leaves is not None:
        numbers["leaves"] = {k: v for k, v in leaves.items() if k != "left_out_of_change"}
    return numbers


def summary(rows: list) -> dict:
    out = {}
    for kind, pick in (("sound", max), ("control", min), ("fault_half_batch", min)):
        got = [r[kind] for r in rows if kind in r]
        if got:
            out[kind] = {n: pick(g[n] for g in got) for n in got[0] if n != "leaves"}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of sound runs")
    ap.add_argument("--control-seeds", default="", help="of these, the seeds that also read "
                    "the control and the faults")
    ap.add_argument("--out", default="chiprun_out/readings")
    args = ap.parse_args(argv)

    import torch

    from perfbench.harness import env, manifest, program

    env.set_caches(Path(ROOT))
    env.need_cards(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    man = manifest.manifest()
    w = manifest.cell(args.workload, man)
    cfg, tr = manifest.config(w["config"], man), manifest.traffic(w["traffic"])
    program.build_kernels(dev)
    sc = program.scene_for(cfg, dev)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    extra = {int(s) for s in args.control_seeds.split(",") if s}
    os.makedirs(args.out, exist_ok=True)
    rows = []
    with open(os.path.join(args.out, f"{args.workload}.jsonl"), "a") as f:
        for seed in seeds:
            t0 = time.perf_counter()
            row = train_readings(cfg, tr, dev, seed, sc, seed in extra, seed in extra)
            row["seconds"] = time.perf_counter() - t0
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
        line = json.dumps({"workload": args.workload, "card": env.card_power(),
                           "summary": summary(rows)})
        print(line, flush=True)
        f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
