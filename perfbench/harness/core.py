"""One run of one cell: the arguments, the manifest's files, the driver,
the per-layer readers and the result line.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, with --trace 1 `breakdown`, and
last `checks`: each compared number with its limit. The same numbers and
limits are the last lines on standard error."""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

from perfbench.harness import env, manifest


class Context:
    """What a driver is given: the cell's configuration and traffic, the
    device, the seed, the window's length, whether to trace and when the
    process started."""

    def __init__(self, workload, config, traffic, device, seed, seconds, trace, t0):
        self.workload, self.config, self.traffic = workload, config, traffic
        self.device, self.seed, self.seconds, self.trace, self.t0 = (device, seed, seconds,
                                                                     trace, t0)

    def note(self, msg: str) -> None:
        print(f"[perfbench {self.workload['name']}] {msg}", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py", description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(args, t0: float, device=None, config=None, traffic=None,
             root=manifest.ROOT) -> dict:
    """The result of one run (not printed). `device` None means the card,
    which must be there; the tests pass the CPU and a smaller `config` and
    `traffic`."""
    import torch

    man = manifest.manifest(root)
    w = manifest.cell(args.workload, man)
    if device is None:
        env.need_cards(w["chips"])
        device = torch.device("cuda")
        # the port's matmuls run in f32 with TF32 off (torch's default)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = config or manifest.config(w["config"], man, root)
    tr = traffic or manifest.traffic(w["traffic"])
    limits = manifest.limits(w["name"])
    ctx = Context(w, cfg, tr, device, args.seed, args.seconds, bool(args.trace), t0)
    if device.type == "cuda":
        ctx.note(f"card: {env.card_power()}")
    got = manifest.driver(tr).run(ctx)

    checks = {}
    for name, v in got["numbers"].items():
        checks[name] = {"value": v, "limit": limits[name]["limit"]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values()) and set(checks) == set(limits)
    result = {"correct": correct, "attempted": got["attempted"], "failed": got["failed"]}
    dev = dict(got["device"])
    if not args.trace:
        units = {m["name"]: m["unit"] for m in manifest.end_to_end(w["name"], man)}
        result["metrics"] = {n: {"value": got["e2e"][n], "unit": u} for n, u in units.items()}
    else:
        trace = got["trace"]
        families = manifest.kernel_families()
        reader_ctx = Readings(trace, families, got["work"])
        metrics = {}
        # a device metric comes from the card alone: a run elsewhere (the
        # tests') reports none
        for m in manifest.per_layer(w["name"], man) if device.type == "cuda" else []:
            v = manifest.metric_reader(m["name"]).read(reader_ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
        dev.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        result["breakdown"] = got["breakdown"]
    result["device"] = dev
    result["checks"] = checks
    return result


class Readings:
    """What a per-layer reader reads: the traced window (`trace`), the
    kernel families by name (`families`), and the work of the window that
    the driver counted from the cell's shapes and the reference pass
    (`work`)."""

    def __init__(self, trace, families, work):
        self.trace, self.families, self.work = trace, families, work

    def layer_families(self, layer: str) -> dict:
        return {n: f for n, f in self.families.items() if f["layer"] == layer}

    def device_time_s(self, layer: str) -> float:
        """Device time in s of the kernels of the layer's families."""
        pats = [p for f in self.layer_families(layer).values() for p in f["patterns"]]
        return self.trace.time_s(lambda name: any(p.search(name) for p in pats))

    def bound_s(self, layer: str):
        """The frozen bound in s of the layer's work in the window, summed
        over its families; None where no family has work there."""
        got = [manifest.bound_function(f["bound"])(self.work)
               for f in self.layer_families(layer).values() if f["bound"]]
        got = [g for g in got if g is not None]
        return sum(got) if got else None

    def roofline_pct(self, layer: str):
        b, t = self.bound_s(layer), self.device_time_s(layer)
        return None if b is None or t <= 0 else 100.0 * b / t


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(sys.argv[1:] if argv is None else argv)
    try:
        result = run_cell(args, t0)
    except env.NoCard as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    found = env.forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found} after the window; no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
