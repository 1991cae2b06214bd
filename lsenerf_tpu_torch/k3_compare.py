"""K3 against other builds of its C entry on the card, in one process.

    python -m lsenerf_tpu_torch.k3_compare OTHER.cu [OTHER.cu ...] [--with-table]
        [--wrapper OLD.py] [--rays N ...] [--wide] [--out DIR]

Each OTHER.cu defines `march_ts` with K3's C entry (csrc/march.cu:
`march_ts(const MarchArgs* args, cudaStream_t stream)`) and reads a prefix
of MarchArgs: an earlier commit's source, for instance, written out by
`git show <commit>:lsenerf_tpu_torch/csrc/march.cu` into a directory that
.gitignore lists. Ablations, written into DIR and built beside them:
`--with-table` adds, for each OTHER.cu whose boundary t is an f64 pow (the
first design), a copy that reads the growth table from global memory in
its place (the table alone). Every build is built with cuda_build's flags
into a library of its own, beside the package's K3.

At flagship.march_composite_calls' inputs (step 16, with its proposal, and
an eval chunk) and at the nine cases of flagship.march_cases (chip_smoke.py
3d), every build's selection before the proposal must be march_ts_plain's
bits; then each build is timed at step 16 and at the eval chunk warm
(`timing.device_ms`: 20 calls in one replayed CUDA graph) and with a cold
L2 (`timing.cold_ms`), in turns: the builds in order, then in reverse
order, so that a drift of the card's clocks touches each alike; `--rays
N` also times step 16's rays repeated or cut to N (N = 527 is about one
warp a scheduler: one ray's latency; 10x the step's rays, the rate);
`--wide` also holds every build to the plain version's bits before the
proposal at flagship.march_wide_cases (past the static layout: wider
segments, the global workspace) and times them in the same turns.
`--wrapper OLD.py` loads an earlier ops/march.py (`git show
<commit>:lsenerf_tpu_torch/ops/march.py`), whose K3 it builds from the
first OTHER.cu, checks its selection before the proposal at step 16, and
times the host's microseconds a call of the package's wrapper and of that
one at step 16 and at the eval chunk (`timing.host_us`, one run of 400
calls a reading), in turns: package, old, old, package, three times. It
prints the share of the plain version's boundary t at step 16 that lie in the
geometric branch (where the first design computed an f64 pow), one line a
shape and build with the card's name and power limit, and writes the
results to DIR/k3_compare.json (default outputs/k3_compare). Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
from pathlib import Path

import torch

from lsenerf_tpu_torch import flagship, kernel_compare
from lsenerf_tpu_torch.ops import march

_POW = "(float)pow((double)a.base, (double)g)"
_STRUCT_END = "  float lam, one_minus_lam, inv_F, F_f;\n"


def with_table(src: str) -> str:
    """The first design's source with its f64 pow replaced by a read of
    the growth table (MarchArgs gains the wrapper's `growth` field)."""
    if _POW not in src or _STRUCT_END not in src:
        raise SystemExit("k3_compare: --with-table needs the first design's ts_at and MarchArgs")
    src = src.replace(_STRUCT_END, _STRUCT_END + "  const float* growth;\n", 1)
    return src.replace(_POW, "__ldg(a.growth + (int)g)")


def sources(others, table: bool, out: Path) -> dict:
    """{label: source path}: each OTHER.cu, and the ablations written to out."""
    srcs = {Path(p).name: Path(p).resolve() for p in others}
    out.mkdir(parents=True, exist_ok=True)
    if table:
        for name, path in list(srcs.items()):
            dst = out / f"{Path(name).stem}_table.cu"
            dst.write_text(with_table(path.read_text()))
            srcs[dst.name] = dst.resolve()
    return srcs


def builds(srcs: dict, dev: int) -> dict:
    """{label: fn(o, d, nears, fars, occ_state, occ_config, config)}: the
    package's K3 ("this") and each source's build. A build's calls go
    through march_ts with a copy of the config of their own, whose launch
    calls that build's entry (march_ts finds a launch by the configs'
    identity)."""
    out = {"this": march.march_ts}
    for label, lib in kernel_compare.build(srcs).items():
        lib.march_ts.argtypes = [ctypes.POINTER(march._MarchArgs), ctypes.c_void_p]
        lib.march_ts.restype = ctypes.c_int
        own = {}

        def fn(o, d, nears, fars, st, gcfg, cfg, entry=lib.march_ts, own=own):
            key = (gcfg, cfg)
            if key not in own:
                mine = dataclasses.replace(cfg)
                ln = march._Launch(gcfg, mine, dev)
                ln.fn = entry
                own[key] = (mine, ln)
            mine, ln = own[key]
            march._LAUNCHES[(id(gcfg), id(mine), dev)] = (ln, gcfg, mine)
            return march.march_ts(o, d, nears, fars, st, gcfg, mine)

        out[label] = fn
    return out


def same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def check(fns: dict, cases: list) -> None:
    """Every build's selection before the proposal is the plain version's
    bits in every case: [(label, o, d, nears, fars, occ_state, grid config,
    march config)]."""
    for label, o, d, nears, fars, st, gcfg, cfg in cases:
        pre = dataclasses.replace(cfg, proposal_samples=0)
        want = march.march_ts_plain(o, d, nears, fars, st, gcfg, pre)
        for name, fn in fns.items():
            got = fn(o, d, nears, fars, st, gcfg, pre)
            torch.cuda.synchronize()
            if not all(same_bits(g, w) for g, w in zip(got, want)):
                raise SystemExit(f"k3_compare: {name} at {label}: not the plain version's bits")
    print(f"k3_compare: {len(fns)} builds, the plain version's bits before the proposal in "
          f"{len(cases)} cases")


def geometric_share(args) -> float:
    """The share of the plain version's boundary t (ts_at_indices'
    indices) on these inputs that lie past n_lin, in the geometric branch."""
    o, d, nears, fars, st, gcfg, cfg = args
    counts = [0, 0]
    real = march.ts_at_indices

    def watch(t_min, i, config):
        t_crit = config.render_step_size / config.cone_angle
        n_lin = torch.ceil(torch.clamp(t_crit - t_min, min=0.0) / config.render_step_size)
        n_lin = n_lin.reshape(n_lin.shape + (1,) * (i.ndim - 1))
        counts[0] += int((i > n_lin).sum())
        counts[1] += int(torch.broadcast_tensors(i, n_lin)[0].numel())
        return real(t_min, i, config)

    march.ts_at_indices = watch
    try:
        march.march_ts_plain(o, d, nears, fars, st, gcfg, dataclasses.replace(cfg,
                                                                               proposal_samples=0))
    finally:
        march.ts_at_indices = real
    return counts[0] / counts[1]


def compare(fns: dict, shapes: dict, card: str) -> dict:
    """{shape: {build: {"warm": [ms, ms], "cold": [ms, ms]}}}."""
    return kernel_compare.abba(fns, shapes, card, lambda label, name, a: (
        f"K3 {label} at {name} ({a[0].shape[0]} rays, F={a[6].proposal_samples})"))


def old_wrapper(path, src, args):
    """An earlier ops/march.py's march_ts, with its K3 built from src,
    checked against march_ts_plain's bits before the proposal on args."""
    mod = kernel_compare.load_module(path, "k3_compare_old_march")
    mod.SOURCE = Path(src).resolve()
    *rays, gcfg, cfg = args
    pre = dataclasses.replace(cfg, proposal_samples=0)
    got, want = mod.march_ts(*rays, gcfg, pre), march.march_ts_plain(*rays, gcfg, pre)
    torch.cuda.synchronize()
    if not all(same_bits(g, w) for g, w in zip(got, want)):
        raise SystemExit(f"k3_compare: {path}'s wrapper: not the plain version's bits")
    return mod.march_ts


def compare_host(old, shapes: dict, card: str, rounds: int = 3) -> dict:
    """{shape: {"this" or "old": [us, ...]}}: the host's microseconds a
    call of the package's wrapper and of old, in turns
    (kernel_compare.host_turns)."""
    return kernel_compare.host_turns(march.march_ts, old, shapes, card, "K3", rounds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", help="sources with K3's C entry")
    ap.add_argument("--with-table", action="store_true",
                    help="add each first-design source with the growth table for its pow")
    ap.add_argument("--wrapper", help="an earlier ops/march.py: time its host cost a call "
                    "against the package's, its K3 built from the first OTHER.cu")
    ap.add_argument("--rays", type=int, action="append", default=[],
                    help="also time step 16's rays repeated or cut to this many")
    ap.add_argument("--wide", action="store_true",
                    help="also check and time the cases past K3's static layout")
    ap.add_argument("--out", default="outputs/k3_compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = kernel_compare.card_line()
    print(f"card: {card}")
    out = Path(args.out)
    dev = torch.device("cuda")
    calls = flagship.march_composite_calls(dev)
    fns = builds(sources(args.others, args.with_table, out / "sources"), dev.index or 0)
    share = geometric_share(calls["march"])
    print(f"step 16: {share:.4f} of the plain version's boundary t lie in the geometric branch")
    gcfg = calls["march"][5]
    cases = [(label, *a, st, gcfg, c) for label, *a, st, c in flagship.march_cases(calls)]
    wide = flagship.march_wide_cases(calls) if args.wide else []
    check(fns, cases + wide)
    main_shapes = {"step16": calls["march"], "eval_chunk": calls["eval_march"]}
    shapes = dict(main_shapes)
    shapes.update((label, tuple(a)) for label, *a in wide)
    rays, grid = calls["march"][:4], calls["march"][4:]
    for n in args.rays:
        reps = -(-n // rays[0].shape[0])
        shapes[f"step16_rays{n}"] = tuple(
            None if t is None else t.repeat(reps, *(1,) * (t.dim() - 1))[:n].contiguous()
            for t in rays) + grid
    res = compare(fns, shapes, card)
    host = None
    if args.wrapper:
        host = compare_host(old_wrapper(args.wrapper, args.others[0], calls["march"]),
                            main_shapes, card)
    (out / "k3_compare.json").write_text(json.dumps(
        {"card": card, "geometric_share_step16": share, "results": res, "host_us": host},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
