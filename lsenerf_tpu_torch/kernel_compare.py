"""Other builds of a hand-written kernel's source against the package's on
the card, in one process: the A/B tool of every kernel in TABLE.

    python -m lsenerf_tpu_torch.kernel_compare KERNEL OTHER.cu [OTHER.cu ...]
        [--wrapper OLD.py] [--rays N ...] [--wide] [--only fwd|bwd] [--out DIR]

KERNEL names an entry of TABLE: K1 (K1/K2), K1g (K1g/K2g), K3, K5
(K5a/K5b), K7a (K7a/K7b), K7ag (K7ag/K7bg) or K9 (K9a/K9b, the field's
MLP head). Each OTHER.cu defines the
entry's C entries with the signatures of the package's source: an earlier
commit's source, for instance, written out by `git show
<commit>:lsenerf_tpu_torch/csrc/march.cu` into a directory that .gitignore
lists, or a patched copy. Each is copied under DIR/sources, built with
cuda_build's flags into a library of its own and called through a copy
of the package's wrapper module whose SOURCE is that copy: the same
Python over another library.

At each of the entry's shapes every build must hold the plain version at
the entry's tolerance (its kernels' `holds`); then each kernel is timed
at the entry's timed shapes warm (`timing.device_ms`: 20 calls in one
replayed CUDA graph) and with a cold L2 (`timing.cold_ms`), in turns: the
builds in order, then in reverse order (ABBA), so that a drift of the
card's clocks or of its shared host touches each alike (PERF.md §2).

  --rays N   also time the first timed shape with its rows (rays or
             samples) repeated or cut to N;
  --wide     K3's cases past its static layout (flagship.march_wide_cases),
             held and timed;
  --only     the forward (fwd) or the backward (bwd) kernels alone;
  --wrapper  an earlier wrapper module (`git show
             <commit>:lsenerf_tpu_torch/ops/march.py`), its kernels built
             from the first OTHER.cu: held to the plain version at the
             entry's host shapes, then the host's microseconds a call of the
             package's wrapper and of that one timed there in turns
             (`timing.host_us`, 400 calls a reading: package, old, old,
             package, three times).

Prints the card's name and power limit and one line a kernel, shape and
build (K9's with each shape's least times by operations: at the f32 FMA
rate, and with K9b's MMAs at the bf16 tensor-core rate,
field_head.bounds_ms), and writes DIR/<KERNEL>.json (default
outputs/kernel_compare).
Needs a CUDA card: exits 1 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Callable

import torch

from lsenerf_tpu_torch import flagship
from lsenerf_tpu_torch.models import field as field_lib
from lsenerf_tpu_torch.ops import combine, composite, cuda_build, field_head, march, ngp
from lsenerf_tpu_torch.timing import cold_ms, device_ms, host_us

FEATURES = (1, 3, 4, 6, 8, 16)  # the generic encode kernels' uniform shapes


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A kernel of an entry: its name, the wrapper function that launches
    it, "fwd" or "bwd", its arguments at a shape's inputs (None where it
    does not run there), `holds(fns, args, where)`, which raises
    SystemExit where a build ({label: wrapper}) is off the plain version,
    and `bounds(args)`, {name: ms} of the least time the work could take,
    where the entry has them."""

    name: str
    wrapper: str
    way: str
    args: Callable
    holds: Callable
    bounds: Callable = None


@dataclasses.dataclass(frozen=True)
class Entry:
    """A source's kernels: the wrapper module (its SOURCE the source), the
    C entries the source defines, the kernels, `shapes(device, wide)` ->
    ({name: inputs} held only, {name: inputs} held and timed), the timed
    shapes where --wrapper times the host, and whether it has cases past
    its layout (--wide)."""

    module: object
    entries: tuple
    kernels: tuple
    shapes: Callable
    host: tuple
    wide: bool = False


def _fail(kernel: str, label: str, where: str, what: str):
    raise SystemExit(f"kernel_compare: {kernel} {label} at {where}: {what}")


def _bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def _err(got, want) -> str:
    return f"max abs err {float((got - want).abs().max()):.3e}"


# -- the checks -------------------------------------------------------------------


def _march_holds(fns: dict, a, where: str) -> None:
    """K3's selection before the proposal is march_ts_plain's bits."""
    *rays, gcfg, cfg = a
    pre = dataclasses.replace(cfg, proposal_samples=0)
    want = march.march_ts_plain(*rays, gcfg, pre)
    for label, fn in fns.items():
        if not all(_bits(g, w) for g, w in zip(fn(*rays, gcfg, pre), want)):
            _fail("K3", label, where, "not the plain version's bits before the proposal")


def _composite_holds(name: str, plain, rtol: float):
    """K5a (rtol 1e-5) or K5b (rtol 1e-4), atol 1e-6: the plain version's
    values (a tie of early_stop_eps decided by composite.rays_off_plain's
    nudge), and the same bits on a second call."""

    def holds(fns: dict, a, where: str) -> None:
        for label, fn in fns.items():
            got, again = fn(*a), fn(*a)
            off, _ = composite.rays_off_plain(got, plain, a[:9], a[9:], rtol=rtol)
            if off.any():
                _fail(name, label, where, f"{int(off.sum())} rays off the plain version")
            if not all(torch.equal(g, h) for g, h in zip(got, again)):
                _fail(name, label, where, "other bits on a second call")

    return holds


def _encode_fwd_holds(name: str, plain, bits: bool):
    """The plain version's bits (the ngp layout) or its values at rtol 1e-5
    / atol 1e-6 (the blocked one)."""

    def holds(fns: dict, a, where: str) -> None:
        want = plain(*a)
        for label, fn in fns.items():
            got = fn(*a)
            if not (_bits(got, want) if bits else torch.allclose(got, want, rtol=1e-5, atol=1e-6)):
                _fail(name, label, where, f"off the plain version ({_err(got, want)})")

    return holds


def _encode_bwd_holds(name: str, plain, blocked: bool, same_dpos: bool):
    """dpos within rtol 1e-4 / atol 1e-6 of its largest element and the same
    bits on a second call; the table gradient within 1e-5 of its largest
    element; the blocked layout's pad columns untouched; with `same_dpos`,
    dpos the same bits in every build (the design keeps the first one's
    order of sums)."""

    def holds(fns: dict, a, where: str) -> None:
        wdpos, wdtab = plain(*a)
        first = None
        for label, fn in fns.items():
            dpos, dtab = fn(*a)
            again, _ = fn(*a)
            if not torch.allclose(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max())):
                _fail(name, label, where, f"dpos off the plain version ({_err(dpos, wdpos)})")
            if not torch.allclose(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max())):
                _fail(name, label, where, f"the table gradient off the plain version "
                                          f"({_err(dtab, wdtab)})")
            if blocked and dtab[:, 27 * a[3].F:].any():
                _fail(name, label, where, "the pad columns moved")
            if not _bits(dpos, again):
                _fail(name, label, where, "dpos differs between two calls")
            if same_dpos and first is not None and not _bits(dpos, first):
                _fail(name, label, where, f"dpos is not the bits of {next(iter(fns))}")
            first = dpos if first is None else first

    return holds


def _encode(fwd: str, bwd: str, mod, same_dpos: bool = False) -> tuple:
    """An encode pair's kernels on inputs (positions, table, cotangent or
    None, levels)."""
    blocked = mod is combine
    return (Kernel(fwd, "encode_fwd", "fwd", lambda a: (a[0], a[1], a[3]),
                   _encode_fwd_holds(fwd, mod.encode_fwd_plain, bits=not blocked)),
            Kernel(bwd, "encode_bwd", "bwd", lambda a: None if a[2] is None else a,
                   _encode_bwd_holds(bwd, mod.encode_bwd_plain, blocked, same_dpos)))


def _head_args(backward: bool):
    """K9a's or K9b's arguments to field_head.run at a shape's inputs
    (flagship.head_shapes): K9b's where the shape trains (it has
    directions), with the cotangents; on CPU tensors, where no kernel runs,
    run is handed the plain version."""

    def args(a):
        if backward and a[4] is None:
            return None
        plain = None if a[2].is_cuda else field_lib.head_plain
        return (*a[:8], *(a[8:] if backward else (None, None)), plain)

    return args


def _head_bounds(backward: bool):
    """K9a's bound at its arguments (f32 FMA), or K9b's row's (K9a saving,
    then K9b with every gradient): both at the f32 FMA rate, and K9a's
    f32 FMA time plus K9b's MMAs at the bf16 tensor-core rate
    (field_head.bounds_ms)."""

    def bounds(a):
        n, D = a[2].shape
        E, color = 0 if a[5] is None else a[5].shape[1], a[4] is not None
        fwd = field_head.bounds_ms(n, D, E, a[7], color)
        if not backward:
            return fwd
        bwd = field_head.bounds_ms(n, D, E, a[7], color, True)
        return {"f32_fma": fwd["f32_fma"] + bwd["f32_fma"],
                "tensor_cores": fwd["f32_fma"] + bwd["tensor_cores"]}

    return bounds


def _head_holds(name: str, backward: bool):
    """K9a or K9b: each output within field_head.TOLERANCE of the plain
    version (relative to its norm), and the same bits on a second call."""

    def holds(fns: dict, a, where: str) -> None:
        want = field_head.run(*a[:-1], plain=field_lib.head_plain)
        for label, fn in fns.items():
            got, again = fn(*a), fn(*a)
            off = field_head.off_plain(got, want, a[7], backward)
            if off:
                _fail(name, label, where, f"off the plain version: {off}")
            if not all((g is None and h is None) or _bits(g, h) for g, h in zip(got, again)):
                _fail(name, label, where, "other bits on a second call")

    return holds


# -- the shapes -------------------------------------------------------------------


def _blocked_steps(dev, wide):
    """K1/K2's inputs in one real step of the flagship and of lsenerf_emb."""
    return {}, {"step": flagship.step_encode_inputs(dev),
                "lsenerf_emb step": flagship.step_encode_inputs(dev, preset="lsenerf_emb")}


def _generic(layout: str):
    """The generic pair's inputs: 56,192 uniform samples x 8 levels at each
    F of FEATURES, and one real step of its FEATURES_4 path."""

    def shapes(dev, wide):
        timed = {f"uniform F={F}": tuple(a) for lay, F, *a in flagship.generic_encode_uniform(
            FEATURES, dev) if lay == layout}
        timed["one 4v step, F=4"] = flagship.generic_encode_steps(dev)[layout]
        return {}, timed

    return shapes


def _march_shapes(dev, wide):
    """K3 at the flagship's step 16 and an eval chunk (timed), the nine
    cases of flagship.march_cases (held), and with `wide` the cases past
    its static layout (both)."""
    calls = flagship.march_composite_calls(dev)
    gcfg = calls["march"][5]
    held = {label: (*a, st, gcfg, cfg) for label, *a, st, cfg in flagship.march_cases(calls)}
    timed = {"step16": calls["march"], "eval_chunk": calls["eval_march"]}
    if wide:
        timed.update((label, tuple(a)) for label, *a in flagship.march_wide_cases(calls))
    return held, timed


def _composite_shapes(dev, wide):
    """K5a/K5b at flagship.composite_shapes: composite_fwd's 9 arguments
    and the 3 cotangents."""
    shapes = flagship.composite_shapes(flagship.march_composite_calls(dev))
    return {}, {name: a + cot for name, (a, cot) in shapes.items()}


def _head_shapes(dev, wide):
    """K9a/K9b at flagship.head_shapes: the three train cells' steps, the
    occupancy update's density chunk (K9a alone) and widths of no preset."""
    return {}, flagship.head_shapes(dev)


TABLE = {
    "K1": Entry(combine, ("blocked_encode_fwd", "blocked_encode_bwd"),
                _encode("K1", "K2", combine), _blocked_steps, host=("step",)),
    "K1g": Entry(combine, ("blocked_encode_fwd_f", "blocked_encode_bwd_f"),
                 _encode("K1g", "K2g", combine, same_dpos=True), _generic("blocked"),
                 host=("uniform F=4", "one 4v step, F=4")),
    "K3": Entry(march, ("march_ts",),
                (Kernel("K3", "march_ts", "fwd", lambda a: a, _march_holds),),
                _march_shapes, host=("step16", "eval_chunk"), wide=True),
    "K5": Entry(composite, ("composite_fwd", "composite_bwd"),
                (Kernel("K5a", "composite_fwd", "fwd", lambda a: a[:9],
                        _composite_holds("K5a", composite.composite_fwd_plain, 1e-5)),
                 Kernel("K5b", "composite_bwd", "bwd", lambda a: a,
                        _composite_holds("K5b", composite.composite_bwd_plain, 1e-4))),
                _composite_shapes, host=("step", "eval_chunk")),
    "K7a": Entry(ngp, ("ngp_encode_fwd", "ngp_encode_bwd"), _encode("K7a", "K7b", ngp),
                 lambda dev, wide: ({}, flagship.ngp_encode_shapes(dev)),
                 host=("step", "eval_chunk")),
    "K7ag": Entry(ngp, ("ngp_encode_fwd_f", "ngp_encode_bwd_f"),
                  _encode("K7ag", "K7bg", ngp, same_dpos=True), _generic("ngp"),
                  host=("uniform F=4", "one 4v step, F=4")),
    "K9": Entry(field_head, ("head_fwd", "head_bwd"),
                (Kernel("K9a", "run", "fwd", _head_args(False), _head_holds("K9a", False),
                        _head_bounds(False)),
                 Kernel("K9b", "run", "bwd", _head_args(True), _head_holds("K9b", True),
                        _head_bounds(True))),
                _head_shapes, host=("lsenerf step", "occupancy chunk")),
}


def lead(inputs: tuple) -> torch.Tensor:
    """The first tensor of a shape's inputs (K9's come after its MLPs)."""
    return next(t for t in inputs if isinstance(t, torch.Tensor))


def rows(inputs: tuple, n: int) -> tuple:
    """inputs with every tensor of the first one's rows repeated or cut to
    n rows; the rest as they are."""
    m = lead(inputs).shape[0]
    reps = -(-n // m)
    return tuple(t.repeat(reps, *(1,) * (t.dim() - 1))[:n].contiguous()
                 if isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == m else t
                 for t in inputs)


# -- builds and timing ------------------------------------------------------------


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def load_module(path, name: str, source: Path):
    """The module at path (the package's wrapper, or an earlier commit's),
    registered under name first (its dataclasses look their module up; a
    name in the wrapper's package lets its relative imports resolve), its
    SOURCE set to `source`: the kernels it launches are that source's."""
    spec = importlib.util.spec_from_file_location(name, Path(path).resolve())
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.SOURCE = source
    return mod


def own_copy(src, out: Path, tag: str) -> Path:
    """src copied to out/sources/<tag>/: cuda_build.load keeps one library
    object a path, whose entries each module binds to its own argument
    types, so each module that launches a build reads a path of its own."""
    dst = out / "sources" / tag / Path(src).name
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src, dst)
    return dst.resolve()


def builds(module, others, out: Path) -> dict:
    """{label: wrapper module}: the package's ("this") and, for each other
    source (labelled by its file name), a copy of the module over its own
    copy of it (own_copy), all nvcc processes started together; prints
    each build's registers and spills."""
    srcs = {}
    for i, p in enumerate(others):
        label = Path(p).name if Path(p).name not in srcs else f"{Path(p).name} ({i + 1})"
        srcs[label] = own_copy(p, out, str(i + 1))
    built = cuda_build.build_all(list(srcs.values()))
    mods = {"this": module}
    for label, path in srcs.items():
        for line in built[path][1].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {label}: {line.strip()}")
        mods[label] = load_module(module.__file__, f"{module.__name__}_build{len(mods)}", path)
    return mods


def abba(fns: dict, shapes: dict, card: str, kernel: str, bounds=None) -> dict:
    """{shape: {label: {"warm": [ms, ms], "cold": [ms, ms]}}}: each fn(*args)
    timed at each shape warm (`timing.device_ms`) and with a cold L2
    (`timing.cold_ms`), the labels in order and then in reverse order.
    Prints a line a shape and label with the card's line, and the shape's
    bounds (`bounds(args)`, under "bounds") where given."""
    res = {}
    order = list(fns) + list(fns)[::-1]
    for name, a in shapes.items():
        r = res[name] = {label: {"warm": [], "cold": []} for label in fns}
        for label in order:
            call = lambda fn=fns[label]: fn(*a)  # noqa: E731
            r[label]["warm"].append(device_ms(call))
            r[label]["cold"].append(cold_ms(call))
        for label, t in r.items():
            print(f"{kernel} {label} at {name} {tuple(lead(a).shape)}: device ms warm {t['warm']}, "
                  f"cold L2 {t['cold']}; {card}")
        if bounds is not None:
            r["bounds"] = bounds(a)
            print(f"{kernel} bounds at {name}: " + ", ".join(
                f"{key} {ms:.5f} ms" for key, ms in r["bounds"].items()))
    return res


def host_turns(this, old, shapes: dict, card: str, kernel: str, rounds: int = 3) -> dict:
    """{shape: {"this" or "old": [us, ...]}}: the host's microseconds a call
    of the package's wrapper and of an earlier one, one timing.host_us run
    (400 calls) a reading, in turns (this, old, old, this) `rounds` times."""
    fns = {"this": this, "old": old}
    res = {}
    for name, a in shapes.items():
        r = res[name] = {"this": [], "old": []}
        for _ in range(rounds):
            for label in ("this", "old", "old", "this"):
                r[label].append(host_us(lambda fn=fns[label]: fn(*a)))  # noqa: E731
        print(f"{kernel} host us a call at {name}: this wrapper {r['this']} (median "
              f"{statistics.median(r['this'])}), the old one {r['old']} (median "
              f"{statistics.median(r['old'])}); {card}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=list(TABLE), help="the entry of TABLE")
    ap.add_argument("others", nargs="+", help="sources with the entry's C entries")
    ap.add_argument("--wrapper", help="an earlier wrapper module: time its host cost a call "
                    "against the package's, its kernels built from the first OTHER.cu")
    ap.add_argument("--rays", type=int, action="append", default=[],
                    help="also time the first timed shape with its rows repeated or cut to N")
    ap.add_argument("--wide", action="store_true", help="K3: also the cases past its static layout")
    ap.add_argument("--only", choices=("fwd", "bwd"), help="the forward or backward kernels alone")
    ap.add_argument("--out", default="outputs/kernel_compare")
    args = ap.parse_args(argv)
    entry = TABLE[args.kernel]
    if args.wide and not entry.wide:
        ap.error(f"{args.kernel} has no cases past its layout")
    if not torch.cuda.is_available():
        print("kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    out = Path(args.out)
    mods = builds(entry.module, args.others, out)
    held, timed = entry.shapes(dev, args.wide)
    first = next(iter(timed))
    for n in args.rays:
        timed[f"{first}, rows {n}"] = rows(timed[first], n)
    old = None
    if args.wrapper:
        old = load_module(args.wrapper, f"{entry.module.__name__}_old",
                          own_copy(args.others[0], out, "wrapper"))
    res, host = {}, {}
    for k in entry.kernels:
        if args.only not in (None, k.way):
            continue
        fns = {label: getattr(mod, k.wrapper) for label, mod in mods.items()}
        at = {name: k.args(a) for name, a in {**held, **timed}.items()}
        at = {name: a for name, a in at.items() if a is not None}
        for name, a in at.items():
            k.holds(fns, a, name)
        print(f"kernel_compare: {k.name} builds {list(fns)} hold the plain version at {list(at)}")
        res[k.name] = abba(fns, {name: at[name] for name in timed if name in at}, card, k.name,
                           k.bounds)
        if old is not None:
            at_host = {name: at[name] for name in entry.host if name in at}
            for name, a in at_host.items():
                k.holds({"the old wrapper": getattr(old, k.wrapper)}, a, name)
            host[k.name] = host_turns(fns["this"], getattr(old, k.wrapper), at_host, card, k.name)
    (out / f"{args.kernel}.json").write_text(json.dumps(
        {"card": card, "kernel": args.kernel, "builds": list(mods), "results": res,
         "host_us": host or None}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
