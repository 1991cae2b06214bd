"""K5a/K5b against another build of their C entries on the card, in one
process.

    python -m lsenerf_tpu_torch.k5_compare OTHER.cu [OTHER.cu ...] [--wrapper OLD.py]
        [--out DIR]

Each OTHER.cu defines `composite_fwd` and `composite_bwd` with K5a's and
K5b's C entries (csrc/composite.cu: `composite_fwd(const CompositeArgs*
args, cudaStream_t stream)`) and reads the same CompositeArgs: an earlier
commit's source, for instance, written out by `git show
<commit>:lsenerf_tpu_torch/csrc/composite.cu` into a directory that
.gitignore lists, or a patched copy of the package's (another layout, an
ablation). Each is built with cuda_build's flags into a library of its
own, beside the package's, and called through the package's wrapper.

At flagship.composite_shapes' three shapes (the flagship's step 16, 3512
x 16 with its random background and cotangents; 3510 x 48 and an eval
chunk's 4096 x 48, no background, with standard normal cotangents) every
build must hold the plain versions (forward rtol 1e-5, gradients rtol
1e-4, atol 1e-6) and give the same bits on a second call; then K5a and K5b
of every build are timed warm (`timing.device_ms`: 20 calls in one replayed
CUDA graph) and with a cold L2 (`timing.cold_ms`), in turns with the
launch floor (an empty kernel on this K5a's grid, and on the grid of a
warp a ray that the first design launched): the labels in order, then in
reverse order. `--wrapper OLD.py` loads an earlier ops/composite.py (`git
show <commit>:lsenerf_tpu_torch/ops/composite.py`), whose kernels it builds
from the first OTHER.cu, checks it against the plain versions at step 16, and times
the host's microseconds a call of the package's wrappers and of that one
at step 16 and at the eval chunk (`timing.host_us`, one run of 400 calls a
reading), in turns: package, old, old, package, three times. Prints one
line a shape and build with the card's name and power limit, and writes
the results to DIR/k5_compare.json (default outputs/k5_compare). Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from lsenerf_tpu_torch import flagship, kernel_compare
from lsenerf_tpu_torch.ops import composite


def bind(lib):
    for name in ("composite_fwd", "composite_bwd"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(composite._CompositeArgs), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def through(lib, fn):
    """fn (the package's composite_fwd or _bwd) launching lib's entry in
    place of the package's kernel."""
    def call(*args):
        real = composite._library
        composite._library = lambda: lib
        try:
            return fn(*args)
        finally:
            composite._library = real
    return call


def floor(blocks_of):
    """An empty kernel on blocks_of(n, k) blocks of 128 threads, for the
    arguments of a K5a or K5b call."""
    def call(density, *rest):
        n, k = density.shape[0], density.shape[1]
        composite.launch_empty(blocks_of(n, k), density)
    return call


def builds(others: list) -> dict:
    """{"kernel": {label: fn}} for K5a and K5b: the package's ("this"),
    each OTHER's (its file name) and the two floors."""
    libs = kernel_compare.build({p.name: p for p in others})
    floors = {"floor": floor(composite.launch_blocks),
              "floor, a warp a ray": floor(lambda n, k: -(-n // 4))}
    return {
        name: {"this": fn, **{label: through(bind(lib), fn) for label, lib in libs.items()},
               **floors}
        for name, fn in (("K5a", composite.composite_fwd), ("K5b", composite.composite_bwd))
    }


def holds(label, fwd, bwd, a, cot, where) -> None:
    """fwd(*a) and bwd(*a, *cot) hold the plain versions (a tie of
    early_stop_eps decided by composite.rays_off_plain's nudge), the same
    bits on a second call."""
    for fn, plain, extra, rtol in ((fwd, composite.composite_fwd_plain, (), 1e-5),
                                   (bwd, composite.composite_bwd_plain, cot, 1e-4)):
        got, again = fn(*a, *extra), fn(*a, *extra)
        off, _ = composite.rays_off_plain(got, plain, a, extra, rtol=rtol)
        torch.cuda.synchronize()
        if off.any() or not all(torch.equal(g, h) for g, h in zip(got, again)):
            raise SystemExit(f"k5_compare: {label} at {where}: not the plain version's "
                             f"values, or other bits on a second call")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", help="sources with K5a's and K5b's C entries")
    ap.add_argument("--wrapper", help="an earlier ops/composite.py: time its host cost a call "
                    "against the package's, its kernels built from the first OTHER.cu")
    ap.add_argument("--out", default="outputs/k5_compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = kernel_compare.card_line()
    print(f"card: {card}")
    others = [Path(p).resolve() for p in args.others]
    shapes = flagship.composite_shapes(flagship.march_composite_calls(torch.device("cuda")))
    fns = builds(others)
    labels = ["this"] + [p.name for p in others]
    for label in labels:
        for name, (a, cot) in shapes.items():
            holds(label, fns["K5a"][label], fns["K5b"][label], a, cot, name)
    print(f"k5_compare: {labels} hold the plain versions at {list(shapes)}")
    res = {}
    for kernel, kfns in fns.items():
        timed = {name: a if kernel == "K5a" else a + cot for name, (a, cot) in shapes.items()}
        res[kernel] = kernel_compare.abba(kfns, timed, card, lambda label, name, a, kernel=kernel: (
            f"{kernel} {label} at {name} ({a[4].shape[0]} x {a[4].shape[1]})"))
    host = None
    if args.wrapper:
        old = kernel_compare.load_module(args.wrapper, "k5_compare_old_composite")
        old.SOURCE = others[0]
        a, cot = shapes["step"]
        holds("the old wrapper", old.composite_fwd, old.composite_bwd, a, cot, "step")
        main_shapes = {k: shapes[k] for k in ("step", "eval_chunk")}
        host = {
            "K5a": kernel_compare.host_turns(composite.composite_fwd, old.composite_fwd,
                                             {k: a for k, (a, _) in main_shapes.items()}, card,
                                             "K5a"),
            "K5b": kernel_compare.host_turns(composite.composite_bwd, old.composite_bwd,
                                             {k: a + c for k, (a, c) in main_shapes.items()},
                                             card, "K5b"),
        }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "k5_compare.json").write_text(json.dumps(
        {"card": card, "results": res, "host_us": host}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
