"""K7a against other builds of its C entry on the card, in one process.

    python -m lsenerf_tpu_torch.k7a_compare OTHER.cu [OTHER.cu ...] [--out DIR]

Each OTHER.cu defines `ngp_encode_fwd` with K7a's C signature
(csrc/ngp_encode.cu: `ngp_encode_fwd(pos, table, table_bf16, scale, out,
n, L, lo, log2_T, stream)`) and `ngp_encode_bwd` with K7b's: an earlier
commit's source, for instance, written out by `git show
<commit>:lsenerf_tpu_torch/csrc/ngp_encode.cu` into a directory that
.gitignore lists. Each is built with cuda_build's flags into a library of
its own, beside the package's own K7a.

At each shape of flagship.ngp_encode_shapes (uniform positions with an f32
and a bf16 table, the level window [4, 16), one ngp f32 badnerf step's
inputs, one eval render chunk and the step-0 occupancy update's first
density chunk) every build's output must equal the plain version's
(`encode_fwd_plain`); then each build is timed warm (`timing.device_ms`:
20 calls in one replayed CUDA graph) and with a cold L2 (`timing.cold_ms`),
in turns: the builds in order, then in reverse order, so that a drift of
the card's clocks touches each alike. Prints one line a shape and build
with the card's name and power limit, and writes the results to
DIR/k7a_compare.json (default outputs/k7a_compare). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from lsenerf_tpu_torch import flagship
from lsenerf_tpu_torch.ops import cuda_build, ngp
from lsenerf_tpu_torch.timing import cold_ms, device_ms


def builds(others) -> dict:
    """{label: fn(positions, table, levels) -> features}: the package's K7a
    ("this") and each other source's build (its file name)."""
    out = {"this": ngp.encode_fwd}
    paths = [Path(p).resolve() for p in others]
    built = cuda_build.build_all(paths)
    for path in paths:
        lib = ngp.bind(ctypes.CDLL(str(built[path][0])))

        def fwd(positions, table, lv, lib=lib, label=path.name):
            n = ngp._check(positions, table, lv)
            o = torch.empty((n, lv.num * 2), dtype=torch.float32, device=positions.device)
            err = ngp.launch_fwd(lib, positions, table, lv, o)
            if err:
                raise RuntimeError(f"{label}: ngp_encode_fwd launch failed: cudaError {err}")
            return o

        out[path.name] = fwd
    return out


def compare(fns: dict, shapes: dict, card: str) -> dict:
    """{shape: {build: {"warm": [ms, ms], "cold": [ms, ms]}}}, every build
    first checked against the plain version."""
    res = {}
    order = list(fns) + list(fns)[::-1]
    for name, (pos, table, _, lv) in shapes.items():
        want = ngp.encode_fwd_plain(pos, table, lv)
        for label, fn in fns.items():
            if not torch.equal(fn(pos, table, lv), want):
                raise SystemExit(f"k7a_compare: {label} at {name}: not the plain version's values")
        r = res[name] = {label: {"warm": [], "cold": []} for label in fns}
        for label in order:
            call = lambda fn=fns[label]: fn(pos, table, lv)  # noqa: E731
            r[label]["warm"].append(device_ms(call))
            r[label]["cold"].append(cold_ms(call))
        for label, t in r.items():
            print(f"K7a {label} at {name} (n={pos.shape[0]}, levels [{lv.lo}, {lv.lo + lv.num}), "
                  f"{table.dtype}): device ms warm {t['warm']}, cold L2 {t['cold']}; {card}")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", help="sources with K7a's C entry")
    ap.add_argument("--out", default="outputs/k7a_compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k7a_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    fns = builds(args.others)
    shapes = flagship.ngp_encode_shapes(dev)
    res = compare(fns, shapes, card)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "k7a_compare.json").write_text(json.dumps({"card": card, "results": res}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
