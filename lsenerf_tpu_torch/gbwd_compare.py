"""K2g and K7bg, the generic encode backwards, against other builds of
their C entries on the card, in one process; and the model of their L2
atomic requests.

    python -m lsenerf_tpu_torch.gbwd_compare OTHER.cu [OTHER.cu ...] [--out DIR]

Each OTHER.cu is a source of csrc/blocked_encode.cu (it defines
`blocked_encode_bwd_f` with K2g's C signature) or of csrc/ngp_encode.cu
(`ngp_encode_bwd_f`, K7bg's): an earlier commit's, for instance, written
out by `git show <commit>:lsenerf_tpu_torch/csrc/blocked_encode.cu` into a
directory that .gitignore lists. Each is built with cuda_build's flags into
a library of its own and called through the package's wrapper
(combine.encode_bwd or ngp.encode_bwd) in place of the package's library.

At F = 1, 3, 4, 6, 8 and 16 on flagship.generic_encode_uniform's 56,192
uniform samples x 8 levels (blocked: bf16 table; ngp: f32), and at F = 4
on one real step's inputs of each flagship.FEATURES_4 path, every build
must hold the plain version (dpos rtol 1e-4, atol 1e-6 of its largest
element; the table gradient within 1e-5 of its largest element; blocked
pad columns untouched), give dpos the same bits on a second call and the
same bits as every other build of its layout. Then each build is timed
warm (`timing.device_ms`) and with a cold L2 (`timing.cold_ms`) in turns
(ABBA), beside `requests`' model of the L2 atomic requests of this design
and of the first one (an OTHER's rate is printed with the first design's
count). Last, the
host's microseconds a call of the wrapper over the package's library and
over the first OTHER of each layout, in turns, at F = 4. Prints the card's
name and power limit and writes DIR/gbwd_compare.json (default
outputs/gbwd_compare). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from lsenerf_tpu_torch import flagship, kernel_compare
from lsenerf_tpu_torch.ops import combine, ngp

FEATURES = (1, 3, 4, 6, 8, 16)
K2G_CHUNK = 8  # csrc/blocked_encode.cu kGenChunk: a corner's features a K2g entry holds
ENTRIES = {"blocked": "blocked_encode_bwd_f", "ngp": "ngp_encode_bwd_f"}


# ---------------------------------------------------------------------------
# the request model
# ---------------------------------------------------------------------------


def _distinct(x: torch.Tensor) -> int:
    """The distinct values of each row of x's last dimension, summed; -1
    is no value."""
    s = x.sort(dim=-1).values
    d = 1 + (s[..., 1:] != s[..., :-1]).sum(-1)
    return int((d - (s[..., 0] < 0).long()).sum())


def _warps(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x's sample dimension `dim` as (warps, 32), the last warp padded with -1."""
    extra = -x.shape[dim] % 32
    if extra:
        pad = list(x.shape)
        pad[dim] = extra
        x = torch.cat([x, x.new_full(pad, -1)], dim)
    return x.unflatten(dim, (-1, 32))


def vec_width(F: int, table: torch.Tensor) -> int:
    """K7bg's V: the largest of 4, 2 and 1 that divides F and to whose
    width the table is aligned (the wrapper's fresh gradient always is)."""
    V = 4
    while V > 1 and (F % V or table.data_ptr() % (V * table.element_size())):
        V //= 2
    return V


def requests(layout: str, positions, table, gfeat, levels) -> tuple[int, int]:
    """The L2 atomic requests of one launch of K2g (blocked) or K7bg (ngp)
    on these inputs, (the first design's, this one's), worked out from the
    plain versions' keys on any device, not measured: one request per
    distinct 32-byte sector of the f32 gradient that one warp instruction
    adds to, zero updates not counted (the kernels skip them).

    The first design of both: a thread a sample, a warp on 32 consecutive
    samples, one scalar atomic instruction a (level, corner, feature) (K7bg:
    where the corner's weight is not 0). This K2g: a warp on one level of
    32 consecutive samples, whose 32 entries of 8 Fc updates (Fc = min(F,
    K2G_CHUNK), corner c's feature f0 + f at c Fc + f, for each chunk f0
    of the features) it adds 32 consecutive values an instruction.
    This K7bg: the first design with a vector of V values (`vec_width`) an
    instruction, which lies in one sector."""
    n, L = positions.shape[0], levels.num
    old = new = 0
    if layout == "blocked":
        F, W = levels.F, levels.row_width
        keys, o, w = combine.keys_fracs(positions, levels)
        g = gfeat.reshape(n, L, F)
        fs = torch.arange(F, device=positions.device)
        for l in range(L):
            u = [(1.0 - w[d][l], w[d][l]) for d in range(3)]
            sec = []
            for c in range(8):
                a, b, z = c >> 2, (c >> 1) & 1, c & 1
                v = ((o[0][l] + a) * 3 + o[1][l] + b) * 3 + o[2][l] + z
                upd = ((u[0][a] * u[1][b]) * u[2][z])[:, None] * g[:, l]
                addr = keys[l][:, None] * W + v[:, None] * F + fs
                sec.append(torch.where(upd != 0, addr >> 3, -1))
            sec = torch.stack(sec, 1)  # (n, 8, F): corner c's feature f
            old += _distinct(_warps(sec, 0).permute(0, 2, 3, 1))
            for f0 in range(0, F, K2G_CHUNK):
                entries = _warps(sec[:, :, f0:f0 + K2G_CHUNK].reshape(n, -1), 0)
                new += _distinct(entries.reshape(entries.shape[0], -1, 32))
        return old, new
    F = table.shape[1]
    V = vec_width(F, table)
    keys, wts, _ = ngp.corners(positions, levels)  # (8, L, n)
    fs = torch.arange(F, device=positions.device)
    for l in range(L):
        addr = keys[:, l, :, None] * F + fs  # (8, n, F)
        live = (wts[:, l] != 0)[..., None]
        old += _distinct(_warps(torch.where(live, addr >> 3, -1), 1).permute(1, 0, 3, 2))
        vec = torch.where(live, addr[..., ::V] >> 3, -1)
        new += _distinct(_warps(vec, 1).permute(1, 0, 3, 2))
    return old, new


# ---------------------------------------------------------------------------
# the comparison on the card
# ---------------------------------------------------------------------------


def through(mod, lib):
    """mod.encode_bwd (mod: combine or ngp) launching lib's entries in place
    of the package's library."""
    def call(*args):
        real = mod._library
        mod._library = lambda: lib
        try:
            return mod.encode_bwd(*args)
        finally:
            mod._library = real
    return call


def builds(others) -> dict:
    """{layout: {label: encode_bwd}}: the package's ("this") and each
    OTHER's build (its file name), by the C entry it defines."""
    fns = {layout: {"this": mod.encode_bwd} for layout, mod in (("blocked", combine),
                                                                ("ngp", ngp))}
    for label, lib in kernel_compare.build({p.name: p for p in others}).items():
        layout = next((k for k, e in ENTRIES.items() if hasattr(lib, e)), None)
        if layout is None:
            raise SystemExit(f"gbwd_compare: {label} defines neither of {list(ENTRIES.values())}")
        mod = combine if layout == "blocked" else ngp
        fns[layout][label] = through(mod, mod.bind(lib))
    return fns


def holds(layout, fns: dict, args, where) -> None:
    """Every build holds the plain version, gives dpos the same bits twice
    and the same bits as every other build."""
    mod = combine if layout == "blocked" else ngp
    wdpos, wdtab = mod.encode_bwd_plain(*args)
    first = None
    for label, fn in fns.items():
        dpos, dtab = fn(*args)
        again, _ = fn(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(dpos, wdpos, rtol=1e-4, atol=1e-6 * float(wdpos.abs().max()))
        torch.testing.assert_close(dtab, wdtab, rtol=0, atol=1e-5 * float(wdtab.abs().max()))
        if layout == "blocked" and dtab[:, 27 * args[3].F:].any():
            raise SystemExit(f"gbwd_compare: {label} at {where}: the pad columns moved")
        if not torch.equal(dpos.view(torch.int32), again.view(torch.int32)):
            raise SystemExit(f"gbwd_compare: {label} at {where}: dpos differs between two calls")
        if first is not None and not torch.equal(dpos.view(torch.int32), first.view(torch.int32)):
            raise SystemExit(f"gbwd_compare: {label} at {where}: dpos is not the bits of "
                             f"{next(iter(fns))}")
        if first is None:
            first = dpos


def shapes(dev) -> dict:
    """{layout: {shape name: (positions, table, cotangent, levels)}}."""
    out = {"blocked": {}, "ngp": {}}
    for layout, F, *args in flagship.generic_encode_uniform(FEATURES, dev):
        out[layout][f"uniform F={F}"] = tuple(args)
    for layout, args in flagship.generic_encode_steps(dev).items():
        out[layout]["one 4v step, F=4"] = args
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+", help="sources of blocked_encode.cu or ngp_encode.cu")
    ap.add_argument("--out", default="outputs/gbwd_compare")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gbwd_compare: no CUDA device", file=sys.stderr)
        return 1
    card = kernel_compare.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    fns = builds([Path(p).resolve() for p in args.others])
    inputs = shapes(dev)
    res, model, host = {}, {}, {}
    for layout, kernel in (("blocked", "K2g"), ("ngp", "K7bg")):
        for name, a in inputs[layout].items():
            holds(layout, fns[layout], a, name)
        print(f"gbwd_compare: {kernel} builds {list(fns[layout])} hold the plain version and "
              f"each other's dpos bits at {list(inputs[layout])}")
        res[kernel] = kernel_compare.abba(
            fns[layout], inputs[layout], card,
            lambda label, name, a, kernel=kernel: f"{kernel} {label} at {name} (n={a[0].shape[0]}, "
                                                  f"{a[1].dtype})")
        model[kernel] = {}
        for name, a in inputs[layout].items():
            first, this = requests(layout, *a)
            warm = {label: min(t["warm"]) for label, t in res[kernel][name].items()}
            model[kernel][name] = {"first": first, "this": this}
            print(f"{kernel} L2 atomic requests a launch at {name}, worked out from the designs "
                  f"(not measured): the first design's {first}, this one's {this}; this one's "
                  f"over this build's warm time, the first's over each other's: " + ", ".join(
                      f"{label} {t:.5f} ms, {(this if label == 'this' else first) / t / 1e6:.1f} "
                      f"G/s" for label, t in warm.items()) + f"; {card}")
        others = [label for label in fns[layout] if label != "this"]
        if others:
            at = {k: inputs[layout][k] for k in ("uniform F=4", "one 4v step, F=4")}
            host[kernel] = kernel_compare.host_turns(fns[layout]["this"], fns[layout][others[0]],
                                                     at, card, kernel)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "gbwd_compare.json").write_text(json.dumps(
        {"card": card, "results": res, "requests": model, "host_us": host}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
