"""The row-gather probe: every case of the Pallas gather probes
(scripts/pallas_probe.py, pallas_probe2.py, pallas_probe3.py,
pallas_probe4.py) through the port's three gather kernels (ops/gather.py).

    python -m lsenerf_tpu_torch.gather_probe              # on the card
    python -m lsenerf_tpu_torch.gather_probe --device cpu --reduced

Each case runs at its script's shapes, checks its result bit for bit
against numpy, as the scripts check theirs, and prints its name, OK or
WRONG, and the median time of the port's call between CUDA events (on the
CPU no time is taken). The exit code is 1 if any case is WRONG.

The cases, by kernel:
  G1 row_gather: A-E (2048x64 f32 table, 512 indices; E pads them to 2048
     and slices), F (2048x128, the (T,1) index), S1 and S2 (512x128; S2
     is the block slice t[17:81]), and P5 (pallas_probe4.py).
  G2 take_along: E2, E3, G (bf16), M1 (axis 0), M2, M3 (axis 1) and R1
     (the roll by 64 lanes, as a take_along along axis 1).
  G3 gather_sum: H (64 gathers of 8192 rows from 8192x128, summed).
P5's `unroll` (u1/u8) and `chunk` are Mosaic loop knobs with no counterpart
here, so each of its two shapes runs once: P5-A/B (16,384x64 f32 table,
2^20 rows) and P5-C/D (199,680x64 bf16, 2,697,216 rows, the flagship's
row-gather count). `--reduced` cuts both to a 512-row table and 4096 rows,
for a quick run on the CPU.

Inputs come from numpy generators seeded with 0, one per script, drawn in
the order the scripts draw them (P5 draws only the shapes it runs).
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from . import resolve_device
from .ops import gather
from .ops.cuda_build import Kernel
from .timing import time_ms

P5_FLAGSHIP_ROWS = 3512 * 48 * 16  # 2,697,216


@dataclass
class Case:
    name: str
    kernel: Kernel
    call: Callable[[], torch.Tensor]  # the port's function on device tensors
    want: np.ndarray  # the expected result's raw bits


def bits(x) -> np.ndarray:
    """The raw bits of a tensor or a numpy f32 array, as a numpy array."""
    if isinstance(x, np.ndarray):
        return x.view(np.int32)
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[x.dtype]
    return x.detach().cpu().contiguous().view(as_int).numpy()


def _on(device):
    return lambda a: torch.from_numpy(a).to(device)


def _probe1(device):
    to = _on(device)
    T, W, C = 2048, 64, 512
    rng = np.random.default_rng(0)
    table = rng.standard_normal((T, W), dtype=np.float32)
    idx = rng.integers(0, T, C).astype(np.int32)
    want = bits(table[idx])
    t, i = to(table), to(idx)
    for name in ("A take(axis=0)", "B take_along_axis bcast",
                 "C fori dynamic-slice rows", "D one-hot matmul"):
        yield Case(name, gather.G1, lambda: gather.row_gather(t, i), want)
    ipad = np.zeros(T, np.int32)
    ipad[:C] = idx
    ip = to(ipad)
    yield Case("E full-height dynamic_gather", gather.G1,
               lambda: gather.row_gather(t, ip)[:C], want)


def _probe2(device):
    to = _on(device)
    rng = np.random.default_rng(0)
    T, W = 2048, 128
    t_np = rng.standard_normal((T, W), dtype=np.float32)
    i_np = rng.integers(0, T, T).astype(np.int32)
    t, i, i2d = to(t_np), to(i_np), to(np.broadcast_to(i_np[:, None], (T, W)).copy())
    yield Case("E2 tala 2d-idx W=128", gather.G2,
               lambda: gather.take_along(t, i2d, 0), bits(t_np[i_np]))
    T3, W3 = 2048, 64
    t3_np = rng.standard_normal((T3, W3), dtype=np.float32)
    i3_np = rng.integers(0, T3, T3).astype(np.int32)
    t3, i3 = to(t3_np), to(np.broadcast_to(i3_np[:, None], (T3, W3)).copy())
    yield Case("E3 tala 2d-idx W=64", gather.G2,
               lambda: gather.take_along(t3, i3, 0), bits(t3_np[i3_np]))
    yield Case("F in-kernel bcast (T,1)", gather.G1,
               lambda: gather.row_gather(t, i), bits(t_np[i_np]))
    tb_cpu = torch.from_numpy(t_np).to(torch.bfloat16)
    tb = tb_cpu.to(device)
    yield Case("G tala bf16", gather.G2,
               lambda: gather.take_along(tb, i2d, 0), bits(tb_cpu)[i_np])
    TH, WH, REPS = 8192, 128, 64
    th_np = rng.standard_normal((TH, WH), dtype=np.float32)
    ih_np = rng.integers(0, TH, (REPS, TH)).astype(np.int32)
    want = th_np[ih_np[0]] * 0
    for r in range(REPS):  # in order, as pallas_probe2.py sums
        want = want + th_np[ih_np[r]]
    th, ih = to(th_np), to(ih_np)
    yield Case("H throughput", gather.G3, lambda: gather.gather_sum(th, ih), bits(want))


def _probe3(device):
    to = _on(device)
    rng = np.random.default_rng(0)
    t8_np = rng.standard_normal((8, 128), dtype=np.float32)
    i8_np = rng.integers(0, 8, (8, 128)).astype(np.int32)
    t8, i8 = to(t8_np), to(i8_np)
    yield Case("M1 (8,128) dims0", gather.G2, lambda: gather.take_along(t8, i8, 0),
               bits(np.take_along_axis(t8_np, i8_np, axis=0)))
    i8l_np = rng.integers(0, 128, (8, 128)).astype(np.int32)
    i8l = to(i8l_np)
    yield Case("M2 (8,128) dims1", gather.G2, lambda: gather.take_along(t8, i8l, 1),
               bits(np.take_along_axis(t8_np, i8l_np, axis=1)))
    t1k_np = rng.standard_normal((1024, 128), dtype=np.float32)
    i1k_np = rng.integers(0, 128, (1024, 128)).astype(np.int32)
    t1k, i1k = to(t1k_np), to(i1k_np)
    yield Case("M3 (1024,128) dims1", gather.G2, lambda: gather.take_along(t1k, i1k, 1),
               bits(np.take_along_axis(t1k_np, i1k_np, axis=1)))
    TS, WS, CS = 512, 128, 64
    ts_np = rng.standard_normal((TS, WS), dtype=np.float32)
    is_np = rng.integers(0, TS, CS).astype(np.int32)
    ts, is_ = to(ts_np), to(is_np)
    yield Case("S1 SMEM-idx loop rows", gather.G1,
               lambda: gather.row_gather(ts, is_), bits(ts_np[is_np]))
    block = to(17 + np.arange(CS, dtype=np.int32))
    yield Case("S2 dynamic block slice", gather.G1,
               lambda: gather.row_gather(ts, block), bits(ts_np[17:17 + CS]))
    # roll by 64 along axis 1: out[i, j] = t[i, (j - 64) mod 128]
    roll = to(np.broadcast_to((np.arange(128, dtype=np.int32) - 64) % 128, (8, 128)).copy())
    yield Case("R1 static roll lanes", gather.G2, lambda: gather.take_along(t8, roll, 1),
               bits(np.roll(t8_np, 64, axis=1)))


def _probe4(device, reduced):
    to = _on(device)
    rng = np.random.default_rng(0)
    shapes = (("P5-A/B 16k x 64 f32", 16384, 2**20, torch.float32),
              ("P5-C/D flagship 200k x 64 bf16", 199680, P5_FLAGSHIP_ROWS, torch.bfloat16))
    for name, T, m, dtype in shapes:
        if reduced:
            T, m = 512, 4096
        table_cpu = torch.from_numpy(rng.standard_normal((T, 64)).astype(np.float32)).to(dtype)
        idx_np = rng.integers(0, T, m).astype(np.int32)
        table, idx = table_cpu.to(device), to(idx_np)
        yield Case(f"{name} x {m} rows", gather.G1,
                   lambda table=table, idx=idx: gather.row_gather(table, idx),
                   bits(table_cpu)[idx_np])


def cases(device, reduced=False):
    """Every probe case, with its inputs on `device`, made as it is reached."""
    yield from _probe1(device)
    yield from _probe2(device)
    yield from _probe3(device)
    yield from _probe4(device, reduced)


def run(device, reduced=False, reps=10) -> list[dict]:
    """Run, check and (on the card) time every case; print a line each."""
    results = []
    for c in cases(device, reduced):
        got = bits(c.call())
        ok = got.shape == c.want.shape and np.array_equal(got, c.want)
        ms = time_ms(c.call, reps) if device.type == "cuda" else None
        when = f"{ms:.4f} ms" if ms is not None else "time not measured on the CPU"
        print(f"{c.name}: {'OK' if ok else 'WRONG'} [{c.kernel.name}] {when}", flush=True)
        results.append(dict(name=c.name, kernel=c.kernel.name, ok=ok, ms=ms))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions; default: the card")
    ap.add_argument("--reduced", action="store_true",
                    help="cut P5 to a 512-row table and 4096 rows")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(device)}")
    results = run(device, args.reduced)
    wrong = [r["name"] for r in results if not r["ok"]]
    print(f"{len(results) - len(wrong)}/{len(results)} cases OK"
          + (f"; WRONG: {wrong}" if wrong else ""))
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
