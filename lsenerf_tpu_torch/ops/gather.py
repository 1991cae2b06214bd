"""Row and element gathers: three CUDA kernels, their plain versions and
their ctypes wrappers. Counterpart of the Pallas gather probes
scripts/pallas_probe.py, pallas_probe2.py, pallas_probe3.py and
pallas_probe4.py, whose seventeen `pallas_call`s compute three functions:

G1 `row_gather(table, idx)`: out[k, :] = table[idx[k], :]. Table (T, W) f32
  or bf16 with W·itemsize a multiple of 16 bytes, idx (m,) -> (m, W).
G2 `take_along(t, idx, axis)`: out[i, j] = t[idx[i, j], j] (axis 0) or
  t[i, idx[i, j]] (axis 1). t (R, C) f32 or bf16, idx of t's shape.
G3 `gather_sum(table, idx)`: out[k, :] = Σ_r table[idx[r, k], :], summed in
  order r = 0, 1, ... Table (T, W) f32 with W a multiple of 4, idx (R, n)
  -> (n, W). The kernel and the plain version add in the same order, so
  their results are bit-identical.

Index contract: indices are int32 (the plain versions also take int64). An
index outside the table (below 0, or at or past its length along the
gathered axis) gives zeros, a zero row for G3's sum, in both the kernel and
the plain version. No kernel reads outside its table, and no wrapper checks
the indices on the host, which would wait for the card. This differs from
`jnp.take`'s default fill mode, which gives NaN.

The sources are csrc/gather.cu, built and loaded by cuda_build. A wrapper
runs the plain PyTorch version for CPU tensors only; for CUDA tensors it
launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .cuda_build import Kernel

SOURCE = cuda_build.CSRC / "gather.cu"

G1 = Kernel("row_gather")
G2 = Kernel("take_along")
G3 = Kernel("gather_sum")
KERNELS = (G1, G2, G3)

_TYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _in_range(idx, n):
    return (idx >= 0) & (idx < n)


def row_gather_plain(table, idx):
    ok = _in_range(idx, table.shape[0])
    rows = table[torch.where(ok, idx, 0).long()]
    return rows.masked_fill(~ok[:, None], 0)


def take_along_plain(t, idx, axis):
    R, C = t.shape
    ok = _in_range(idx, t.shape[axis])
    safe = torch.where(ok, idx, 0).long()
    if axis == 0:
        out = t[safe, torch.arange(C, device=t.device)[None, :]]
    else:
        out = t[torch.arange(R, device=t.device)[:, None], safe]
    return out.masked_fill(~ok, 0)


def gather_sum_plain(table, idx):
    acc = torch.zeros((idx.shape[1], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for r in range(idx.shape[0]):
        acc = acc + row_gather_plain(table, idx[r])
    return acc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library():
    lib = cuda_build.load(SOURCE)
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.row_gather.argtypes = [p, p, p, i64, i, i, p]
    lib.take_along.argtypes = [p, p, p, i, i, i, i, p]
    lib.gather_sum.argtypes = [p, p, p, i, i64, i, i, p]
    for f in (lib.row_gather, lib.take_along, lib.gather_sum):
        f.restype = i
    return lib


def _card(t, ndim, name):
    if t.device.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {t.device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got {t.dim()}")
    return t.device


def _rows16(table, name):
    """The table's row width in bytes, which must be whole 16-byte pieces on
    a 16-byte aligned base."""
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 or table.data_ptr() % 16:
        raise ValueError(f"{name} rows must be whole, aligned 16-byte pieces")
    return row_bytes


def row_gather(table, idx):
    """G1: (T, W) f32/bf16 table, (m,) int32 indices -> (m, W)."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    dev = _card(table, 2, "table")
    T, W = table.shape
    cuda_build.check("table", table, _TYPES, (T, W), dev)
    cuda_build.check("idx", idx, (torch.int32,), (idx.shape[0],), dev)
    row_bytes = _rows16(table, "table")
    out = torch.empty((idx.shape[0], W), dtype=table.dtype, device=dev)
    if idx.shape[0] == 0:
        return out
    G1.count(_library().row_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], T,
        row_bytes, cuda_build.stream(table),
    ))
    return out


def _refuse_take_along(t, idx):
    """Raise ValueError naming the first check (t, idx) fails."""
    dev = _card(t, 2, "t")
    cuda_build.check("t", t, _TYPES, tuple(t.shape), dev)
    cuda_build.check("idx", idx, (torch.int32,), tuple(t.shape), dev)
    raise ValueError("t and idx do not fit the take_along kernel")


def take_along(t, idx, axis):
    """G2: (R, C) f32/bf16 t, (R, C) int32 idx, axis 0 or 1 -> (R, C).

    The kernel moves at most a few MB, so the wrapper's host time is most
    of a call's time: on the card the checks are one expression over cheap
    tensor properties, the C function is bound once (ctypes keeps it on the
    library), and the stream is read with one C call."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    if t.device.type == "cpu":
        return take_along_plain(t, idx, axis)
    if not (t.is_cuda and t.dtype in _TYPES and idx.dtype == torch.int32
            and idx.shape == t.shape and t.dim() == 2
            and idx.get_device() == t.get_device()
            and t.is_contiguous() and idx.is_contiguous()):
        _refuse_take_along(t, idx)
    out = torch.empty_like(t)
    if t.numel() == 0:
        return out
    R, C = t.shape
    G2.count(_library().take_along(
        t.data_ptr(), idx.data_ptr(), out.data_ptr(), R, C, t.element_size(),
        axis, cuda_build.stream(t),
    ))
    return out


def gather_sum(table, idx):
    """G3: (T, W) f32 table, (R, n) int32 indices -> (n, W) f32, the sum
    over r in order r = 0, 1, ..."""
    if table.device.type == "cpu":
        return gather_sum_plain(table, idx)
    dev = _card(table, 2, "table")
    _card(idx, 2, "idx")
    T, W = table.shape
    R, n = idx.shape
    cuda_build.check("table", table, (torch.float32,), (T, W), dev)
    cuda_build.check("idx", idx, (torch.int32,), (R, n), dev)
    _rows16(table, "table")
    out = torch.empty((n, W), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    G3.count(_library().gather_sum(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), R, n, T, W,
        cuda_build.stream(table),
    ))
    return out
