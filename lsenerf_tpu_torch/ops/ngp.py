"""The ngp hash encode's two CUDA kernels, their plain versions and their
ctypes wrappers. Counterpart of the ngp branch of
lsenerf_tpu/ops/hash_encoding.py::hash_encode and of
lsenerf_tpu/ops/fast_gather.py::take_cols.

K7a `encode_fwd`: unit positions (n, 3) + table (L_all*T, F) -> features
(n, Lw*F) over the level window [lo, lo + Lw). It replaces the 8 hashed
corner gathers a sample-level of hash_encoding.py:685 (`take_cols`,
fast_gather.py:290) and the weighted corner sum.

K7b `encode_bwd`: positions + table + cotangent (n, Lw*F) -> (dpos (n, 3),
dtable (L_all*T, F)). It replaces take_cols' table gradient
(fast_gather.py:312: a scatter-add, or on the TPU the sort-and-window
`sorted_window_accumulate`, :113) with exact f32 atomics, and the position
gradient through the trilinear weights.

The table is (L_all*T, F) row-major, where the JAX package stores the
transpose (F, L_all*T): `convert.ngp_table_from_jax` maps one to the other.
F, the features a level, is the table's width. At F = 2 the wrappers launch
K7a/K7b; at any other F the generic kernels K7ag `ngp_encode_fwd_f` and
K7bg `ngp_encode_bwd_f`, which take F as an argument.
The sources are csrc/ngp_encode.cu, built and loaded by cuda_build. A
wrapper runs the plain PyTorch version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import cuda_build
from .cuda_build import Kernel

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

SOURCE = cuda_build.CSRC / "ngp_encode.cu"

K7A = Kernel("ngp_encode_fwd")
K7B = Kernel("ngp_encode_bwd")
K7AG = Kernel("ngp_encode_fwd_f")
K7BG = Kernel("ngp_encode_bwd_f")
KERNELS = (K7A, K7B, K7AG, K7BG)


@dataclass(frozen=True, eq=False)
class Levels:
    """The level window of one encode, on one device.

    scale: (Lw,) f32 grid resolutions of levels lo .. lo + Lw - 1; lo: the
    window's first level; log2_T: log2 of the entries a level; levels: the
    ladder's level count, which sets the table's rows (levels * 2^log2_T)."""

    scale: torch.Tensor
    lo: int
    log2_T: int
    levels: int

    @property
    def num(self) -> int:
        return self.scale.shape[0]

    @property
    def table_rows(self) -> int:
        return self.levels << self.log2_T


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def corners(positions: torch.Tensor, lv: Levels):
    """(n, 3) unit positions -> the 8 corners' global table entries (8, Lw,
    n) int64, their weights (8, Lw, n) f32, and the fractions w, a list of
    three (Lw, n) tensors. Corners in JAX's order (x outer, z inner). The
    hash is JAX's uint32 one, done in int64 and masked to 32 bits after each
    product, so it wraps as uint32 does."""
    s = [positions[None, :, d] * lv.scale[:, None] for d in range(3)]  # (Lw, n)
    fl = [torch.floor(x) for x in s]
    w = [x - f for x, f in zip(s, fl)]
    b = [f.long() for f in fl]
    mask = (1 << lv.log2_T) - 1
    off = (torch.arange(lv.num, device=positions.device)[:, None] + lv.lo) << lv.log2_T
    keys, weights = [], []
    for i in (0, 1):
        wx = w[0] if i else 1.0 - w[0]
        hx = ((b[0] + i) & _U32) * _PRIMES[0] & _U32
        for j in (0, 1):
            wy = w[1] if j else 1.0 - w[1]
            hy = ((b[1] + j) & _U32) * _PRIMES[1] & _U32
            for k in (0, 1):
                wz = w[2] if k else 1.0 - w[2]
                hz = ((b[2] + k) & _U32) * _PRIMES[2] & _U32
                keys.append(((hx ^ hy ^ hz) & mask) + off)
                weights.append(wx * wy * wz)
    return torch.stack(keys), torch.stack(weights), w


def _gather(table, keys):
    return table.index_select(0, keys.reshape(-1)).float().reshape(*keys.shape, table.shape[1])


def encode_fwd_plain(positions, table, lv: Levels) -> torch.Tensor:
    n, F = positions.shape[0], table.shape[1]
    keys, wts, _ = corners(positions, lv)
    vals = _gather(table, keys) * wts[..., None]  # (8, Lw, n, F)
    # the corners added one at a time, in order, as K7a adds them: the
    # result is then the same bits whatever the shape
    feats = vals[0]
    for c in range(1, 8):
        feats = feats + vals[c]
    return feats.permute(1, 0, 2).reshape(n, lv.num * F)


def encode_bwd_plain(positions, table, gfeat, lv: Levels):
    n, F = positions.shape[0], table.shape[1]
    keys, wts, w = corners(positions, lv)
    g = gfeat.reshape(n, lv.num, F).permute(1, 0, 2)  # (Lw, n, F)
    dW = (_gather(table, keys) * g[None]).sum(-1)  # (8, Lw, n)
    # the chain rule through weight = (wx' * wy') * wz' in autodiff's
    # order, then wx' = wx or 1 - wx
    u = [(1.0 - x, x) for x in w]
    dw = [torch.zeros_like(w[0]) for _ in range(3)]
    for c in range(8):
        ux, uy, uz = u[0][c >> 2], u[1][(c >> 1) & 1], u[2][c & 1]
        dxy = dW[c] * uz
        for d, term in enumerate((dxy * uy, dxy * ux, dW[c] * (ux * uy))):
            dw[d] = dw[d] + term if (c >> (2 - d)) & 1 else dw[d] - term
    dpos = torch.stack([(x * lv.scale[:, None]).sum(0) for x in dw], 1)
    upd = (wts[..., None] * g[None]).reshape(-1, F)
    dtable = torch.zeros((lv.table_rows, F), dtype=torch.float32, device=positions.device)
    dtable.index_add_(0, keys.reshape(-1), upd)
    return dpos, dtable


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ngp_encode library's entries (a
    source without the generic kernels' entries binds the first two)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ngp_encode_fwd.argtypes = [p, p, i, p, p, i, i, i, i, p]
    lib.ngp_encode_fwd.restype = i
    lib.ngp_encode_bwd.argtypes = [p, p, i, p, p, p, p, i, i, i, i, p]
    lib.ngp_encode_bwd.restype = i
    if hasattr(lib, "ngp_encode_fwd_f"):
        lib.ngp_encode_fwd_f.argtypes = [p, p, i, p, p, i, i, i, i, i, p]
        lib.ngp_encode_fwd_f.restype = i
        lib.ngp_encode_bwd_f.argtypes = [p, p, i, p, p, p, p, i, i, i, i, i, p]
        lib.ngp_encode_bwd_f.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(cuda_build.load(SOURCE))


_TABLE_TYPES = (torch.bfloat16, torch.float32)


def _check(positions, table, lv: Levels, gfeat=None) -> int:
    """The sample count n, where the kernels take these inputs; else
    ValueError naming the first check that fails."""
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    n = positions.shape[0]
    if table.dim() != 2 or table.shape[1] < 1:
        raise ValueError(f"table has shape {tuple(table.shape)}, expected (rows, F >= 1)")
    F = table.shape[1]
    cuda_build.check("positions", positions, (torch.float32,), (n, 3), dev)
    cuda_build.check("table", table, _TABLE_TYPES, (lv.table_rows, F), dev)
    cuda_build.check("levels.scale", lv.scale, (torch.float32,), (lv.num,), dev)
    if gfeat is not None:
        cuda_build.check("gfeat", gfeat, (torch.float32,), (n, lv.num * F), dev)
    if not 0 <= lv.lo and lv.lo + lv.num <= lv.levels:
        raise ValueError(f"level window [{lv.lo}, {lv.lo + lv.num}) outside {lv.levels} levels")
    return n


def encode_fwd(positions, table, lv: Levels) -> torch.Tensor:
    """K7a (F = 2) or K7ag (any other F): (n, 3) unit positions, (L_all*T,
    F) table -> (n, Lw*F) f32."""
    if positions.device.type == "cpu":
        return encode_fwd_plain(positions, table, lv)
    n = _check(positions, table, lv)
    F = table.shape[1]
    if F == 2 and table.data_ptr() % (2 * F * table.element_size()):
        # K7a loads a cube's x-neighbours as one aligned pair of entries
        raise ValueError("table must start on a two-entry boundary")
    out = torch.empty((n, lv.num * F), dtype=torch.float32, device=positions.device)
    if n == 0:
        return out
    if F == 2:
        K7A.count(launch_fwd(_library(), positions, table, lv, out))
        return out
    K7AG.count(_library().ngp_encode_fwd_f(
        positions.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
        lv.scale.data_ptr(), out.data_ptr(), n, lv.num, F, lv.lo, lv.log2_T,
        cuda_build.stream(positions),
    ))
    return out


def launch_fwd(lib: ctypes.CDLL, positions, table, lv: Levels, out) -> int:
    """Launch `lib`'s ngp_encode_fwd (bound by `bind`) on checked inputs
    into out (n, Lw*2); returns its CUDA error code."""
    return lib.ngp_encode_fwd(
        positions.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
        lv.scale.data_ptr(), out.data_ptr(), positions.shape[0], lv.num, lv.lo, lv.log2_T,
        cuda_build.stream(positions),
    )


def encode_bwd(positions, table, gfeat, lv: Levels):
    """K7b (F = 2) or K7bg (any other F): -> (dpos (n, 3) f32, dtable
    (L_all*T, F) f32)."""
    if positions.device.type == "cpu":
        return encode_bwd_plain(positions, table, gfeat, lv)
    n = _check(positions, table, lv, gfeat)
    F = table.shape[1]
    dpos = torch.empty((n, 3), dtype=torch.float32, device=positions.device)
    dtable = torch.zeros((lv.table_rows, F), dtype=torch.float32, device=positions.device)
    if n == 0:
        return dpos, dtable
    bf16, stream = int(table.dtype == torch.bfloat16), cuda_build.stream(positions)
    if F == 2:
        K7B.count(_library().ngp_encode_bwd(
            positions.data_ptr(), table.data_ptr(), bf16, lv.scale.data_ptr(), gfeat.data_ptr(),
            dpos.data_ptr(), dtable.data_ptr(), n, lv.num, lv.lo, lv.log2_T, stream,
        ))
        return dpos, dtable
    K7BG.count(_library().ngp_encode_bwd_f(
        positions.data_ptr(), table.data_ptr(), bf16, lv.scale.data_ptr(), gfeat.data_ptr(),
        dpos.data_ptr(), dtable.data_ptr(), n, lv.num, F, lv.lo, lv.log2_T, stream,
    ))
    return dpos, dtable
