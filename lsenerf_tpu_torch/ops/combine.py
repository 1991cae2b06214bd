"""The blocked hash encode's two CUDA kernels, their plain versions and
their ctypes wrappers. Counterpart of lsenerf_tpu/ops/pallas_combine.py.

K1 `encode_fwd`: unit positions (n, 3) + table (rows, W) -> features
(n, L*F). It replaces the Pallas combine P1 (pallas_combine.py:58) and the
key computation and row gather around it (hash_encoding.py:438-458).

K2 `encode_bwd`: positions + table + cotangent (n, L*F) -> (dpos (n, 3),
dtable (rows, W)). It replaces the Pallas position-gradient kernel P2
(pallas_combine.py:76) and the sorted, windowed table gradient
(hash_encoding.py:527-639) with exact atomics.

F features per level fill the first 27*F columns of a row of W = 32 *
ceil(27F / 32) (HashEncodingConfig.blocked_row_width). At F = 2 (W = 64,
the flagship's) the wrappers launch K1/K2; at any other F the generic
kernels K1g `blocked_encode_fwd_f` and K2g `blocked_encode_bwd_f`, which
take F and W as arguments (P1 and P2 take F as a parameter too).

The sources are csrc/blocked_encode.cu, built and loaded by cuda_build. A
wrapper runs the plain PyTorch version for CPU tensors only; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import cuda_build
from .cuda_build import BUILD_DIR, NVCC_FLAGS, Kernel  # noqa: F401 (kept public)

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

SOURCE = cuda_build.CSRC / "blocked_encode.cu"


K1 = Kernel("blocked_encode_fwd")
K2 = Kernel("blocked_encode_bwd")
K1G = Kernel("blocked_encode_fwd_f")
K2G = Kernel("blocked_encode_bwd_f")
KERNELS = (K1, K2, K1G, K2G)


@dataclass(frozen=True, eq=False)
class Levels:
    """Per-level constants of one encode, on one device.

    scale: (L,) f32 grid resolutions; params: (L, 4) int32 rows of
    (res, bdim, dense flag, global row offset); hash_mask: 2^rows_log2 - 1;
    F: features per vertex; row_width: the table's columns (27*F used).
    """

    scale: torch.Tensor
    params: torch.Tensor
    hash_mask: int
    total_rows: int
    F: int
    row_width: int

    @property
    def num(self) -> int:
        return self.scale.shape[0]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def keys_fracs(positions: torch.Tensor, levels: Levels):
    """(n, 3) unit positions -> global row keys (L, n) int64 and per-dim
    parities o and fractions w, each a list of three (L, n) tensors.

    The hash is the JAX uint32 hash done in int64, masked to 32 bits after
    each product, so it wraps exactly as uint32 does."""
    scale = levels.scale[:, None]
    p = levels.params.long()
    res, bdim, dense, off = (p[:, j : j + 1] for j in range(4))
    ks, os_, ws = [], [], []
    for d in range(3):
        s = positions[None, :, d] * scale  # (L, n)
        b = torch.minimum(torch.floor(s).long().clamp(min=0), res - 1)
        ws.append(s - b.float())
        ks.append(b >> 1)
        os_.append(b & 1)
    kx, ky, kz = ks
    key_dense = (kx * bdim + ky) * bdim + kz
    h = (kx * _PRIMES[0]) & _U32
    h = h ^ ((ky * _PRIMES[1]) & _U32)
    h = h ^ ((kz * _PRIMES[2]) & _U32)
    keys = torch.where(dense.bool(), key_dense, h & levels.hash_mask) + off
    return keys, os_, ws


def _slot_weights(o: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weights of block slots {0, 1, 2} per dimension: (..., 3)."""
    of = o.float()
    return torch.stack(
        [(1.0 - w) * (1.0 - of), w * (1.0 - of) + (1.0 - w) * of, w * of], -1
    )


def _gather_rows(table, keys, F):
    L, n = keys.shape
    rows = table.index_select(0, keys.reshape(-1)).float()
    return rows[:, :27 * F].reshape(L, n, 27, F)


def encode_fwd_plain(positions, table, levels: Levels) -> torch.Tensor:
    n, L, F = positions.shape[0], levels.num, levels.F
    keys, o, w = keys_fracs(positions, levels)
    ux, uy, uz = (_slot_weights(o[d], w[d]) for d in range(3))
    w27 = (
        ux[..., :, None, None] * uy[..., None, :, None] * uz[..., None, None, :]
    ).reshape(L, n, 27)
    feats = (_gather_rows(table, keys, F) * w27[..., None]).sum(2)  # (L, n, F)
    return feats.permute(1, 0, 2).reshape(n, L * F)


def encode_bwd_plain(positions, table, gfeat, levels: Levels):
    n, L, F = positions.shape[0], levels.num, levels.F
    keys, o, w = keys_fracs(positions, levels)
    ux, uy, uz = (_slot_weights(o[d], w[d]) for d in range(3))
    g = gfeat.reshape(n, L, F).permute(1, 0, 2)  # (L, n, F)
    rows = _gather_rows(table, keys, F)
    dw27 = (rows * g[:, :, None, :]).sum(-1).reshape(L, n, 3, 3, 3)
    du = (
        (dw27 * uy[..., None, :, None] * uz[..., None, None, :]).sum((3, 4)),
        (dw27 * ux[..., :, None, None] * uz[..., None, None, :]).sum((2, 4)),
        (dw27 * ux[..., :, None, None] * uy[..., None, :, None]).sum((2, 3)),
    )
    scale = levels.scale[:, None]
    dpos = []
    for d in range(3):
        of = o[d].float()
        dw = (
            -du[d][..., 0] * (1.0 - of)
            + du[d][..., 1] * (1.0 - 2.0 * of)
            + du[d][..., 2] * of
        )
        dpos.append((dw * scale).sum(0))
    w27 = (
        ux[..., :, None, None] * uy[..., None, :, None] * uz[..., None, None, :]
    ).reshape(L, n, 27)
    upd = (w27[..., None] * g[:, :, None, :]).reshape(L * n, 27 * F)
    dtable = torch.zeros(
        (levels.total_rows, levels.row_width), dtype=torch.float32, device=positions.device
    )
    dtable[:, :27 * F].index_add_(0, keys.reshape(-1), upd)
    return torch.stack(dpos, 1), dtable


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def library_path():
    return cuda_build.library_path(SOURCE)


def build():
    """Compile the kernels unless a library of these sources exists; returns
    the library path and the compiler's report (see cuda_build.build_all)."""
    return cuda_build.build(SOURCE)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built blocked_encode library's entries."""
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.blocked_encode_fwd.argtypes = [p, p, i, p, p, p, i, i, u, p]
    lib.blocked_encode_fwd.restype = i
    lib.blocked_encode_bwd.argtypes = [p, p, i, p, p, p, p, p, i, i, u, p]
    lib.blocked_encode_bwd.restype = i
    lib.blocked_encode_fwd_f.argtypes = [p, p, i, p, p, p, i, i, i, i, u, p]
    lib.blocked_encode_fwd_f.restype = i
    lib.blocked_encode_bwd_f.argtypes = [p, p, i, p, p, p, p, p, i, i, i, i, u, p]
    lib.blocked_encode_bwd_f.restype = i
    return lib


@functools.lru_cache(maxsize=None)
def _library():
    return bind(cuda_build.load(SOURCE))


_TABLE_TYPES = (torch.bfloat16, torch.float32)


def _refuse(positions, table, levels, gfeat=None):
    """Raise ValueError naming the first check the inputs fail."""
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    n = positions.shape[0]
    cuda_build.check("positions", positions, (torch.float32,), (n, 3), dev)
    cuda_build.check("table", table, _TABLE_TYPES, (levels.total_rows, levels.row_width), dev)
    cuda_build.check("levels.scale", levels.scale, (torch.float32,), (levels.num,), dev)
    cuda_build.check("levels.params", levels.params, (torch.int32,), (levels.num, 4), dev)
    if gfeat is not None:
        cuda_build.check("gfeat", gfeat, (torch.float32,), (n, levels.num * levels.F), dev)
    if not (1 <= levels.F and 27 * levels.F <= levels.row_width
            and (levels.F != 2 or levels.row_width == 64)):
        # K1/K2 (F = 2) read rows of 64 columns
        raise ValueError(f"{levels.F} features a vertex in rows of {levels.row_width}")
    raise ValueError("the inputs do not fit the encode kernels")


def _check_common(positions, table, levels, gfeat=None):
    """The inputs' sample count n, where the kernels (the backward's, given
    its cotangent gfeat) take them; else raises through _refuse. The
    wrapper's host time is a good part of a call's, so the check is one
    expression over cheap tensor properties."""
    s, p = levels.scale, levels.params
    d = positions.get_device()
    L, F, W = s.shape[0], levels.F, levels.row_width
    if not (positions.is_cuda and positions.dtype == torch.float32
            and positions.dim() == 2 and positions.shape[1] == 3
            and table.dtype in _TABLE_TYPES and table.shape == (levels.total_rows, W)
            and 1 <= F and 27 * F <= W and (F != 2 or W == 64)
            and s.dtype == torch.float32 and s.dim() == 1
            and p.dtype == torch.int32 and p.shape == (L, 4)
            and table.get_device() == d and s.get_device() == d and p.get_device() == d
            and positions.is_contiguous() and table.is_contiguous()
            and s.is_contiguous() and p.is_contiguous()
            and (gfeat is None or (gfeat.dtype == torch.float32 and gfeat.get_device() == d
                                   and gfeat.shape == (positions.shape[0], L * F)
                                   and gfeat.is_contiguous()))):
        _refuse(positions, table, levels, gfeat)
    return positions.shape[0]


def encode_fwd(positions, table, levels: Levels) -> torch.Tensor:
    """K1 (F = 2) or K1g (any other F): (n, 3) unit positions, (rows, W)
    table -> (n, L*F) f32."""
    if positions.device.type == "cpu":
        return encode_fwd_plain(positions, table, levels)
    n = _check_common(positions, table, levels)
    out = torch.empty((n, levels.num * levels.F), dtype=torch.float32,
                      device=positions.device)
    if n == 0:
        return out
    stream = cuda_build.stream(positions)
    bf16 = int(table.dtype == torch.bfloat16)
    if levels.F == 2:
        err = _library().blocked_encode_fwd(
            positions.data_ptr(), table.data_ptr(), bf16,
            levels.scale.data_ptr(), levels.params.data_ptr(), out.data_ptr(),
            n, levels.num, levels.hash_mask, stream,
        )
        K1.count(err)
        return out
    err = _library().blocked_encode_fwd_f(
        positions.data_ptr(), table.data_ptr(), bf16, levels.scale.data_ptr(),
        levels.params.data_ptr(), out.data_ptr(), n, levels.num, levels.F,
        levels.row_width, levels.hash_mask, stream,
    )
    K1G.count(err)
    return out


def encode_bwd(positions, table, gfeat, levels: Levels):
    """K2 (F = 2) or K2g (any other F): -> (dpos (n, 3) f32, dtable (rows,
    W) f32)."""
    if positions.device.type == "cpu":
        return encode_bwd_plain(positions, table, gfeat, levels)
    n = _check_common(positions, table, levels, gfeat)
    dpos = torch.empty((n, 3), dtype=torch.float32, device=positions.device)
    dtable = torch.zeros((levels.total_rows, levels.row_width), dtype=torch.float32,
                         device=positions.device)
    if n == 0:
        return dpos, dtable
    stream = cuda_build.stream(positions)
    bf16 = int(table.dtype == torch.bfloat16)
    if levels.F == 2:
        err = _library().blocked_encode_bwd(
            positions.data_ptr(), table.data_ptr(), bf16,
            levels.scale.data_ptr(), levels.params.data_ptr(), gfeat.data_ptr(),
            dpos.data_ptr(), dtable.data_ptr(), n, levels.num, levels.hash_mask,
            stream,
        )
        K2.count(err)
        return dpos, dtable
    err = _library().blocked_encode_bwd_f(
        positions.data_ptr(), table.data_ptr(), bf16, levels.scale.data_ptr(),
        levels.params.data_ptr(), gfeat.data_ptr(), dpos.data_ptr(), dtable.data_ptr(),
        n, levels.num, levels.F, levels.row_width, levels.hash_mask, stream,
    )
    K2G.count(err)
    return dpos, dtable
