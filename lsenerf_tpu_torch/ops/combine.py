"""The blocked hash encode's two CUDA kernels, their plain versions and
their ctypes wrappers. Counterpart of lsenerf_tpu/ops/pallas_combine.py.

K1 `encode_fwd`: unit positions (n, 3) + table (rows, 64) -> features
(n, L*F). It replaces the Pallas combine P1 (pallas_combine.py:58) and the
key computation and row gather around it (hash_encoding.py:438-458).

K2 `encode_bwd`: positions + table + cotangent (n, L*F) -> (dpos (n, 3),
dtable (rows, 64)). It replaces the Pallas position-gradient kernel P2
(pallas_combine.py:76) and the sorted, windowed table gradient
(hash_encoding.py:527-639) with exact atomics.

The sources are csrc/blocked_encode.cu. They are compiled with nvcc at
first use into `_build/` beside this package, keyed by a hash of the source
and the flags, and loaded with ctypes. A wrapper runs the plain PyTorch
version for CPU tensors only; for CUDA tensors it launches its kernel or
raises. F = 2 features per level and a row width of 64 are fixed, as in the
flagship configuration.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from dataclasses import dataclass
from pathlib import Path

import torch

F = 2
ROW_WIDTH = 64
_USED = 27 * F
_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "blocked_encode.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class Kernel:
    """A kernel's name and its launch count (one per launch, nowhere else)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


K1 = Kernel("blocked_encode_fwd")
K2 = Kernel("blocked_encode_bwd")
KERNELS = (K1, K2)


@dataclass(frozen=True, eq=False)
class Levels:
    """Per-level constants of one encode, on one device.

    scale: (L,) f32 grid resolutions; params: (L, 4) int32 rows of
    (res, bdim, dense flag, global row offset); hash_mask: 2^rows_log2 - 1.
    """

    scale: torch.Tensor
    params: torch.Tensor
    hash_mask: int
    total_rows: int

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


def _gather_rows(table, keys):
    L, n = keys.shape
    rows = table.index_select(0, keys.reshape(-1)).float()
    return rows[:, :_USED].reshape(L, n, 27, F)


def encode_fwd_plain(positions, table, levels: Levels) -> torch.Tensor:
    n, L = positions.shape[0], levels.num
    keys, o, w = keys_fracs(positions, levels)
    ux, uy, uz = (_slot_weights(o[d], w[d]) for d in range(3))
    w27 = (
        ux[..., :, None, None] * uy[..., None, :, None] * uz[..., None, None, :]
    ).reshape(L, n, 27)
    feats = (_gather_rows(table, keys) * w27[..., None]).sum(2)  # (L, n, F)
    return feats.permute(1, 0, 2).reshape(n, L * F)


def encode_bwd_plain(positions, table, gfeat, levels: Levels):
    n, L = positions.shape[0], levels.num
    keys, o, w = keys_fracs(positions, levels)
    ux, uy, uz = (_slot_weights(o[d], w[d]) for d in range(3))
    g = gfeat.reshape(n, L, F).permute(1, 0, 2)  # (L, n, F)
    rows = _gather_rows(table, keys)
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
    upd = (w27[..., None] * g[:, :, None, :]).reshape(L * n, _USED)
    dtable = torch.zeros(
        (levels.total_rows, ROW_WIDTH), dtype=torch.float32, device=positions.device
    )
    dtable[:, :_USED].index_add_(0, keys.reshape(-1), upd)
    return torch.stack(dpos, 1), dtable


# ---------------------------------------------------------------------------
# build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libblocked_encode_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library of these sources exists.
    Returns the library path and the compiler's report (ptxas registers,
    shared memory and spills; empty when nothing was built)."""
    out = library_path()
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[0]))
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib.blocked_encode_fwd.argtypes = [p, p, i, p, p, p, i, i, u, p]
    lib.blocked_encode_fwd.restype = i
    lib.blocked_encode_bwd.argtypes = [p, p, i, p, p, p, p, p, i, i, u, p]
    lib.blocked_encode_bwd.restype = i
    return lib


def _check(name, t, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(positions, table, levels):
    dev = positions.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, got {dev}")
    n = positions.shape[0]
    _check("positions", positions, (torch.float32,), (n, 3), dev)
    _check("table", table, (torch.bfloat16, torch.float32),
           (levels.total_rows, ROW_WIDTH), dev)
    _check("levels.scale", levels.scale, (torch.float32,), (levels.num,), dev)
    _check("levels.params", levels.params, (torch.int32,), (levels.num, 4), dev)
    return n


def _raise_on(err: int, kernel: Kernel):
    if err != 0:
        raise RuntimeError(f"{kernel.name} launch failed: cudaError {err}")


def encode_fwd(positions, table, levels: Levels) -> torch.Tensor:
    """K1: (n, 3) unit positions, (rows, 64) table -> (n, L*F) f32."""
    if positions.device.type == "cpu":
        return encode_fwd_plain(positions, table, levels)
    n = _check_common(positions, table, levels)
    out = torch.empty((n, levels.num * F), dtype=torch.float32,
                      device=positions.device)
    if n == 0:
        return out
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    err = _library().blocked_encode_fwd(
        positions.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
        levels.scale.data_ptr(), levels.params.data_ptr(), out.data_ptr(),
        n, levels.num, levels.hash_mask, stream,
    )
    _raise_on(err, K1)
    K1.launches += 1
    return out


def encode_bwd(positions, table, gfeat, levels: Levels):
    """K2: -> (dpos (n, 3) f32, dtable (rows, 64) f32)."""
    if positions.device.type == "cpu":
        return encode_bwd_plain(positions, table, gfeat, levels)
    n = _check_common(positions, table, levels)
    _check("gfeat", gfeat, (torch.float32,), (n, levels.num * F), positions.device)
    dpos = torch.empty((n, 3), dtype=torch.float32, device=positions.device)
    dtable = torch.zeros((levels.total_rows, ROW_WIDTH), dtype=torch.float32,
                         device=positions.device)
    if n == 0:
        return dpos, dtable
    stream = torch.cuda.current_stream(positions.device).cuda_stream
    err = _library().blocked_encode_bwd(
        positions.data_ptr(), table.data_ptr(), int(table.dtype == torch.bfloat16),
        levels.scale.data_ptr(), levels.params.data_ptr(), gfeat.data_ptr(),
        dpos.data_ptr(), dtable.data_ptr(), n, levels.num, levels.hash_mask,
        stream,
    )
    _raise_on(err, K2)
    K2.launches += 1
    return dpos, dtable
