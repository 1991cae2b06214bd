"""ctypes binding of the native C++ batch sampler and double-buffered
prefetcher (native/fastloader.cpp). Port of lsenerf_tpu/data/native_loader.py.

Both packages bind the same C++ source, so one seed gives the same
batches. The port builds it with the flags of native/build.sh into
`lsenerf_tpu_torch/_build/`, keyed by a hash of the source and the flags,
and never writes into native/. Where the library cannot be built (no g++)
`get_library` raises: the JAX package falls back to the numpy sampler
there, the port does not.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "fastloader.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libfastloader_{digest.hexdigest()[:16]}.so"


def build_library() -> Path:
    """The built library (built first where it is missing)."""
    out = library_path()
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("use_native needs g++ to build native/fastloader.cpp, and there is none")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def get_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    i64, u64, vp = ctypes.c_int64, ctypes.c_uint64, ctypes.c_void_p
    lib.lse_sample_rgb.argtypes = [u8p, i64, i64, i64, i64, u64, i64, i32p, f32p, ctypes.c_int]
    lib.lse_sample_events.argtypes = [
        f32p, i64, i64, i64, i64, u64, i64, i64, ctypes.c_float, i32p, f32p, ctypes.c_int]
    lib.lse_prefetcher_create.restype = vp
    lib.lse_prefetcher_create.argtypes = [
        u8p, i64, i64, i64, i64, i64, f32p, i64, i64, i64, i64, i64, i64, ctypes.c_float, u64]
    lib.lse_prefetcher_create_i16.restype = vp
    lib.lse_prefetcher_create_i16.argtypes = [
        u8p, i64, i64, i64, i64, i64, vp, vp, i64, i64, i64, i64, i64, i64, ctypes.c_float, u64]
    lib.lse_prefetcher_next.argtypes = [vp, u64, i32p, f32p, i32p, f32p]
    lib.lse_prefetcher_destroy.argtypes = [vp]
    return lib


def sample_rgb(images_u8: np.ndarray, seed: int, n_rays: int, n_threads: int = 2):
    """(n, h, w, 3) uint8 -> (idx (n_rays, 3) int32 [cam, y, x], rgb
    (n_rays, 3) f32 / 255)."""
    n, h, w, c = images_u8.shape
    out_idx = np.empty((n_rays, 3), np.int32)
    out_val = np.empty((n_rays, c), np.float32)
    get_library().lse_sample_rgb(images_u8, n, h, w, c, seed, n_rays, out_idx, out_val, n_threads)
    return out_idx, out_val


def sample_events(frames_f32: np.ndarray, seed: int, n_rays: int, img_limit: int,
                  e_thresh: float, n_threads: int = 2):
    """(n, h, w, c) f32 event frames -> (idx (n_rays, 3), values * e_thresh),
    frames drawn below img_limit."""
    n, h, w, c = frames_f32.shape
    out_idx = np.empty((n_rays, 3), np.int32)
    out_val = np.empty((n_rays, c), np.float32)
    get_library().lse_sample_events(frames_f32, n, h, w, c, seed, n_rays, img_limit, e_thresh,
                                    out_idx, out_val, n_threads)
    return out_idx, out_val


class NativePrefetcher:
    """Double-buffered native batch producer: batch k+1 is assembled on the
    library's threads while step k runs."""

    def __init__(self, col_u8: np.ndarray | None, n_col: int, evs: np.ndarray | None, n_evs: int,
                 evs_img_limit: int, e_thresh: float, seed: int = 0,
                 evs_sel: np.ndarray | None = None):
        """evs: (n, h, w, c) float32 frames, or with `evs_sel` an int16
        (N, h, w) buffer (a np.memmap over the scene's .npy) whose logical
        frame i is row evs_sel[i]; the library then reads only the sampled
        pixels' pages."""
        lib = get_library()
        self._lib = lib
        self._handle = None
        self.n_col, self.n_evs = n_col, n_evs
        self._col = col_u8 if col_u8 is not None else np.zeros((1, 1, 1, 3), np.uint8)
        cn, ch, cw, cc = self._col.shape
        self.cc = cc
        self._step = 0
        if evs_sel is not None and evs is not None:
            if evs.dtype != np.int16 or evs.ndim != 3 or not evs.flags["C_CONTIGUOUS"]:
                raise ValueError("evs with evs_sel must be a C-contiguous int16 (N, h, w) array")
            self._evs = evs  # keeps the memmap alive
            self._sel = np.ascontiguousarray(evs_sel, np.int64)
            self.ec = 1
            self._handle = lib.lse_prefetcher_create_i16(
                self._col, cn, ch, cw, cc, n_col, evs.ctypes.data_as(ctypes.c_void_p),
                self._sel.ctypes.data_as(ctypes.c_void_p), len(self._sel), evs.shape[1],
                evs.shape[2], 1, n_evs, evs_img_limit, e_thresh, seed)
            return
        self._evs = evs if evs is not None else np.zeros((1, 1, 1, 1), np.float32)
        en, eh, ew, ec = self._evs.shape
        self.ec = ec
        self._handle = lib.lse_prefetcher_create(
            self._col, cn, ch, cw, cc, n_col, self._evs, en, eh, ew, ec, n_evs,
            evs_img_limit, e_thresh, seed)

    def next(self) -> dict:
        col_idx = np.empty((max(self.n_col, 1), 3), np.int32)
        col_val = np.empty((max(self.n_col, 1), self.cc), np.float32)
        evs_idx = np.empty((max(self.n_evs, 1), 3), np.int32)
        evs_val = np.empty((max(self.n_evs, 1), self.ec), np.float32)
        self._lib.lse_prefetcher_next(self._handle, self._step, col_idx, col_val, evs_idx, evs_val)
        self._step += 1
        out = {}
        if self.n_col > 0:
            out["col_indices"], out["col_rgb"] = col_idx, col_val
        if self.n_evs > 0:
            out["evs_indices"], out["evs_values"] = evs_idx, evs_val
        return out

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.lse_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
