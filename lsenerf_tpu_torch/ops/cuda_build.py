"""Build, load and check the port's CUDA kernels.

Every source `csrc/*.cu` is compiled with nvcc for sm_90a into its own
shared library under `_build/` beside this package, keyed by a hash of the
source and the flags, and loaded with ctypes. The sources have a plain C
interface: no PyTorch headers, so a build takes seconds. `build_all` starts
one nvcc per source, all together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from lsenerf_tpu_torch.engine import spans

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


class Kernel:
    """A kernel's name and its launch count (one per launch, nowhere else;
    a launch outside a CUDA-graph capture is also counted in the open run of
    engine/spans.py while a profiler runs)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def count(self, err: int) -> None:
        """Raise if the launch returned a CUDA error, else count it."""
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: cudaError {err}")
        self.launches += 1
        spans.launched(self.name)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_all(srcs=None) -> dict[Path, tuple[Path, str]]:
    """Compile each source that has no library yet, one nvcc per source,
    all started together. Returns {source: (library, compiler report)}; the
    report holds ptxas's registers, shared memory and spills, and is empty
    where nothing was built."""
    srcs = sorted(CSRC.glob("*.cu")) if srcs is None else list(srcs)
    done, jobs = {}, {}
    for src in srcs:
        out = library_path(src)
        if out.exists():
            done[src] = (out, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs[src] = (proc, tmp, out)
    failed = []
    for src, (proc, tmp, out) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        os.replace(tmp, out)
        done[src] = (out, err)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def build(source: Path) -> tuple[Path, str]:
    return build_all([source])[source]


@functools.lru_cache(maxsize=None)
def load(source: Path) -> ctypes.CDLL:
    """The built library of one source (built first if need be)."""
    return ctypes.CDLL(str(build(source)[0]))


def check(name, t, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of t's device, as the integer ctypes passes.
    Read on every call, never cached, so a launch goes to whatever stream
    the caller has made current (a side stream, a CUDA graph's capture)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
