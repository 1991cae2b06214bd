"""The L2's rates for scattered f32 atomics and stores on the card, the
measurement behind K2's table-gradient scatter (csrc/blocked_encode.cu).

    python -m lsenerf_tpu_torch.l2_atomic_probe      # on the card, ~15 s

Each case adds (or stores) ones into rows of a (rows, 64) f32 table the
size of the flagship's gradient table, one op a thread, each row picked at
random; one case has a warp's 32 lanes on one row's 32 floats, as K2's
scatter does. Each prints its device ms (CUDA-graph replay,
timing.device_ms) and its ops/s; the first line is the card's name and
power limit. The kernels are built from the source below into _build/. It
needs the card: there is no CPU mode.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from .flagship import flagship_model_config
from .ops import cuda_build
from .timing import device_ms

SOURCE = r"""
#include <cuda_runtime.h>
namespace {
__global__ void f4(float* b, const int* rows, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(reinterpret_cast<float4*>(b + (long)rows[i] * 64 + 4 * (i & 7)),
                       make_float4(1.f, 1.f, 1.f, 1.f));
}
__global__ void f2(float* b, const int* rows, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(reinterpret_cast<float2*>(b + (long)rows[i] * 64 + 2 * (i & 15)),
                       make_float2(1.f, 1.f));
}
__global__ void f1(float* b, const int* rows, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(b + (long)rows[i] * 64 + (i & 31), 1.f);
}
__global__ void row(float* b, const int* rows, int n) {  // a warp on one row
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) atomicAdd(b + (long)rows[i >> 5] * 64 + (i & 31), 1.f);
}
__global__ void st4(float* b, const int* rows, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) *reinterpret_cast<float4*>(b + (long)rows[i] * 64 + 4 * (i & 7)) =
      make_float4(1.f, 1.f, 1.f, 1.f);
}
}  // namespace
extern "C" int probe(int which, float* b, const int* rows, int n, void* s) {
  void (*k[])(float*, const int*, int) = {f4, f2, f1, row, st4};
  k[which]<<<(n + 255) / 256, 256, 0, (cudaStream_t)s>>>(b, rows, n);
  return (int)cudaGetLastError();
}
"""
CASES = ("float4 atomics, scattered rows", "float2 atomics, scattered rows",
         "scalar atomics, scattered rows", "scalar atomics, a warp on one row's 32 floats",
         "float4 stores, scattered rows")
OPS = 5_391_954  # 6 per sample-level at the flagship's 56,192 samples x 16 levels


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("l2_atomic_probe needs a CUDA device: there is no CPU mode")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.BUILD_DIR / "l2_atomic_probe.cu"
    src.write_text(SOURCE)
    lib = ctypes.CDLL(str(cuda_build.build(src)[0]))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.probe.argtypes = [i32, vp, vp, i32, vp]

    dev = torch.device("cuda")
    total_rows = flagship_model_config().field.hash.total_rows
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randint(0, total_rows, (OPS,), generator=gen, device=dev, dtype=torch.int32)
    buf = torch.zeros((total_rows, 64), device=dev)

    def launch(k):
        err = lib.probe(k, buf.data_ptr(), rows.data_ptr(), OPS, cuda_build.stream(buf))
        if err:
            raise RuntimeError(f"l2_atomic_probe launch failed: cudaError {err}")

    for k, name in enumerate(CASES):
        ms = device_ms(lambda: launch(k))
        print(f"L2 {name}: {OPS} ops on {total_rows} x 64 f32 in {ms:.5f} ms, "
              f"{OPS / ms / 1e6:.2f} G ops/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
