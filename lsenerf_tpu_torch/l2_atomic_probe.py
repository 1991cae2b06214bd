"""The card's rates for the memory patterns the port's kernels are built
from: scattered f32 atomics and stores into L2 (K2's table-gradient
scatter), gathered loads of table rows (K1's and G3's row reads), and
random reads from a shared-memory slice (what a G3 that holds a column
slice of its table in shared memory would pay; PERF.md).
The kernels are in csrc/blocked_encode.cu and csrc/gather.cu.

    python -m lsenerf_tpu_torch.l2_atomic_probe      # on the card, ~20 s

Atomics and stores (`ATOMIC_CASES`): each adds (or stores) ones into rows
of a (rows, 64) f32 table the size of the flagship's gradient table, one
op a thread, each row picked at random; one case has a warp's 32 lanes on
one row's 32 floats, as K2's scatter does.

Loads (`LOAD_CASES`): each thread loads one piece of a random row, so the
cases differ only in how many lanes of a warp instruction share a 128-byte
line: scattered 16-byte loads one lane per line (K1 before its redesign,
32 lines per instruction); 8 lanes on one line (8 x 16 bytes, 4 lines);
4 lanes on one line with 4-byte loads (K1's groups, 8 lines); a warp on
one 512-byte f32 row (G3, 4 lines). The bf16 table is the
flagship's (rows, 64); the f32 one G3's 8192 x 128 at the probe's case H.

Shared memory (`SMEM_CASES`): one block per SM fills a 128 KB slice
(8192 rows of 16 bytes, a 16-byte column slice of G3's table at case H)
and then reads float4s from it, the lanes of a warp on random rows (G3's
pattern, with bank conflicts) or on neighbouring rows (none).

Each case prints its device ms (CUDA-graph replay, timing.device_ms) and
its G ops/s; the first line is the card's name and power limit. The kernels
are built from the source below into _build/. It needs the card: there is
no CPU mode.
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
#include <stdint.h>
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

// Loads: a value that never occurs keeps each load alive.
constexpr uint32_t kNever = 0x7fc00001u;
// 128-byte rows (rows of the bf16 table), one lane per line
__global__ void ld_line(const uint4* t, const int* rows, int n, uint4* sink) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint4 v = __ldg(t + (long)rows[i] * 8 + (i & 7));
  if (v.x == kNever) *sink = v;
}
// 8 lanes on the 8 16-byte pieces of one 128-byte row
__global__ void ld_group8(const uint4* t, const int* rows, int n, uint4* sink) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint4 v = __ldg(t + (long)rows[i >> 3] * 8 + (i & 7));
  if (v.x == kNever) *sink = v;
}
// 4 lanes on one 128-byte row, 4 bytes each, at words 0, 3, 9 and 12 (K1's
// four (x, y) pairs of a sample-level)
__global__ void ld_group4w(const uint4* t, const int* rows, int n, uint4* sink) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int q = i & 3;
  uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(t) + (long)rows[i >> 2] * 32 +
                     (q >> 1) * 9 + (q & 1) * 3);
  if (v == kNever) sink->x = v;
}
// a warp on one 512-byte row of an 8192-row table
__global__ void ld_row512(const uint4* t, const int* rows, int n, uint4* sink) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint4 v = __ldg(t + (long)(rows[i >> 5] & 8191) * 32 + (i & 31));
  if (v.x == kNever) *sink = v;
}

// Shared memory: a 128 KB slice of 8192 float4 rows, read `iters` times a
// thread; random rows from a per-thread LCG, or a warp on 32 neighbouring
// rows.
constexpr int kSliceRows = 8192;
template <bool kRandom>
__global__ void __launch_bounds__(1024) sm_read(const float4* src, int iters, float4* sink) {
  extern __shared__ float4 s[];
  for (int x = threadIdx.x; x < kSliceRows; x += blockDim.x) s[x] = src[x];
  __syncthreads();
  uint32_t h = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + 12345u;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int it = 0; it < iters; ++it) {
    h = h * 1664525u + 1013904223u;
    int x = kRandom ? (int)(h >> 19) : ((threadIdx.x + 32 * it) & (kSliceRows - 1));
    float4 v = s[x];
    acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
  }
  if (acc.x == 1234.5f) *sink = acc;
}
}  // namespace
extern "C" int probe(int which, float* b, const int* rows, int n, void* s) {
  void (*k[])(float*, const int*, int) = {f4, f2, f1, row, st4};
  k[which]<<<(n + 255) / 256, 256, 0, (cudaStream_t)s>>>(b, rows, n);
  return (int)cudaGetLastError();
}
extern "C" int probe_load(int which, const void* t, const int* rows, int n, void* sink, void* s) {
  void (*k[])(const uint4*, const int*, int, uint4*) = {ld_line, ld_group8, ld_group4w, ld_row512};
  k[which]<<<(n + 255) / 256, 256, 0, (cudaStream_t)s>>>(
      (const uint4*)t, rows, n, (uint4*)sink);
  return (int)cudaGetLastError();
}
extern "C" int probe_smem(int which, const void* src, int blocks, int threads, int iters,
                          void* sink, void* s) {
  void (*k)(const float4*, int, float4*) = which ? sm_read<false> : sm_read<true>;
  int bytes = kSliceRows * 16;
  cudaError_t e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  k<<<blocks, threads, bytes, (cudaStream_t)s>>>((const float4*)src, iters, (float4*)sink);
  return (int)cudaGetLastError();
}
"""
ATOMIC_CASES = ("float4 atomics, scattered rows", "float2 atomics, scattered rows",
                "scalar atomics, scattered rows", "scalar atomics, a warp on one row's 32 floats",
                "float4 stores, scattered rows")
LOAD_CASES = ("16-byte loads, one lane per 128-byte line (32 lines a warp instruction)",
              "16-byte loads, 8 lanes on one 128-byte line (4 lines)",
              "4-byte loads, 4 lanes on one 128-byte line (8 lines)",
              "16-byte loads, a warp on one 512-byte f32 row (4 lines)")
SMEM_CASES = ("float4 reads of a 128 KB shared-memory slice, random rows",
              "float4 reads of a 128 KB shared-memory slice, a warp on 32 neighbouring rows")
CASES = ATOMIC_CASES + LOAD_CASES + SMEM_CASES
OPS = 5_391_954  # 6 per sample-level at the flagship's 56,192 samples x 16 levels
LOADS = 7_192_576  # 8 per sample-level at the flagship's shape
SMEM_THREADS, SMEM_ITERS = 1024, 512


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
    lib.probe_load.argtypes = [i32, vp, vp, i32, vp, vp]
    lib.probe_smem.argtypes = [i32, vp, i32, i32, i32, vp, vp]

    dev = torch.device("cuda")
    total_rows = flagship_model_config().field.hash.total_rows
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randint(0, total_rows, (max(OPS, LOADS),), generator=gen, device=dev,
                         dtype=torch.int32)
    buf = torch.zeros((total_rows, 64), device=dev)
    bf16 = torch.randn((total_rows, 64), generator=gen, device=dev).to(torch.bfloat16)
    f32 = torch.randn((8192, 128), generator=gen, device=dev)
    sink = torch.zeros(4, dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run(err):
        if err:
            raise RuntimeError(f"l2_atomic_probe launch failed: cudaError {err}")

    def report(name, ops, ms, what):
        print(f"{name}: {ops} {what} in {ms:.5f} ms, {ops / ms / 1e6:.2f} G {what}/s", flush=True)

    # the stream is read at every launch: device_ms captures the calls on a
    # stream of its own
    for k, name in enumerate(ATOMIC_CASES):
        ms = device_ms(lambda: run(lib.probe(k, buf.data_ptr(), rows.data_ptr(), OPS,
                                             cuda_build.stream(buf))))
        report(f"L2 {name} ({total_rows} x 64 f32)", OPS, ms, "ops")
    for k, name in enumerate(LOAD_CASES):
        table = f32 if k == 3 else bf16
        ms = device_ms(lambda: run(lib.probe_load(
            k, table.data_ptr(), rows.data_ptr(), LOADS, sink.data_ptr(), cuda_build.stream(buf))))
        report(f"gather {name}", LOADS, ms, "loads")
    reads = sms * SMEM_THREADS * SMEM_ITERS
    for k, name in enumerate(SMEM_CASES):
        ms = device_ms(lambda: run(lib.probe_smem(
            k, f32.data_ptr(), sms, SMEM_THREADS, SMEM_ITERS, sink.data_ptr(), cuda_build.stream(buf))))
        report(f"{name} ({sms} blocks of {SMEM_THREADS})", reads, ms, "reads")
    return 0


if __name__ == "__main__":
    sys.exit(main())
