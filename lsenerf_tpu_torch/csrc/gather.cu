// Row and element gathers for Hopper (sm_90a): what the Pallas gather
// probes in scripts/pallas_probe*.py compute, as three kernels.
//
// G1 row_gather   out[k, :] = table[idx[k], :]
//   replaces scripts/pallas_probe.py kernel_take, kernel_tala, kernel_loop,
//   kernel_onehot, kernel_dg (P3); pallas_probe2.py k_bc and
//   pallas_probe3.py k_s1, k_s2 (P4); pallas_probe4.py gather_kernel (P5).
// G2 take_along   out[i, j] = t[idx[i, j], j] (axis 0), t[i, idx[i, j]] (axis 1)
//   replaces pallas_probe2.py k_tala, k_tala3, k_bf16 and pallas_probe3.py
//   k_m1, k_m2, k_m3, k_r1 (a roll is a take_along with fixed indices).
// G3 gather_sum   out[k, :] = sum over r = 0, 1, ... of table[idx[r, k], :]
//   replaces pallas_probe2.py k_tput.
//
// What bounds them on the card: bytes. A gather is a copy; G3 adds one f32
// per element read. The tables of the probes (at most 25.6 MB, P5's bf16
// flagship table) fit in the 50 MB L2, so table rows mostly come from L2
// and the output and the indices from and to HBM.
//
// Design:
// - G1 and G3 move 16 bytes (a uint4 or float4) per thread and step:
//   neighbouring threads take neighbouring 16-byte pieces of one row, and
//   then of the next row, so the output is written fully coalesced and each
//   row is read as whole 32-byte sectors. Rows are a multiple of 16 bytes.
// - G2 moves one element per thread: neighbouring threads take neighbouring
//   j, so the index and the output are coalesced. Elements are moved as raw
//   bits (4 or 2 bytes), so f32 and bf16 share one kernel.
// - G3 sums r in index order, one add per step with no multiply to fuse, so
//   its result is bit-identical to the plain sum in the same order.
// - Grid-stride loops over at most kMaxBlocks blocks; every thread loads the
//   indices it needs itself (there is no scalar prefetch to lean on).
// - Indices are int32. An index outside the table gives zeros (G3 adds a
//   zero row); no kernel reads outside its table, and none checks on the host.
// - The C entries launch on the caller's stream, allocate nothing, and
//   return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 4096;

unsigned int blocks_for(int64_t items) {
  int64_t b = (items + kThreads - 1) / kThreads;
  return (unsigned int)(b < kMaxBlocks ? b : kMaxBlocks);
}

// vecs = 16-byte pieces per row
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const uint4* __restrict__ table,
                      const int* __restrict__ idx, uint4* __restrict__ out,
                      int64_t m, int rows, int vecs) {
  const int64_t total = m * vecs;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    int64_t k = t / vecs;
    int v = (int)(t - k * vecs);
    int r = __ldg(idx + k);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if ((unsigned)r < (unsigned)rows) val = __ldg(table + (int64_t)r * vecs + v);
    out[t] = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    take_along_kernel(const T* __restrict__ t, const int* __restrict__ idx,
                      T* __restrict__ out, int R, int C, int axis) {
  const int64_t total = (int64_t)R * C;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    int64_t i = e / C;
    int j = (int)(e - i * C);
    int x = __ldg(idx + e);
    T val = 0;
    if (axis == 0) {
      if ((unsigned)x < (unsigned)R) val = __ldg(t + (int64_t)x * C + j);
    } else {
      if ((unsigned)x < (unsigned)C) val = __ldg(t + i * C + x);
    }
    out[e] = val;
  }
}

// idx (R, n); vecs = float4 pieces per row
__global__ void __launch_bounds__(kThreads)
    gather_sum_kernel(const float4* __restrict__ table,
                      const int* __restrict__ idx, float4* __restrict__ out,
                      int R, int64_t n, int rows, int vecs) {
  const int64_t total = n * vecs;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += (int64_t)gridDim.x * blockDim.x) {
    int64_t k = t / vecs;
    int v = (int)(t - k * vecs);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int r = 0; r < R; ++r) {
      int x = __ldg(idx + (int64_t)r * n + k);
      float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if ((unsigned)x < (unsigned)rows) val = __ldg(table + (int64_t)x * vecs + v);
      acc.x += val.x;
      acc.y += val.y;
      acc.z += val.z;
      acc.w += val.w;
    }
    out[t] = acc;
  }
}

}  // namespace

extern "C" {

// table (rows, row_bytes / elem) of any 2- or 4-byte type, 16-byte aligned,
// row_bytes a multiple of 16; idx (m,) int32; out (m, same width).
int row_gather(const void* table, const int* idx, void* out, int64_t m,
               int rows, int row_bytes, void* stream) {
  int vecs = row_bytes / 16;
  if (m == 0 || vecs == 0) return 0;
  row_gather_kernel<<<blocks_for(m * vecs), kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(table), idx, reinterpret_cast<uint4*>(out),
      m, rows, vecs);
  return (int)cudaGetLastError();
}

// t, idx and out (R, C); elem_bytes 4 (f32) or 2 (bf16); axis 0 or 1.
int take_along(const void* t, const int* idx, void* out, int R, int C,
               int elem_bytes, int axis, void* stream) {
  int64_t total = (int64_t)R * C;
  if (total == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    take_along_kernel<uint32_t><<<blocks_for(total), kThreads, 0, s>>>(
        reinterpret_cast<const uint32_t*>(t), idx,
        reinterpret_cast<uint32_t*>(out), R, C, axis);
  else if (elem_bytes == 2)
    take_along_kernel<uint16_t><<<blocks_for(total), kThreads, 0, s>>>(
        reinterpret_cast<const uint16_t*>(t), idx,
        reinterpret_cast<uint16_t*>(out), R, C, axis);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// table (rows, W) f32, 16-byte aligned, W a multiple of 4; idx (R, n)
// int32; out (n, W) f32.
int gather_sum(const float* table, const int* idx, float* out, int R,
               int64_t n, int rows, int W, void* stream) {
  int vecs = W / 4;
  if (n == 0 || vecs == 0) return 0;
  gather_sum_kernel<<<blocks_for(n * vecs), kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(table), idx,
      reinterpret_cast<float4*>(out), R, n, rows, vecs);
  return (int)cudaGetLastError();
}

}  // extern "C"
