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
// - G2 gives each thread 4 neighbouring elements of one row (a "quad") on
//   a 2-D grid: blockIdx.y picks a tile of rows and blockIdx.x a tile of
//   quads, so no element pays a 64-bit division. Where the width is a
//   multiple of 4 and the pointers are 16-byte aligned, a thread loads its 4
//   indices as one int4 and stores its 4 elements as one 16-byte (f32) or
//   8-byte (bf16) piece; other widths (C = 131, odd bf16 widths) move
//   element by element, with the ragged edge masked. Elements are moved as
//   raw bits (4 or 2 bytes), so f32 and bf16 share one kernel and a gather
//   stays an exact copy.
//   Both axes read t through L1/L2 (the probes' tables are at most 1 MB):
//   on axis 1 the 32 lanes of a warp read one row, which L1 then holds.
//   Staging a block's rows in shared memory first (cp.async) was measured
//   slower on an H100 at every axis-1 shape, 8 MB included.
//   On axis 0, where a quad's 4 indices agree, as in a broadcast row
//   index, its 4 elements come in one vector load.
// - G3 sums r in index order, one add per step with no multiply to fuse, so
//   its result is bit-identical to the plain sum in the same order. At the
//   probe's case H (64 gathers an output from an 8192 x 128 table) it reads
//   268 MB a launch through L2, though the table is 4 MB. Blocks that each
//   copy a 16-byte column slice of the table into shared memory first were
//   measured slower on an H100 at case H: the copy costs one L2 request per
//   16-byte piece, and pays only from ~78 gathers an output (PERF.md).
// - G1 and G3 run grid-stride loops over at most kMaxBlocks blocks, G2 a
//   row-tile loop over at most 65,535 tiles; every thread loads the
//   indices it needs itself (there is no scalar prefetch to lean on).
// - Indices are int32. An index outside the table gives zeros (G3 adds a
//   zero row); no kernel reads outside its table, and none checks on the host.
// - The C entries launch on the caller's stream, allocate nothing, and
//   return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

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

// G2's element types and the vector of 4 of them (16 or 8 bytes).
template <typename T> struct Quad;
template <> struct Quad<uint32_t> { using V = uint4; };
template <> struct Quad<uint16_t> { using V = uint2; };

__device__ __forceinline__ uint4 pack4(const uint32_t (&v)[4]) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint2 pack4(const uint16_t (&v)[4]) {
  return make_uint2(v[0] | ((uint32_t)v[1] << 16), v[2] | ((uint32_t)v[3] << 16));
}
__device__ __forceinline__ void unpack4(uint4 p, uint32_t (&v)[4]) {
  v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
}
__device__ __forceinline__ void unpack4(uint2 p, uint16_t (&v)[4]) {
  v[0] = (uint16_t)p.x; v[1] = (uint16_t)(p.x >> 16);
  v[2] = (uint16_t)p.y; v[3] = (uint16_t)(p.y >> 16);
}

// t, idx, out (R, C). A block is (kThreads >> qt_log2) rows of
// (1 << qt_log2) quads. kVec: C % 4 == 0 and every pointer 16-byte
// aligned.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    take_along_kernel(const T* __restrict__ t, const int* __restrict__ idx,
                      T* __restrict__ out, int R, int C, int axis,
                      int qt_log2) {
  using V = typename Quad<T>::V;
  const int rt = kThreads >> qt_log2;
  const int ty = threadIdx.x >> qt_log2;
  const int j0 = (blockIdx.x << (qt_log2 + 2)) + ((threadIdx.x & ((1 << qt_log2) - 1)) << 2);
  if (j0 >= C) return;
  for (int64_t i = (int64_t)blockIdx.y * rt + ty; i < R; i += (int64_t)gridDim.y * rt) {
    const int64_t base = i * C + j0;
    int x[4];
    if (kVec) {
      int4 q = __ldg(reinterpret_cast<const int4*>(idx + base));
      x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = j0 + e < C ? __ldg(idx + base + e) : 0;
    }
    T v[4];
    if (axis == 0 && kVec && x[0] == x[1] && x[0] == x[2] && x[0] == x[3]) {
      V p = {};
      if ((unsigned)x[0] < (unsigned)R)
        p = __ldg(reinterpret_cast<const V*>(t + (int64_t)x[0] * C + j0));
      unpack4(p, v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = 0;
        if (axis == 0) {
          if ((unsigned)x[e] < (unsigned)R) v[e] = __ldg(t + (int64_t)x[e] * C + j0 + e);
        } else if ((unsigned)x[e] < (unsigned)C) {
          v[e] = __ldg(t + i * C + x[e]);
        }
      }
    }
    if (kVec) {
      *reinterpret_cast<V*>(out + base) = pack4(v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e < C) out[base + e] = v[e];
    }
  }
}

template <typename T>
int launch_take_along(const void* t, const int* idx, void* out, int R, int C,
                      int axis, cudaStream_t s) {
  const int quads = (C + 3) / 4;
  int qt_log2 = 0;
  while ((1 << qt_log2) < quads && (1 << qt_log2) < kThreads) ++qt_log2;
  const int rt = kThreads >> qt_log2;
  dim3 grid((unsigned)((quads + (1 << qt_log2) - 1) >> qt_log2),
            (unsigned)std::min<int64_t>(((int64_t)R + rt - 1) / rt, 65535));
  const bool vec = C % 4 == 0 &&
                   (((uintptr_t)t | (uintptr_t)idx | (uintptr_t)out) & 15) == 0;
  const T* tt = reinterpret_cast<const T*>(t);
  T* o = reinterpret_cast<T*>(out);
  if (vec)
    take_along_kernel<T, true><<<grid, kThreads, 0, s>>>(tt, idx, o, R, C, axis, qt_log2);
  else
    take_along_kernel<T, false><<<grid, kThreads, 0, s>>>(tt, idx, o, R, C, axis, qt_log2);
  return (int)cudaGetLastError();
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
  if ((int64_t)R * C == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return launch_take_along<uint32_t>(t, idx, out, R, C, axis, s);
  if (elem_bytes == 2) return launch_take_along<uint16_t>(t, idx, out, R, C, axis, s);
  return (int)cudaErrorInvalidValue;
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
