// Blocked hash-grid encode for Hopper (sm_90a): forward (K1) and backward (K2).
//
// K1 blocked_encode_fwd replaces the Pallas combine kernel
//   lsenerf_tpu/ops/pallas_combine.py::_combine_kernel (P1)
// together with the key computation (_blocked_keys_fracs) and the row gather
// (jnp.take) of lsenerf_tpu/ops/hash_encoding.py::_blocked_fast_fn.fwd_core.
// K2 blocked_encode_bwd replaces the Pallas position-gradient kernel
//   lsenerf_tpu/ops/pallas_combine.py::_bwd_kernel (P2)
// and the table gradient that the TPU builds from a sort plus windowed
// one-hot matmuls (sorted_window_accumulate_factored, the dense-prefix
// one-hot matmuls, dp_accumulate).
//
// Layout: the table is (rows, 64), one row per 3x3x3 vertex block of one
// level, F = 2 features per vertex (54 used columns, 10 pad columns). Every
// sample-level reads exactly one row. Positions are unit-cube (n, 3) f32;
// features are (n, L*F) f32 with feats[i, l*F + f].
//
// What bounds them on the card: bytes. Per sample-level K1 reads one
// 112-byte row prefix and writes 8 bytes, for ~200 f32 operations; K2 reads
// the same row and adds 8 nonzero 2-wide updates into an f32 gradient table.
// The bf16 table (27 MB at the flagship size) fits in the 50 MB L2, so rows
// mostly come from L2, not HBM.
//
// Design:
// - K1: one thread per (sample, level). Keys and fractions are computed in
//   the kernel from the positions, so nothing but the output is written.
// - K2: one thread per sample looping over the levels, so the position
//   gradient is a plain register sum. It recomputes keys and fractions
//   instead of reading rows saved by the forward. The table gradient is
//   atomicAdd into f32: an exact sum with no per-window cap and no bf16
//   rounding of the factors (the JAX backward has both). Adds of an exact
//   zero weight (19 of the 27 vertices of a trilinear stencil) are skipped.
// - s = p * scale uses __fmul_rn and w = s - b uses __fsub_rn: a fused
//   multiply-add would change w, and so the keys at cell boundaries.
// - The hash multiplies in uint32_t and wraps exactly as the JAX uint32 code.
// - The C entries launch on the caller's stream, allocate nothing, and
//   return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr int kUsed = 54;  // 27 vertices x 2 features
constexpr int kThreads = 128;

// lp = (res, bdim, dense flag, global row offset) of one level. Fills the
// three slot weights per dimension (u[d][0..2]) and the parities, returns
// the global row key.
__device__ __forceinline__ int level_setup(const float* __restrict__ pos,
                                           long i, float scale, int4 lp,
                                           uint32_t hash_mask, float u[3][3],
                                           int o[3]) {
  int k[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float s = __fmul_rn(pos[i * 3 + d], scale);
    int b = (int)floorf(s);
    b = min(max(b, 0), lp.x - 1);
    float w = __fsub_rn(s, (float)b);
    float om = 1.0f - w;
    k[d] = b >> 1;
    o[d] = b & 1;
    u[d][0] = o[d] ? 0.0f : om;
    u[d][1] = o[d] ? om : w;
    u[d][2] = o[d] ? w : 0.0f;
  }
  int key;
  if (lp.z) {
    key = (k[0] * lp.y + k[1]) * lp.y + k[2];
  } else {
    uint32_t h = (uint32_t)k[0] ^ ((uint32_t)k[1] * kPrime1) ^
                 ((uint32_t)k[2] * kPrime2);
    key = (int)(h & hash_mask);
  }
  return key + lp.w;
}

// The 54 used values of one row, as f32.
template <bool kBF16>
__device__ __forceinline__ void load_row(const void* __restrict__ table,
                                         int key, float r[kUsed]) {
  if (kBF16) {
    const uint4* row = reinterpret_cast<const uint4*>(table) + (long)key * 8;
#pragma unroll
    for (int q = 0; q < 7; ++q) {
      uint4 v = __ldg(row + q);
      uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int e = q * 8 + j * 2;
        if (e < kUsed) r[e] = __uint_as_float(wd[j] << 16);
        if (e + 1 < kUsed) r[e + 1] = __uint_as_float(wd[j] & 0xffff0000u);
      }
    }
  } else {
    const float4* row = reinterpret_cast<const float4*>(table) + (long)key * 16;
#pragma unroll
    for (int q = 0; q < 14; ++q) {
      float4 v = __ldg(row + q);
      float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int e = q * 4 + j;
        if (e < kUsed) r[e] = vv[j];
      }
    }
  }
}

template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    encode_fwd_kernel(const float* __restrict__ pos,
                      const void* __restrict__ table,
                      const float* __restrict__ scale,
                      const int4* __restrict__ lvl, float* __restrict__ out,
                      int n, int L, uint32_t hash_mask) {
  long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)n * L) return;
  long i = t / L;
  int l = (int)(t - i * L);
  float u[3][3];
  int o[3];
  int key = level_setup(pos, i, __ldg(scale + l), __ldg(lvl + l), hash_mask,
                        u, o);
  float r[kUsed];
  load_row<kBF16>(table, key, r);
  float acc0 = 0.0f, acc1 = 0.0f;
#pragma unroll
  for (int vx = 0; vx < 3; ++vx) {
#pragma unroll
    for (int vy = 0; vy < 3; ++vy) {
      float wxy = u[0][vx] * u[1][vy];
#pragma unroll
      for (int vz = 0; vz < 3; ++vz) {
        int v = (vx * 3 + vy) * 3 + vz;
        float w = wxy * u[2][vz];
        acc0 += w * r[2 * v];
        acc1 += w * r[2 * v + 1];
      }
    }
  }
  reinterpret_cast<float2*>(out)[t] = make_float2(acc0, acc1);
}

template <bool kBF16>
__global__ void __launch_bounds__(kThreads)
    encode_bwd_kernel(const float* __restrict__ pos,
                      const void* __restrict__ table,
                      const float* __restrict__ scale,
                      const int4* __restrict__ lvl,
                      const float* __restrict__ gfeat,
                      float* __restrict__ dpos, float* __restrict__ dtable,
                      int n, int L, uint32_t hash_mask) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float dp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    float sc = __ldg(scale + l);
    float u[3][3];
    int o[3];
    int key = level_setup(pos, i, sc, __ldg(lvl + l), hash_mask, u, o);
    float2 g = __ldg(reinterpret_cast<const float2*>(gfeat) + i * L + l);
    float r[kUsed];
    load_row<kBF16>(table, key, r);
    float* drow = dtable + (long)key * 64;
    float du[3][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
#pragma unroll
    for (int vx = 0; vx < 3; ++vx) {
#pragma unroll
      for (int vy = 0; vy < 3; ++vy) {
#pragma unroll
        for (int vz = 0; vz < 3; ++vz) {
          int v = (vx * 3 + vy) * 3 + vz;
          float gv = g.x * r[2 * v] + g.y * r[2 * v + 1];
          du[0][vx] += gv * u[1][vy] * u[2][vz];
          du[1][vy] += gv * u[0][vx] * u[2][vz];
          du[2][vz] += gv * u[0][vx] * u[1][vy];
          float w = (u[0][vx] * u[1][vy]) * u[2][vz];
          if (w != 0.0f) {
            atomicAdd(drow + 2 * v, w * g.x);
            atomicAdd(drow + 2 * v + 1, w * g.y);
          }
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      // d(slot weights)/dw over slots {o, o+1}: [-(1-o), 1-2o, o]
      float dw = o[d] ? (du[d][2] - du[d][1]) : (du[d][1] - du[d][0]);
      dp[d] += dw * sc;
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) dpos[i * 3 + d] = dp[d];
}

}  // namespace

extern "C" {

// pos (n, 3) f32; table (rows, 64) bf16 (table_bf16=1) or f32; scale (L,)
// f32; lvl (L, 4) int32 = (res, bdim, dense flag, row offset); out
// (n, L*2) f32. All device pointers.
int blocked_encode_fwd(const float* pos, const void* table, int table_bf16,
                       const float* scale, const int* lvl, float* out, int n,
                       int L, unsigned int hash_mask, void* stream) {
  long total = (long)n * L;
  if (total == 0) return 0;
  unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* lv = reinterpret_cast<const int4*>(lvl);
  if (table_bf16)
    encode_fwd_kernel<true><<<blocks, kThreads, 0, s>>>(pos, table, scale, lv,
                                                        out, n, L, hash_mask);
  else
    encode_fwd_kernel<false><<<blocks, kThreads, 0, s>>>(pos, table, scale, lv,
                                                         out, n, L, hash_mask);
  return (int)cudaGetLastError();
}

// gfeat (n, L*2) f32; dpos (n, 3) f32 (written); dtable (rows, 64) f32
// (accumulated into: the caller passes zeros).
int blocked_encode_bwd(const float* pos, const void* table, int table_bf16,
                       const float* scale, const int* lvl, const float* gfeat,
                       float* dpos, float* dtable, int n, int L,
                       unsigned int hash_mask, void* stream) {
  if (n == 0) return 0;
  unsigned int blocks = (unsigned int)((n + kThreads - 1) / kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* lv = reinterpret_cast<const int4*>(lvl);
  if (table_bf16)
    encode_bwd_kernel<true><<<blocks, kThreads, 0, s>>>(
        pos, table, scale, lv, gfeat, dpos, dtable, n, L, hash_mask);
  else
    encode_bwd_kernel<false><<<blocks, kThreads, 0, s>>>(
        pos, table, scale, lv, gfeat, dpos, dtable, n, L, hash_mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
