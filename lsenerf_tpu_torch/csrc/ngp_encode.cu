// ngp hash-grid encode for Hopper (sm_90a): forward (K7a) and backward (K7b).
//
// The ngp layout is the reference-exact per-vertex hash (tiny-cuda-nn's
// HashGrid semantics): every sample-level reads the 8 vertices of its cube,
// each hashed on its own into the level's T = 2^log2_T entries of F = 2
// features.
//
// K7a ngp_encode_fwd replaces the ngp branch of
//   lsenerf_tpu/ops/hash_encoding.py::hash_encode (:685)
// with its gather lsenerf_tpu/ops/fast_gather.py::take_cols (:290).
// K7b ngp_encode_bwd replaces the table gradient of take_cols (_take_cols_bwd,
// fast_gather.py:312): a scatter-add off the TPU and, on the TPU, the
// sort-and-window accumulate sorted_window_accumulate (:113), which the JAX
// package built because a TPU scatter costs ~90 ns an index. Here the table
// gradient is exact f32 atomics, and K7b also gives the position gradient
// that JAX's autodiff takes through the trilinear weights.
//
// Layout: the JAX package stores the table transposed, (F, L*T), to keep its
// minor dimension large on the TPU. The port stores it (L*T, F) row-major, so
// that a vertex's two features are one 8-byte load (f32) or one 4-byte load
// (the bf16 copy the encode takes with gather_dtype bfloat16) and its
// gradient one float2 atomic. Positions are unit-cube (n, 3) f32; features
// are (n, Lw*F) f32, feats[i, l*F + f], for the Lw levels of the window
// [lo, lo + Lw) of the ladder; a level's entries start at (lo + l) * T.
//
// What bounds them on the card: scattered requests, not bytes or
// operations. Per sample-level K7a loads 8 vertices at hashed addresses
// (8 sector requests, the coarse levels' shared by the samples of a ray)
// and writes 8 bytes; K7b loads the same 8 and sends 8 float2 atomics, each
// its own L2 request (~79 G/s scattered on the H100,
// lsenerf_tpu_torch/l2_atomic_probe.py; that probe also shows that this
// toolkit has the float2 atomicAdd, which Hopper runs on global memory).
// The f32 table is 64 MiB at 16 levels of 2^19 entries and K7b's gradient
// another 64 MiB, more than the 50 MB L2 holds; the bf16 copy, 32 MiB,
// fits.
//
// Design (simple first; the times are in PERF.md):
// - K7a gives one thread a (sample, level) pair, the pairs in the output's
//   order: thread t takes sample t / Lw, level t % Lw, so a warp's output
//   stores are contiguous 8-byte pieces and a sample's position is read by
//   the Lw neighbouring threads of its levels. Every thread has its 8
//   loads in flight at once. (A thread per sample walking its levels, as
//   in K7b, was slower here: fewer loads in flight.)
// - K7b gives one thread a sample, which walks the window's levels in
//   order. A launch's samples (56,192 at the badnerf preset's batch) are
//   all resident at once, so they work on about the same level at a time,
//   and the working set of the atomics and loads is a level or two of the
//   table and its gradient (8 MiB a level, f32), not all of them. It
//   replaced K7a's mapping, under which every level was live at once,
//   and is faster (PERF.md §6 has both times). The thread sums its levels'
//   position-gradient terms in level order in registers: no atomics on
//   dpos, and the same bits from call to call. The block's cotangent
//   (64 samples x Lw levels) is staged in shared memory, read coalesced.
//   Its 8 weighted cotangents go to the table gradient as float2 atomics
//   (none where the weight is 0: adding 0 changes nothing); they add in
//   no fixed order. floor() carries no gradient, as in JAX.
// - Keys are JAX's bit for bit: s = p * scale with __fmul_rn (a fused
//   multiply-add would move s, and so the cube, near cell faces), w =
//   s - floor(s) and 1 - w with __fsub_rn, the corner hash
//   (cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861) in uint32_t (it wraps as
//   JAX's uint32 does, a negative coordinate cast as JAX casts it), masked to
//   T - 1. A corner's weight is (wx' * wy') * wz', in JAX's order, and the
//   forward adds the corners in JAX's order (x outer, z inner) with __fadd_rn.
// - The C entries launch on the caller's stream, allocate nothing (the
//   wrapper zero-fills the table gradient) and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr int kFwdThreads = 256;
constexpr int kBwdSamples = 64;  // K7b: samples a block, one a thread
constexpr int kMaxLevels = 64;

// Vertex `e` of the table: its 2 features as f32.
template <bool kBF16>
__device__ __forceinline__ float2 load_vertex(const void* __restrict__ table, long e) {
  if (kBF16) {
    const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(table) + e);
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
  return __ldg(reinterpret_cast<const float2*>(table) + e);
}

// The cube of sample i at a level of grid resolution `sc`: its base corner
// b and the fractions w per dimension, as JAX computes them.
__device__ __forceinline__ void cube(const float* __restrict__ pos, long i, float sc,
                                     int b[3], float w[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float s = __fmul_rn(__ldg(pos + i * 3 + d), sc);
    const float f = floorf(s);
    w[d] = __fsub_rn(s, f);
    b[d] = (int)f;
  }
}

// Corner c = (cx << 2) | (cy << 1) | cz of the cube: its entry in the level
// starting at `base`, and its weight.
__device__ __forceinline__ long corner(int c, const int b[3], const float w[3],
                                       uint32_t mask, long base, float* wt) {
  const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
  const float wx = cx ? w[0] : __fsub_rn(1.0f, w[0]);
  const float wy = cy ? w[1] : __fsub_rn(1.0f, w[1]);
  const float wz = cz ? w[2] : __fsub_rn(1.0f, w[2]);
  *wt = __fmul_rn(__fmul_rn(wx, wy), wz);
  const uint32_t h = (uint32_t)(b[0] + cx) ^ ((uint32_t)(b[1] + cy) * kPrime1) ^
                     ((uint32_t)(b[2] + cz) * kPrime2);
  return base + (long)(h & mask);
}

template <bool kBF16>
__global__ void __launch_bounds__(kFwdThreads)
    ngp_fwd_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                   const float* __restrict__ scale, float2* __restrict__ out,
                   long pairs, int L, int lo, int log2_T) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= pairs) return;
  const long i = t / L;
  const int l = (int)(t - i * L);
  int b[3];
  float w[3];
  cube(pos, i, __ldg(scale + l), b, w);
  const uint32_t mask = (1u << log2_T) - 1u;
  const long base = (long)(lo + l) << log2_T;
  long e[8];
  float wt[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) e[c] = corner(c, b, w, mask, base, &wt[c]);
  float2 f[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) f[c] = load_vertex<kBF16>(table, e[c]);
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    a0 = __fadd_rn(a0, __fmul_rn(f[c].x, wt[c]));
    a1 = __fadd_rn(a1, __fmul_rn(f[c].y, wt[c]));
  }
  out[t] = make_float2(a0, a1);
}

// Block b: samples 64b .. 64b+63, one a thread, each walking its levels in
// order; dynamic shared memory holds the block's cotangent (64, L), read
// once, coalesced.
template <bool kBF16>
__global__ void __launch_bounds__(kBwdSamples)
    ngp_bwd_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                   const float* __restrict__ scale, const float2* __restrict__ gfeat,
                   float* __restrict__ dpos, float2* __restrict__ dtable, int n, int L,
                   int lo, int log2_T) {
  extern __shared__ float2 g_s[];  // (kBwdSamples, L), as in gfeat
  const long i0 = (long)blockIdx.x * kBwdSamples;
  const int live = (int)min((long)kBwdSamples, (long)n - i0);
  for (int e = threadIdx.x; e < live * L; e += blockDim.x) g_s[e] = __ldg(gfeat + i0 * L + e);
  __syncthreads();
  const int k = threadIdx.x;
  if (k >= live) return;
  const uint32_t mask = (1u << log2_T) - 1u;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    const float sc = __ldg(scale + l);
    int b[3];
    float w[3];
    cube(pos, i0 + k, sc, b, w);
    const float2 g = g_s[k * L + l];
    const long base = (long)(lo + l) << log2_T;
    const float u[3][2] = {{__fsub_rn(1.0f, w[0]), w[0]},
                           {__fsub_rn(1.0f, w[1]), w[1]},
                           {__fsub_rn(1.0f, w[2]), w[2]}};
    float dw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
      float wt;
      const long e = corner(c, b, w, mask, base, &wt);
      const float2 f = load_vertex<kBF16>(table, e);
      // d loss / d weight of this corner, then the chain rule through
      // (wx' * wy') * wz' in the plain version's order, and wx' = wx or 1 - wx
      const float dW = __fadd_rn(__fmul_rn(f.x, g.x), __fmul_rn(f.y, g.y));
      const float ux = u[0][cx], uy = u[1][cy], uz = u[2][cz];
      const float dxy = __fmul_rn(dW, uz);
      const float term[3] = {__fmul_rn(dxy, uy), __fmul_rn(dxy, ux),
                             __fmul_rn(dW, __fmul_rn(ux, uy))};
      const int bit[3] = {cx, cy, cz};
#pragma unroll
      for (int d = 0; d < 3; ++d)
        dw[d] = bit[d] ? __fadd_rn(dw[d], term[d]) : __fsub_rn(dw[d], term[d]);
      if (wt != 0.0f) atomicAdd(dtable + e, make_float2(__fmul_rn(g.x, wt), __fmul_rn(g.y, wt)));
    }
    // the level's term of the position gradient, summed in level order
#pragma unroll
    for (int d = 0; d < 3; ++d) acc[d] = __fadd_rn(acc[d], __fmul_rn(dw[d], sc));
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) dpos[(i0 + k) * 3 + d] = acc[d];
}

}  // namespace

extern "C" {

// pos (n, 3) f32; table (L_all*T, 2) f32 or bf16 (table_bf16 = 1); scale
// (L,) f32, the window's grid resolutions; out (n, L*2) f32. The window's
// first level is `lo` of the ladder, T = 2^log2_T. All device pointers.
int ngp_encode_fwd(const float* pos, const void* table, int table_bf16, const float* scale,
                   float* out, int n, int L, int lo, int log2_T, void* stream) {
  if (n == 0) return 0;
  if (L < 1 || L > kMaxLevels || lo < 0 || log2_T < 1 || log2_T > 30)
    return (int)cudaErrorInvalidValue;
  const long pairs = (long)n * L;
  const unsigned int blocks = (unsigned int)((pairs + kFwdThreads - 1) / kFwdThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float2* o = reinterpret_cast<float2*>(out);
  if (table_bf16)
    ngp_fwd_kernel<true><<<blocks, kFwdThreads, 0, s>>>(pos, table, scale, o, pairs, L, lo, log2_T);
  else
    ngp_fwd_kernel<false><<<blocks, kFwdThreads, 0, s>>>(pos, table, scale, o, pairs, L, lo, log2_T);
  return (int)cudaGetLastError();
}

// gfeat (n, L*2) f32; dpos (n, 3) f32 (written); dtable (L_all*T, 2) f32
// (added into: the caller passes zeros).
int ngp_encode_bwd(const float* pos, const void* table, int table_bf16, const float* scale,
                   const float* gfeat, float* dpos, float* dtable, int n, int L, int lo,
                   int log2_T, void* stream) {
  if (n == 0) return 0;
  if (L < 1 || L > kMaxLevels || lo < 0 || log2_T < 1 || log2_T > 30)
    return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + kBwdSamples - 1) / kBwdSamples);
  const size_t smem = (size_t)kBwdSamples * L * sizeof(float2);  // 8 KB at 16 levels
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float2* g = reinterpret_cast<const float2*>(gfeat);
  float2* dt = reinterpret_cast<float2*>(dtable);
  if (table_bf16)
    ngp_bwd_kernel<true><<<blocks, kBwdSamples, smem, s>>>(pos, table, scale, g, dpos, dt, n,
                                                           L, lo, log2_T);
  else
    ngp_bwd_kernel<false><<<blocks, kBwdSamples, smem, s>>>(pos, table, scale, g, dpos, dt, n,
                                                            L, lo, log2_T);
  return (int)cudaGetLastError();
}

}  // extern "C"
