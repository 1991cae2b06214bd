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
// and writes 8 bytes; K7b loads the same 8 and sends 8 float2 atomics, each
// its own L2 request (~79 G/s scattered on the H100,
// lsenerf_tpu_torch/l2_atomic_probe.py; that probe also shows that this
// toolkit has the float2 atomicAdd, which Hopper runs on global memory).
// The f32 table is 64 MiB at 16 levels of 2^19 entries and K7b's gradient
// another 64 MiB, more than the 50 MB L2 holds; the bf16 copy, 32 MiB,
// fits. K7a's time follows the L2 sector requests of its table loads (each
// distinct 32-byte sector a warp reads, 4 f32 entries of which it uses one
// or two at a fine level): 86-112 G sectors/s over the six shapes that
// chip_smoke.py times (k7a_requests there counts them).
//
// Design (the times are in PERF.md §6):
// - K7a gives a warp one level of the window over 32 consecutive samples,
//   a block 64 samples x 4 levels (8 warps). Neighbouring samples of a ray
//   then sit in one load instruction, so where they share a cube (the
//   coarse levels) their corners are one request; the grid runs level
//   group by level group (blockIdx level-group-major), so the blocks
//   resident at once read about 4 levels of the table (16 MiB of the f32
//   one), not all 16; where a cube's base x coordinate is even, its two
//   x-neighbours are entries h and h ^ 1, one aligned 16-byte (f32) or
//   8-byte (bf16) load (half the cubes: 4 loads a thread in place of 8);
//   and the block stages its positions and its results in
//   shared memory, so positions are read once, coalesced, and a sample's 4
//   levels go out as 32 contiguous bytes, one sector. It replaced a thread
//   a (sample, level) (thread t: sample t / Lw, level t % Lw, 8 loads in
//   flight a thread, every level live at once), which it beat at all six
//   shapes in one call, by 16-34% warm and 19-36% with a cold L2
//   (lsenerf_tpu_torch/k7a_compare.py; NVIDIA H100 80GB HBM3 at 700 W):
//   0.0485 ms against 0.0671 at 56,192 uniform samples x 16 levels (f32),
//   0.0380 against 0.0568 at one ngp f32 badnerf step's inputs, 0.0845
//   against 0.1026 at one eval render chunk (196,608 samples, 48 a ray).
//   With one warp a level, 64 samples a block and 6 blocks an SM it was
//   the fastest of the block shapes tried.
// - K7b gives one thread a sample, which walks the window's levels in
//   order. A launch's samples (56,192 at the badnerf preset's batch) are
//   all resident at once, so they work on about the same level at a time,
//   and the working set of the atomics and loads is a level or two of the
//   table and its gradient (8 MiB a level, f32), not all of them. It
//   replaced a thread a (sample, level), under which every level was
//   live at once, and is faster (PERF.md §6 has both times). The thread sums its levels'
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
//
// K7ag ngp_encode_fwd_f and K7bg ngp_encode_bwd_f are the same two functions
// at any F (features a level) other than 2: the JAX package's ngp branch and
// take_cols take any F. The table is (L_all*T, F) row-major, F an argument,
// so every F >= 1 works. They are bound as K7a/K7b are, by scattered
// requests: 8 vertices of F values a sample-level, and 8F updates in the
// backward.
// - K7ag is K7a's design at any F. Its first design gave a thread a
//   (sample, level) (thread t: sample t / Lw, level t % Lw) and loaded a
//   corner as F scalars in a loop on the runtime F: 8F loads a
//   sample-level, 8 in flight, about one L2 request each; every level live
//   at once (a warp on 4 samples x 8 levels), so that the working set was
//   the whole 64 MiB f32 table at 8 levels of 2^19 x 4; positions read
//   strided, once a level. Now, as K7a: a warp takes one level over 32
//   consecutive samples, and the grid runs level group by level group, so
//   that the blocks resident at once read a few levels of the table, not
//   all; positions are staged in shared memory. A corner's F values are
//   loaded V at a time (V = 4, 2 or 1, the largest that divides F and to
//   whose width the table is aligned, chosen a launch as K7bg chooses it):
//   8 float4 loads a sample-level at F = 4 f32 against 32 scalars, the 8
//   corners' loads of two steps in flight together. Where 2F values fit in
//   one aligned load of at most 16 bytes (F = 1, F = 4 bf16), a cube whose
//   base x is even loads its x-pair h, h ^ 1 as one, as K7a. The block's
//   (64, levels, F) output is staged in shared memory and written out
//   contiguous, 16 bytes a store where F allows; past 48 KB (F > 94 at 2
//   levels a block) each lane writes its values from registers. Keys,
//   weights and the order of the corner sum are the first design's, so
//   the output is the plain version's bits at any shape. The block shape
//   and the register cap were chosen on the card (PERF.md §6, which has
//   both designs' times): 64 samples x 2 levels beat 4 levels at every F
//   tried but F = 6 (2% slower there) and 1 level at every F; a cap of
//   128 registers a thread beat 64 and 255; two steps' loads in flight
//   beat one at F = 3, 8 and 16 and tied elsewhere.
// - K7bg is K7b's design at any F. It keeps one thread a sample walking
//   its levels in order (faster for K7b than a thread a (sample, level):
//   the samples resident at once work on about one level, so the working
//   set is a level of the 64 MiB table and of its 64 MiB gradient, not all
//   of both against the 50 MB L2), with dpos summed in registers. Its first
//   design sent 8F scalar atomics a sample-level and loaded a corner as F
//   scalars, reading its cotangent strided by Lw F floats across a warp
//   (2.1x slower at F = 4, PERF.md §6). Now the block's cotangent is
//   staged in shared memory, read coalesced, and a corner's F values are
//   loaded and added into the gradient V at a time: V = 4 (a float4 load
//   and Hopper's float4 atomicAdd on global memory), 2 (float2) or 1, the
//   largest that divides F and to whose width the table and the gradient
//   are aligned, chosen a launch. At F = 4 that is 8 vector loads and 8
//   float4 atomics a sample-level against the first design's 32 and 32;
//   F = 1 and 3 stay scalar. The 8 corners' loads of a step are in flight
//   together.
//   dpos keeps the first design's arithmetic (a corner's features in
//   order, the chain rule over the corners in order, the levels in order),
//   so it has the first design's bits, the same from call to call; the
//   atomics add in no fixed order (none where the corner's weight is 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr int kFwdSamples = 64;   // K7a: samples a block
constexpr int kFwdGroup = 4;      // K7a: levels a block, one warp a level per 32 samples
constexpr int kFwdThreads = kFwdSamples * kFwdGroup;
constexpr int kFwdBlocksPerSM = 6;  // K7a: at most 42 registers a thread
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

// Entries e & ~1 and e | 1 of the table, as f32: one aligned 16-byte (f32)
// or 8-byte (bf16) load.
template <bool kBF16>
__device__ __forceinline__ void load_pair(const void* __restrict__ table, long e, float2* lo,
                                          float2* hi) {
  if (kBF16) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(table) + (e >> 1));
    *lo = make_float2(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u));
    *hi = make_float2(__uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  } else {
    const float4 f = __ldg(reinterpret_cast<const float4*>(table) + (e >> 1));
    *lo = make_float2(f.x, f.y);
    *hi = make_float2(f.z, f.w);
  }
}

// Block b = g * sample_blocks + s: levels kFwdGroup*g .. of the window (the
// last group may be ragged) for samples kFwdSamples*s .. ; warp w takes
// level w / kWarpsPerLevel of the group over 32 consecutive samples. The
// block's positions and its (samples, levels) results pass through shared
// memory, so that both are read and written coalesced.
template <bool kBF16>
__global__ void __launch_bounds__(kFwdThreads, kFwdBlocksPerSM)
    ngp_fwd_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                   const float* __restrict__ scale, float2* __restrict__ out, int n, int L,
                   int lo, int log2_T, int sample_blocks) {
  constexpr int kWarpsPerLevel = kFwdSamples / 32;
  __shared__ float p_s[kFwdSamples * 3];
  __shared__ float2 o_s[kFwdSamples * kFwdGroup];  // (samples, levels), as in out
  const int g = blockIdx.x / sample_blocks;
  const long i0 = (long)(blockIdx.x - g * sample_blocks) * kFwdSamples;
  const int live = (int)min((long)kFwdSamples, (long)n - i0);
  const int l0 = g * kFwdGroup;
  const int levels = min(kFwdGroup, L - l0);
  for (int e = threadIdx.x; e < live * 3; e += kFwdThreads) p_s[e] = __ldg(pos + i0 * 3 + e);
  __syncthreads();
  const int j = (threadIdx.x >> 5) / kWarpsPerLevel;
  const int k = ((threadIdx.x >> 5) % kWarpsPerLevel) * 32 + (threadIdx.x & 31);
  if (j < levels && k < live) {
    const int l = l0 + j;
    const float sc = __ldg(scale + l);
    int b[3];
    float u[3][2];  // (1 - w, w) a dimension
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float s = __fmul_rn(p_s[k * 3 + d], sc);
      const float f = floorf(s);
      u[d][1] = __fsub_rn(s, f);
      u[d][0] = __fsub_rn(1.0f, u[d][1]);
      b[d] = (int)f;
    }
    const uint32_t mask = (1u << log2_T) - 1u;
    const long base = (long)(lo + l) << log2_T;
    const uint32_t hy[2] = {(uint32_t)b[1] * kPrime1, (uint32_t)(b[1] + 1) * kPrime1};
    const uint32_t hz[2] = {(uint32_t)b[2] * kPrime2, (uint32_t)(b[2] + 1) * kPrime2};
    // corner c = (cx << 2) | yz. With b[0] even, b[0] + 1 == b[0] | 1, so the
    // cx = 1 corner hashes to the cx = 0 corner's entry ^ 1 (the level's
    // base is even): the pair is one aligned load. With b[0] odd the cx = 1
    // corner is a load of its own.
    const bool paired = !(b[0] & 1);
    long e0[4];
    float2 p[4][2], x1[4];
#pragma unroll
    for (int yz = 0; yz < 4; ++yz) {
      const uint32_t r = hy[yz >> 1] ^ hz[yz & 1];
      e0[yz] = base + (long)(((uint32_t)b[0] ^ r) & mask);
      load_pair<kBF16>(table, e0[yz], &p[yz][0], &p[yz][1]);
      x1[yz] = make_float2(0.0f, 0.0f);
      if (!paired)
        x1[yz] = load_vertex<kBF16>(table, base + (long)(((uint32_t)(b[0] + 1) ^ r) & mask));
    }
    float2 v[8];
#pragma unroll
    for (int yz = 0; yz < 4; ++yz) {
      const bool odd = e0[yz] & 1;
      v[yz] = odd ? p[yz][1] : p[yz][0];
      v[4 + yz] = !paired ? x1[yz] : odd ? p[yz][0] : p[yz][1];
    }
    // (wx' * wy') * wz', and the corners added in order, as JAX and the
    // plain version add them
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float wt = __fmul_rn(__fmul_rn(u[0][c >> 2], u[1][(c >> 1) & 1]), u[2][c & 1]);
      const float t0 = __fmul_rn(v[c].x, wt), t1 = __fmul_rn(v[c].y, wt);
      a0 = c ? __fadd_rn(a0, t0) : t0;
      a1 = c ? __fadd_rn(a1, t1) : t1;
    }
    o_s[k * levels + j] = make_float2(a0, a1);
  }
  __syncthreads();
  // a sample's `levels` results are contiguous in out: 32 bytes at 4 levels
  float2* o = out + i0 * L + l0;
  for (int e = threadIdx.x; e < live * levels; e += kFwdThreads) {
    const int s = e / levels;
    o[(long)s * L + (e - s * levels)] = o_s[e];
  }
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

// Values e .. e + V - 1 of the table as f32: one load of V values (the
// caller keeps e a multiple of V and the table aligned to V values; V = 8
// only for a bf16 table, 16 bytes).
template <bool kBF16, int V>
__device__ __forceinline__ void load_vec(const void* __restrict__ table, long e, float v[V]) {
  if constexpr (kBF16) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(table) + e;
    if constexpr (V == 8) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    } else if constexpr (V == 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      v[0] = __uint_as_float(u.x << 16);
      v[1] = __uint_as_float(u.x & 0xffff0000u);
      v[2] = __uint_as_float(u.y << 16);
      v[3] = __uint_as_float(u.y & 0xffff0000u);
    } else if constexpr (V == 2) {
      const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
      v[0] = __uint_as_float(u << 16);
      v[1] = __uint_as_float(u & 0xffff0000u);
    } else {
      v[0] = __uint_as_float((uint32_t)__ldg(p) << 16);
    }
  } else {
    static_assert(V <= 4, "an f32 load takes at most 4 values");
    const float* p = reinterpret_cast<const float*>(table) + e;
    if constexpr (V == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else if constexpr (V == 2) {
      const float2 f = __ldg(reinterpret_cast<const float2*>(p));
      v[0] = f.x, v[1] = f.y;
    } else {
      v[0] = __ldg(p);
    }
  }
}

// p[0 .. V - 1] = v: one store of V floats (p aligned to V floats).
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float v[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

constexpr int kGenFwdSamples = 64;  // K7ag: samples a block
constexpr int kGenFwdGroup = 2;     // K7ag: levels a block at most, 2 warps a level
constexpr int kGenFwdBlocksPerSM = 4;  // K7ag: at most 128 registers a thread
constexpr size_t kGenFwdStage = 48 * 1024;  // K7ag: most bytes a block stages its output in

using GenFwdKernel = void (*)(const float*, const void*, const float*, float*, int, int, int, int,
                              int, int, int, int);

// K7ag: block b = g * sample_blocks + s takes levels `group` g .. of the
// window (the last group may be ragged) for samples kGenFwdSamples s .. ;
// warp w takes level w / 2 of the group over 32 consecutive samples, as
// K7a. A lane's corners are loaded V values at a time, the 8 loads of a
// step in flight together, and feature f is the corner-0 term, then
// corners 1..7 added in order (the plain version's bits). kPair (F == V,
// 2F values in at most 16 bytes): where the cube's base x is even, its two
// x-neighbours are entries h and h ^ 1, one aligned load of 2F values, as
// K7a's pair load. The block's positions are staged in shared memory and,
// where it fits (`staged`), its (samples, levels, F) output, written out
// contiguous; else each lane writes its F values to out.
template <bool kBF16, int V, bool kPair>
__global__ void __launch_bounds__(kGenFwdSamples * kGenFwdGroup, kGenFwdBlocksPerSM)
    ngp_fwd_f_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                     const float* __restrict__ scale, float* __restrict__ out, int n, int L,
                     int F, int lo, int log2_T, int sample_blocks, int group, int staged) {
  constexpr int kWarpsPerLevel = kGenFwdSamples / 32;
  extern __shared__ float fwd_smem[];
  float* p_s = fwd_smem;                        // (kGenFwdSamples, 3)
  float* o_s = fwd_smem + kGenFwdSamples * 3;   // (samples, levels, F), as in out
  const int g = blockIdx.x / sample_blocks;
  const long i0 = (long)(blockIdx.x - g * sample_blocks) * kGenFwdSamples;
  const int live = (int)min((long)kGenFwdSamples, (long)n - i0);
  const int l0 = g * group;
  const int levels = min(group, L - l0);
  for (int e = threadIdx.x; e < live * 3; e += blockDim.x) p_s[e] = __ldg(pos + i0 * 3 + e);
  __syncthreads();
  const int j = (threadIdx.x >> 5) / kWarpsPerLevel;
  const int k = ((threadIdx.x >> 5) % kWarpsPerLevel) * 32 + (threadIdx.x & 31);
  if (j < levels && k < live) {
    const int l = l0 + j;
    const float sc = __ldg(scale + l);
    int b[3];
    float u[3][2];  // (1 - w, w) a dimension
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float s = __fmul_rn(p_s[k * 3 + d], sc);
      const float f = floorf(s);
      u[d][1] = __fsub_rn(s, f);
      u[d][0] = __fsub_rn(1.0f, u[d][1]);
      b[d] = (int)f;
    }
    const uint32_t mask = (1u << log2_T) - 1u;
    const long base = (long)(lo + l) << log2_T;
    const uint32_t hy[2] = {(uint32_t)b[1] * kPrime1, (uint32_t)(b[1] + 1) * kPrime1};
    const uint32_t hz[2] = {(uint32_t)b[2] * kPrime2, (uint32_t)(b[2] + 1) * kPrime2};
    // corner c = (cx << 2) | yz weighs (wx' * wy') * wz', as JAX forms it
    float wt[8];
#pragma unroll
    for (int c = 0; c < 8; ++c)
      wt[c] = __fmul_rn(__fmul_rn(u[0][c >> 2], u[1][(c >> 1) & 1]), u[2][c & 1]);
    float* dst = staged ? o_s + (k * levels + j) * F : out + ((i0 + k) * L + l) * F;
    if constexpr (kPair) {
      // With b[0] even, b[0] + 1 == b[0] | 1, so the cx = 1 corner hashes to
      // the cx = 0 corner's entry ^ 1 (the level's base is even): the pair
      // is one aligned load. With b[0] odd the cx = 1 corner is a load of
      // its own.
      const bool paired = !(b[0] & 1);
      long e0[4];
      float p[4][2 * V], x1[4][V];
#pragma unroll
      for (int yz = 0; yz < 4; ++yz) {
        const uint32_t r = hy[yz >> 1] ^ hz[yz & 1];
        e0[yz] = base + (long)(((uint32_t)b[0] ^ r) & mask);
        load_vec<kBF16, 2 * V>(table, (e0[yz] & ~1L) * V, p[yz]);
#pragma unroll
        for (int f = 0; f < V; ++f) x1[yz][f] = 0.0f;
        if (!paired)
          load_vec<kBF16, V>(table, (base + (long)(((uint32_t)(b[0] + 1) ^ r) & mask)) * V, x1[yz]);
      }
      float acc[V];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int yz = c & 3;
        const bool odd = e0[yz] & 1;
#pragma unroll
        for (int f = 0; f < V; ++f) {
          const float lo_v = p[yz][f], hi_v = p[yz][V + f];
          const float x = c < 4 ? (odd ? hi_v : lo_v) : (!paired ? x1[yz][f] : odd ? lo_v : hi_v);
          const float t = __fmul_rn(x, wt[c]);
          acc[f] = c ? __fadd_rn(acc[f], t) : t;
        }
      }
      store_vec<V>(dst, acc);
    } else {
      // Past 16 bytes the pair's second entry is a load of its own all the
      // same (no load is wider than 16 bytes); at F = 4 f32 it lies in the
      // same 32-byte sector as the first, which L1 has just fetched.
      long e[8];  // the corners' first values
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint32_t h = (uint32_t)(b[0] + (c >> 2)) ^ hy[(c >> 1) & 1] ^ hz[c & 1];
        e[c] = (base + (long)(h & mask)) * F;
      }
      // two steps' 16 loads in flight together
#pragma unroll 2
      for (int f = 0; f < F; f += V) {
        float t[8][V];
#pragma unroll
        for (int c = 0; c < 8; ++c) load_vec<kBF16, V>(table, e[c] + f, t[c]);
        float acc[V];
#pragma unroll
        for (int q = 0; q < V; ++q) {
          acc[q] = __fmul_rn(t[0][q], wt[0]);
#pragma unroll
          for (int c = 1; c < 8; ++c) acc[q] = __fadd_rn(acc[q], __fmul_rn(t[c][q], wt[c]));
        }
        store_vec<V>(dst + f, acc);
      }
    }
  }
  if (!staged) return;
  __syncthreads();
  // sample s's `levels` F results are contiguous in out, at o + s L F
  const int run = levels * F;
  float* o = out + (i0 * L + l0) * F;
  if (F % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    const int run4 = run >> 2;
    for (int e = threadIdx.x; e < live * run4; e += blockDim.x) {
      const int s = e / run4;
      reinterpret_cast<float4*>(o + (long)s * L * F)[e - s * run4] =
          reinterpret_cast<const float4*>(o_s)[e];
    }
  } else {
    for (int e = threadIdx.x; e < live * run; e += blockDim.x) {
      const int s = e / run;
      o[(long)s * L * F + (e - s * run)] = o_s[e];
    }
  }
}

// K7ag's kernel for a table type, a load width V and the pair load.
template <bool kBF16>
GenFwdKernel gen_fwd_kernel(int V, bool pair) {
  if (pair) {
    if constexpr (kBF16)
      return V == 4   ? &ngp_fwd_f_kernel<true, 4, true>
             : V == 2 ? &ngp_fwd_f_kernel<true, 2, true>
                      : &ngp_fwd_f_kernel<true, 1, true>;
    else
      return V == 2 ? &ngp_fwd_f_kernel<false, 2, true> : &ngp_fwd_f_kernel<false, 1, true>;
  }
  return V == 4   ? &ngp_fwd_f_kernel<kBF16, 4, false>
         : V == 2 ? &ngp_fwd_f_kernel<kBF16, 2, false>
                  : &ngp_fwd_f_kernel<kBF16, 1, false>;
}

// dtable[e .. e + V - 1] += v: one float4 (V = 4) or float2 atomic, which
// Hopper runs on global memory, or a scalar one.
template <int V>
__device__ __forceinline__ void atomic_add_vec(float* p, const float v[V]) {
  if constexpr (V == 4)
    atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (V == 2)
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else
    atomicAdd(p, v[0]);
}

constexpr int kGenStageLd = kBwdSamples + 1;  // K7bg: the staged cotangent's row stride
constexpr size_t kSmemOptIn = 232448;  // the H100's most shared memory a block (227 KB)

using GenBwdKernel = void (*)(const float*, const void*, const float*, const float*, float*,
                              float*, int, int, int, int, int, int);

// K7bg: thread k of block b takes sample 64b + k at every window level, in
// level order, as K7b. A level's 8 corners are loaded V values at a time,
// the 8 loads of a step in flight together; d loss / d (a corner's weight)
// sums its features in order and the chain rule takes the corners in
// order (the first design's arithmetic, so dpos keeps its bits); the
// updates go into dtable V at a time. The cotangent of sample k, level l, feature f is
// g[(l F + f) gs + k gk]: staged in shared memory, read coalesced (gs =
// kGenStageLd, gk = 1), or, where it does not fit, read from gfeat (gs = 1,
// gk = L F).
template <bool kBF16, int V>
__global__ void __launch_bounds__(kBwdSamples)
    ngp_bwd_f_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                     const float* __restrict__ scale, const float* __restrict__ gfeat,
                     float* __restrict__ dpos, float* __restrict__ dtable, int n, int L, int F,
                     int lo, int log2_T, int staged) {
  extern __shared__ float g_stage[];  // (L F, kGenStageLd) where staged
  const long i0 = (long)blockIdx.x * kBwdSamples;
  const int live = (int)min((long)kBwdSamples, (long)n - i0);
  const int LF = L * F;
  const float* g = gfeat + i0 * LF;
  int gs = 1, gk = LF;
  if (staged) {  // read coalesced, stored transposed
    for (int e = threadIdx.x; e < live * LF; e += blockDim.x) {
      const int k = e / LF;
      g_stage[(e - k * LF) * kGenStageLd + k] = __ldg(gfeat + i0 * LF + e);
    }
    g = g_stage, gs = kGenStageLd, gk = 1;
  }
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
    const float* gl = g + (long)l * F * gs + (long)k * gk;  // gl[f gs]: feature f
    const long base = (long)(lo + l) << log2_T;
    long e[8];  // the corners' first values
    float wt[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) e[c] = corner(c, b, w, mask, base, &wt[c]) * F;
    // d loss / d weight of each corner, its features in order
    float dW[8];
    {
      float t[8][V];
#pragma unroll
      for (int c = 0; c < 8; ++c) load_vec<kBF16, V>(table, e[c], t[c]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gf = gl[j * gs];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          dW[c] = j ? __fadd_rn(dW[c], __fmul_rn(t[c][j], gf)) : __fmul_rn(t[c][j], gf);
      }
    }
    for (int f = V; f < F; f += V) {
      float t[8][V];
#pragma unroll
      for (int c = 0; c < 8; ++c) load_vec<kBF16, V>(table, e[c] + f, t[c]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float gf = gl[(f + j) * gs];
#pragma unroll
        for (int c = 0; c < 8; ++c) dW[c] = __fadd_rn(dW[c], __fmul_rn(t[c][j], gf));
      }
    }
    // the chain rule through (wx' * wy') * wz' as K7b takes it
    const float u[3][2] = {{__fsub_rn(1.0f, w[0]), w[0]},
                           {__fsub_rn(1.0f, w[1]), w[1]},
                           {__fsub_rn(1.0f, w[2]), w[2]}};
    float dw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int cx = c >> 2, cy = (c >> 1) & 1, cz = c & 1;
      const float ux = u[0][cx], uy = u[1][cy], uz = u[2][cz];
      const float dxy = __fmul_rn(dW[c], uz);
      const float term[3] = {__fmul_rn(dxy, uy), __fmul_rn(dxy, ux),
                             __fmul_rn(dW[c], __fmul_rn(ux, uy))};
      const int bit[3] = {cx, cy, cz};
#pragma unroll
      for (int d = 0; d < 3; ++d)
        dw[d] = bit[d] ? __fadd_rn(dw[d], term[d]) : __fsub_rn(dw[d], term[d]);
    }
    // the updates, none where a corner's weight is 0
    for (int f = 0; f < F; f += V) {
      float gf[V];
#pragma unroll
      for (int j = 0; j < V; ++j) gf[j] = gl[(f + j) * gs];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        if (wt[c] != 0.0f) {
          float upd[V];
#pragma unroll
          for (int j = 0; j < V; ++j) upd[j] = __fmul_rn(gf[j], wt[c]);
          atomic_add_vec<V>(dtable + e[c] + f, upd);
        }
    }
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
  // the x-pair loads: two entries, 16 bytes (f32) or 8 (bf16), aligned
  if (reinterpret_cast<uintptr_t>(table) % (table_bf16 ? 8 : 16))
    return (int)cudaErrorMisalignedAddress;
  const int sample_blocks = (n + kFwdSamples - 1) / kFwdSamples;
  const int groups = (L + kFwdGroup - 1) / kFwdGroup;
  const unsigned int blocks = (unsigned int)sample_blocks * groups;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float2* o = reinterpret_cast<float2*>(out);
  if (table_bf16)
    ngp_fwd_kernel<true><<<blocks, kFwdThreads, 0, s>>>(pos, table, scale, o, n, L, lo, log2_T,
                                                       sample_blocks);
  else
    ngp_fwd_kernel<false><<<blocks, kFwdThreads, 0, s>>>(pos, table, scale, o, n, L, lo, log2_T,
                                                        sample_blocks);
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

// K7ag. table (L_all*T, F) f32 or bf16 (table_bf16 = 1); out (n, L*F) f32;
// the rest as ngp_encode_fwd. A corner's values are loaded V = 4, 2 or 1
// at a time: the largest V that divides F and to whose width both the
// table and out are aligned; where F == V and 2F values fit in 16 bytes to
// whose width the table is aligned, a cube's x-pair is one load. The
// block's output is staged where it fits in kGenFwdStage bytes with the
// positions (F <= 94 at 2 levels a block), else written from registers.
int ngp_encode_fwd_f(const float* pos, const void* table, int table_bf16, const float* scale,
                     float* out, int n, int L, int F, int lo, int log2_T, void* stream) {
  if (n == 0) return 0;
  if (L < 1 || F < 1 || lo < 0 || log2_T < 1 || log2_T > 30) return (int)cudaErrorInvalidValue;
  const uintptr_t at = reinterpret_cast<uintptr_t>(table), ao = reinterpret_cast<uintptr_t>(out);
  const int elt = table_bf16 ? 2 : 4;
  int V = 4;
  while (V > 1 && (F % V || at % (V * elt) || ao % (V * 4))) V /= 2;
  const bool pair = F == V && 2 * F * elt <= 16 && at % (2 * F * elt) == 0;
  const int group = L < kGenFwdGroup ? L : kGenFwdGroup;
  const size_t staged_bytes = (size_t)kGenFwdSamples * (3 + group * F) * sizeof(float);
  const bool staged = staged_bytes <= kGenFwdStage;
  const size_t smem = staged ? staged_bytes : kGenFwdSamples * 3 * sizeof(float);
  const int sample_blocks = (n + kGenFwdSamples - 1) / kGenFwdSamples;
  const unsigned int blocks = (unsigned int)sample_blocks * ((L + group - 1) / group);
  GenFwdKernel kernel = table_bf16 ? gen_fwd_kernel<true>(V, pair) : gen_fwd_kernel<false>(V, pair);
  kernel<<<blocks, kGenFwdSamples * group, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      pos, table, scale, out, n, L, F, lo, log2_T, sample_blocks, group, staged ? 1 : 0);
  return (int)cudaGetLastError();
}

// K7bg. gfeat (n, L*F) f32; dpos (n, 3) f32 (written); dtable (L_all*T, F)
// f32 (added into: the caller passes zeros). A corner's values go V = 4, 2
// or 1 at a time: the largest V that divides F and to whose width both the
// table and dtable are aligned. The block's cotangent is staged in shared
// memory (past 48 KB by opting in) where it fits in 227 KB, else read from
// gfeat.
int ngp_encode_bwd_f(const float* pos, const void* table, int table_bf16, const float* scale,
                     const float* gfeat, float* dpos, float* dtable, int n, int L, int F, int lo,
                     int log2_T, void* stream) {
  if (n == 0) return 0;
  if (L < 1 || F < 1 || lo < 0 || log2_T < 1 || log2_T > 30) return (int)cudaErrorInvalidValue;
  const uintptr_t at = reinterpret_cast<uintptr_t>(table), ad = reinterpret_cast<uintptr_t>(dtable);
  const int elt = table_bf16 ? 2 : 4;
  int V = 4;
  while (V > 1 && (F % V || at % (V * elt) || ad % (V * 4))) V /= 2;
  const size_t staged_bytes = (size_t)L * F * kGenStageLd * sizeof(float);
  const bool staged = staged_bytes <= kSmemOptIn;
  const size_t smem = staged ? staged_bytes : 0;
  GenBwdKernel kernel = table_bf16 ? (V == 4   ? &ngp_bwd_f_kernel<true, 4>
                                     : V == 2 ? &ngp_bwd_f_kernel<true, 2>
                                              : &ngp_bwd_f_kernel<true, 1>)
                                   : (V == 4   ? &ngp_bwd_f_kernel<false, 4>
                                     : V == 2 ? &ngp_bwd_f_kernel<false, 2>
                                              : &ngp_bwd_f_kernel<false, 1>);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned int blocks = (unsigned int)((n + kBwdSamples - 1) / kBwdSamples);
  kernel<<<blocks, kBwdSamples, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      pos, table, scale, gfeat, dpos, dtable, n, L, F, lo, log2_T, staged ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
