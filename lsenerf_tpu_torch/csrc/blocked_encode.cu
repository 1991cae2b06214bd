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
// What bounds them on the card: bytes. Per sample-level K1 reads the 16
// values of one row that carry weight and writes 8 bytes; K2 reads the same
// 16 values and adds 8 nonzero 2-wide updates into an f32 gradient table,
// which its wrapper first zero-fills. The bf16 table (27 MB at the flagship
// size) fits in the 50 MB L2, so rows mostly come from L2, not HBM. What
// holds them back in practice is the rate of requests, not of bytes: the
// L2's rate of sector requests for rows scattered over the table (K1) and
// of atomic requests (K2, below). lsenerf_tpu_torch/l2_atomic_probe.py
// measures both rates.
//
// Design:
// - Only the 2x2x2 cube of vertices in slots {o, o+1} per dimension has
//   weight (19 of the 27 vertices of a stencil weigh exactly zero, and both
//   kernels skip them). For each of its 4 (x, y) pairs the two z-neighbours'
//   2 features are 4 contiguous values of the row, read as two 32-bit
//   (bf16) or 64-bit (f32) loads (load_pair): 16 values, not the row's 54.
//   So a non-finite value in a vertex outside the cube does not reach the
//   features, where the plain version's 27-term sum gives NaN.
// - K1: a block holds 32 neighbouring samples at every level, as K2's
//   does, in kFwdWarps warps, each taking every kFwdWarps-th level (fewer,
//   longer warps than K2's one per level: more blocks are resident at
//   once, and the last wave of blocks is shorter). Positions are read once
//   per block into shared memory, a level's scale and parameters once per
//   warp. For each level,
//   lane k first works out the row key, the cube's first vertex and the
//   fractions of sample k; then in 4 steps of 8 samples each group of 4
//   lanes takes one sample, lane q of the group its (x, y) pair
//   (q >> 1, q & 1), and the group sums its two features with two
//   __shfl_xor_sync. A warp's load instruction so touches at most 8 rows
//   (lines, for bf16), and the samples of a ray, neighbours in the block,
//   share the coarse levels' rows inside one instruction: two loads, ~2 L1
//   wavefronts and ~2.5 L2 sector requests per sample-level, where one
//   thread per sample-level with 7 16-byte loads of the row's prefix cost
//   ~7 and 4 (chip_smoke.py prints both counts).
//   The block's chunk of out (32 x L x 8 bytes, contiguous) is staged in
//   shared memory and written as 16-byte pieces. Keys and fractions are
//   computed in the kernel, so nothing but the output is written.
// - K2: one lane per (sample, level), 899,072 at the flagship's shape. A
//   warp holds 32 neighbouring samples of one level (the samples of a ray
//   are neighbours, so a warp's loads share coarse rows), and a block
//   holds the same 32 samples at every level, one warp per level (up to
//   kBwdWarps warps, each then taking every kBwdWarps-th level).
//   - What bounds K2 is the rate at which L2 takes atomic requests, about
//     the same for scattered atomics whatever their width (scalar, float2
//     or float4; lsenerf_tpu_torch/l2_atomic_probe.py measures it), while
//     the lanes of one warp instruction on one 32-byte sector make one
//     request. So each lane's 16 sums go through shared memory, and the
//     warp adds two sample-levels' values per instruction, 16 lanes on the
//     16 values of each: ~4-5 sector requests per sample-level, where one
//     float4 or two float2 atomics per (x, y) pair would cost 6, and 16
//     scalar atomics 16. (Merging the lanes of a warp that share a row
//     first, with __match_any_sync, was measured and gained nothing: few
//     lanes of a warp share a row, even at the coarse levels.)
//   - The position gradient's level terms go through shared memory and are
//     summed over the levels in level order, so dpos is the same from run
//     to run (the table gradient's atomics add in no fixed order).
//   - Keys and fractions are recomputed, not read from rows saved by the
//     forward. The table gradient is an exact f32 sum, with no per-window
//     cap and no bf16 rounding of the factors (the JAX backward has both).
// - s = p * scale uses __fmul_rn and w = s - b uses __fsub_rn: a fused
//   multiply-add would change w, and so the keys at cell boundaries.
// - The hash multiplies in uint32_t and wraps exactly as the JAX uint32 code.
// - The C entries launch on the caller's stream, allocate nothing, and
//   return cudaGetLastError().
//
// K1g blocked_encode_fwd_f and K2g blocked_encode_bwd_f are the same two
// functions at any F (features a vertex) other than 2, in rows of W =
// 32 * ceil(27F / 32) columns (27F used): they replace P1 and P2 where the
// JAX package runs them with another F (_combine_kernel and _bwd_kernel
// take F as a parameter). F and W are arguments, so every F >= 1 works.
// They are bound by the same two rates as K1 and K2, scattered row loads
// and scattered atomics, now 8F values and 8F updates a sample-level.
// - K1g is K1's design at any F. Its first design gave a thread a
//   (sample, level) (thread t: sample t / L, level t % L) with 8F scalar
//   loads of its cube, every level live at once (PERF.md §6 has both
//   designs' times). Now, as K1: a block takes 32 neighbouring samples at
//   every level, in up to kGenFwdWarps warps that each take every
//   warps-th level; lane k works out sample k's key, first vertex and
//   fractions with level_key (the same keys); then each group of 4 lanes
//   takes one sample of 8 in each of 4 steps, lane q its (x, y) pair,
//   whose z-neighbours are 2F contiguous values of the row. A lane loads
//   them V values a vertex (V = 4, 2 or 1, as K2g chooses it), the 4
//   steps' loads in flight together. (Loading a pair whose first vertex
//   is even as one 16-byte load at F = 4 bf16, and the rest as two, was
//   measured slower, PERF.md §6.)
//   The group adds its 4 lanes' terms with a shuffle reduce-scatter,
//   V features at a time, so any F works. The block's (32, L, F) output
//   is staged in shared memory and written as 16-byte pieces; past 48 KB
//   (L F > 381) each sum is written where it is made. Every product and
//   sum is rounded on its own (__fmul_rn, __fadd_rn), so K1g is a fixed
//   order of f32 operations (gbwd_compare.k1g_sums repeats it on any
//   device): within rtol 1e-5 of the plain version's 27-term sum.
// - K2g is K2's design at any F. Its first design, a thread a sample,
//   sent 8F scalar atomics a sample-level, each its own L2 request (32 at
//   F = 4), and read its cotangent strided by L F floats across a warp
//   (2.2x slower at F = 4, PERF.md §6). Now a block takes 32 neighbouring
//   samples at every level, one
//   warp a level (at most kGenBwdWarps, as many as 48 KB of shared memory
//   holds, each then taking every warps-th level), with positions and the
//   cotangent staged in shared memory, read coalesced. A lane takes one
//   (sample, level): it loads the cube's 8 vertices V values at a time
//   (V = 4, 2 or 1, a vector load where F and the table's alignment allow),
//   the 8 loads of a step in flight together, and writes its level's dpos
//   term to shared memory; the terms are summed over the levels in level
//   order. Its 8F updates, (x, y) run by run (2F contiguous values: the
//   z-neighbours v and v + 1; past F = kGenChunk, kGenChunk features of
//   each vertex at a time, so that any F fits), go to its entry in the
//   warp's slice of shared memory, and the warp adds the 32 entries with
//   consecutive lanes on consecutive values, skipping zeros, so that the
//   lanes of one
//   instruction on one 32-byte sector make one request: ~6 a sample-level
//   at F = 4 (a 32-byte run spans 1.5 sectors), where float4 atomics would
//   make 8 and scalar ones 32 (gbwd_compare.requests counts both designs).
//   dpos keeps the first design's arithmetic (each vertex's features in
//   order, the vertices in slot order, the level terms added from 0 in
//   level order), so it has the first design's bits, the same from call to
//   call; the table gradient's atomics add in no fixed order. Per-lane
//   vector atomics in place of the staged scatter (8 float4s a
//   sample-level at F = 4) were measured slower at every F.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;
constexpr int kFwdWarps = 4;  // K1: warps per block, each taking every 4th level
constexpr int kBwdWarps = 16;  // K2: warps (levels) per block
constexpr int kEntry = 18;  // K2's entry: 16 gradient values, row, parities

size_t fwd_smem_bytes(int L) { return (size_t)(96 + 64 * L) * sizeof(float); }

size_t bwd_smem_bytes(int L, int warps) {
  return (size_t)(96 + 64 * L + 96 * L + warps * 32 * kEntry) * sizeof(float);
}

// lp = (res, bdim, dense flag, global row offset) of one level. Fills the
// fraction w and the parity o per dimension, returns the global row key.
__device__ __forceinline__ int level_key(const float* __restrict__ pos,
                                         long i, float scale, int4 lp,
                                         uint32_t hash_mask, float w[3],
                                         int o[3]) {
  int k[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float s = __fmul_rn(pos[i * 3 + d], scale);
    int b = (int)floorf(s);
    b = min(max(b, 0), lp.x - 1);
    w[d] = __fsub_rn(s, (float)b);
    k[d] = b >> 1;
    o[d] = b & 1;
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

// Columns 2v .. 2v+3 of row `key` as f32: vertices v and v + 1 (z
// neighbours), 2 features each.
template <bool kBF16>
__device__ __forceinline__ float4 load_pair(const void* __restrict__ table,
                                            int key, int v) {
  if (kBF16) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(table) + (long)key * 32 + v;
    uint32_t a = __ldg(p), b = __ldg(p + 1);
    return make_float4(__uint_as_float(a << 16), __uint_as_float(a & 0xffff0000u),
                       __uint_as_float(b << 16), __uint_as_float(b & 0xffff0000u));
  }
  const float2* p = reinterpret_cast<const float2*>(table) + (long)key * 32 + v;
  float2 a = __ldg(p), b = __ldg(p + 1);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Block b: samples 32b .. 32b+31; warp w takes levels w, w + warps, ...
// Dynamic shared memory (fwd_smem_bytes): the block's positions (32 x 3),
// read once, coalesced, and its chunk of out (32 x L x 2), written once.
template <bool kBF16>
__global__ void __launch_bounds__(kFwdWarps * 32)
    encode_fwd_kernel(const float* __restrict__ pos,
                      const void* __restrict__ table,
                      const float* __restrict__ scale,
                      const int4* __restrict__ lvl, float* __restrict__ out,
                      int n, int L, uint32_t hash_mask) {
  extern __shared__ float smem[];
  float* pos_s = smem;        // (32, 3)
  float* out_s = smem + 96;   // (32, L, 2), as in out
  const int lane = threadIdx.x & 31;
  const long i0 = (long)blockIdx.x * 32;
  const int live_n = (int)min((long)32, (long)n - i0);
  for (int e = threadIdx.x; e < live_n * 3; e += blockDim.x) pos_s[e] = __ldg(pos + i0 * 3 + e);
  __syncthreads();
  // this lane's (x, y) pair in its group: vertex v0 + dv and its z neighbour
  const int q = lane & 3, a = q >> 1, b = q & 1, dv = a * 9 + b * 3;
  for (int l = threadIdx.x >> 5; l < L; l += blockDim.x >> 5) {
    float w[3] = {0.0f, 0.0f, 0.0f};
    int o[3] = {0, 0, 0};
    int key = 0;
    if (lane < live_n) key = level_key(pos_s, lane, __ldg(scale + l), __ldg(lvl + l), hash_mask, w, o);
    const int v0 = (o[0] * 3 + o[1]) * 3 + o[2];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = s * 8 + (lane >> 2);  // the group's sample
      const int kk = __shfl_sync(0xffffffffu, key, k);
      const int kv = __shfl_sync(0xffffffffu, v0, k);
      const float wx = __shfl_sync(0xffffffffu, w[0], k);
      const float wy = __shfl_sync(0xffffffffu, w[1], k);
      const float wz = __shfl_sync(0xffffffffu, w[2], k);
      float acc0 = 0.0f, acc1 = 0.0f;
      if (k < live_n) {
        const float4 r = load_pair<kBF16>(table, kk, kv + dv);
        const float wxy = (a ? wx : 1.0f - wx) * (b ? wy : 1.0f - wy);
        const float w0 = wxy * (1.0f - wz), w1 = wxy * wz;
        acc0 = w0 * r.x + w1 * r.z;
        acc1 = w0 * r.y + w1 * r.w;
      }
      // the group's sums: the first exchange leaves feature q & 1 of two
      // pairs in lane q, the second of all four
      float f = (q & 1) ? acc1 : acc0;
      f += __shfl_xor_sync(0xffffffffu, (q & 1) ? acc0 : acc1, 1);
      f += __shfl_xor_sync(0xffffffffu, f, 2);
      if (q < 2 && k < live_n) out_s[(k * L + l) * 2 + q] = f;
    }
  }
  __syncthreads();
  float* dst = out + i0 * L * 2;  // 16-byte aligned: i0 is a multiple of 32
  const int count = live_n * L * 2, vecs = count >> 2;
  for (int e = threadIdx.x; e < vecs; e += blockDim.x)
    reinterpret_cast<float4*>(dst)[e] = reinterpret_cast<const float4*>(out_s)[e];
  for (int e = vecs * 4 + threadIdx.x; e < count; e += blockDim.x) dst[e] = out_s[e];
}

// Block b: samples 32b .. 32b+31, lane = sample; warp w takes levels w,
// w + warps, ... Dynamic shared memory (bwd_smem_bytes): the block's
// positions (32 x 3) and cotangent (L x 32 x 2), each read once, coalesced;
// the dpos terms (L x 32 x 3); each warp's table-gradient entries.
template <bool kBF16>
__global__ void __launch_bounds__(kBwdWarps * 32)
    encode_bwd_kernel(const float* __restrict__ pos,
                      const void* __restrict__ table,
                      const float* __restrict__ scale,
                      const int4* __restrict__ lvl,
                      const float* __restrict__ gfeat,
                      float* __restrict__ dpos, float* __restrict__ dtable,
                      int n, int L, uint32_t hash_mask) {
  extern __shared__ float smem[];
  float* pos_s = smem;                // (32, 3)
  float2* g_s = reinterpret_cast<float2*>(smem + 96);  // (L, 32)
  float* part = smem + 96 + 64 * L;   // (L, 32, 3): each level's dpos term
  float* scatter = part + 96 * L;     // per warp: 32 entries of kEntry
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long i0 = (long)blockIdx.x * 32;
  const int live_n = (int)min((long)32, (long)n - i0);
  for (int e = threadIdx.x; e < live_n * 3; e += blockDim.x) pos_s[e] = __ldg(pos + i0 * 3 + e);
  for (int e = threadIdx.x; e < live_n * L; e += blockDim.x)  // transposed
    g_s[(e % L) * 32 + e / L] = __ldg(reinterpret_cast<const float2*>(gfeat) + i0 * L + e);
  __syncthreads();
  const bool live = lane < live_n;
  for (int l = threadIdx.x >> 5; l < L; l += warps) {
    const float sc = __ldg(scale + l);
    float w[3] = {0.0f, 0.0f, 0.0f};
    int o[3] = {0, 0, 0};
    int key = 0;
    float2 g = make_float2(0.0f, 0.0f);
    if (live) {
      key = level_key(pos_s, lane, sc, __ldg(lvl + l), hash_mask, w, o);
      g = g_s[l * 32 + lane];
    }
    // the weights of slots o and o + 1 per dimension
    const float ux[2] = {1.0f - w[0], w[0]};
    const float uy[2] = {1.0f - w[1], w[1]};
    const float uz[2] = {1.0f - w[2], w[2]};
    float du[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
    float upd[16];  // per (x, y) pair: w0 g.x, w0 g.y, w1 g.x, w1 g.y
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int v = ((o[0] + a) * 3 + o[1] + b) * 3 + o[2];
        const float4 r = live ? load_pair<kBF16>(table, key, v)
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float gv[2] = {g.x * r.x + g.y * r.y, g.x * r.z + g.y * r.w};
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          du[0][a] += gv[c] * uy[b] * uz[c];
          du[1][b] += gv[c] * ux[a] * uz[c];
          du[2][c] += gv[c] * ux[a] * uy[b];
        }
        const float wxy = ux[a] * uy[b];
        const float w0 = wxy * uz[0], w1 = wxy * uz[1];
        const int q = (a * 2 + b) * 4;
        upd[q] = w0 * g.x;
        upd[q + 1] = w0 * g.y;
        upd[q + 2] = w1 * g.x;
        upd[q + 3] = w1 * g.y;
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d)
      part[(l * 32 + lane) * 3 + d] = (du[d][1] - du[d][0]) * sc;

    // The sums go out through the warp's slice of shared memory, one entry
    // per lane (16 values, the row, the parities); then each warp
    // instruction adds two entries, 16 lanes on the 16 values of each, so
    // that the values of one entry that share a 32-byte sector reach L2 as
    // one request.
    float* ent = scatter + (threadIdx.x >> 5) * (32 * kEntry);
    if (live) {
      float* e = ent + lane * kEntry;
#pragma unroll
      for (int q = 0; q < 16; ++q) e[q] = upd[q];
      e[16] = __int_as_float(key);
      e[17] = __int_as_float(o[0] << 2 | o[1] << 1 | o[2]);
    }
    __syncwarp();
    const int q = lane & 15, pair = q >> 2;
    for (int k = lane >> 4; k < live_n; k += 2) {
      const float* e = ent + k * kEntry;
      const int oc = __float_as_int(e[17]);
      const int v = (((oc >> 2) + (pair >> 1)) * 3 + ((oc >> 1) & 1) + (pair & 1)) * 3 + (oc & 1);
      const float val = e[q];
      if (val != 0.0f)
        atomicAdd(dtable + (long)__float_as_int(e[16]) * 64 + 2 * v + (q & 3), val);
    }
    __syncwarp();
  }
  __syncthreads();
  // dpos: t sums sample t / 3, dimension t % 3 over the levels (a block of
  // fewer than 96 threads takes several t each)
  for (int t = threadIdx.x; t < live_n * 3; t += blockDim.x) {
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) acc += part[l * 96 + t];
    dpos[i0 * 3 + t] = acc;
  }
}

// Values e .. e + V - 1 of the table as f32: one load of V values (the
// caller keeps e a multiple of V and the table aligned to V values).
template <bool kBF16, int V>
__device__ __forceinline__ void load_vec(const void* __restrict__ table, long e, float v[V]) {
  if constexpr (kBF16) {
    const unsigned short* p = reinterpret_cast<const unsigned short*>(table) + e;
    if constexpr (V == 4) {
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

constexpr int kGenFwdWarps = 4;  // K1g: warps a block at most, each taking every warps-th level
constexpr size_t kGenFwdStage = 48 * 1024;  // K1g: most bytes a block stages its output in

using GenFwdKernel = void (*)(const float*, const void*, const float*, const int4*, float*, int,
                              int, int, int, uint32_t, int);

// The sum of x over the 4 lanes of a group, lane q = 2a + b on its (x, y)
// pair (a, b): (T(0, 0) + T(0, 1)) + (T(1, 0) + T(1, 1)) for each of V
// features, as a reduce-scatter. Returns lane q's feature: V = 4, 2 (q & 1)
// + (q >> 1); V = 2, q & 1; V = 1, 0.
template <int V>
__device__ __forceinline__ float group_sum(const float x[V], int q) {
  const int h = q & 1;
  if constexpr (V == 4) {
    // the b pairs: lane q keeps features 2h, 2h + 1; then the a pairs
    const float y0 = __fadd_rn(h ? x[2] : x[0], __shfl_xor_sync(0xffffffffu, h ? x[0] : x[2], 1));
    const float y1 = __fadd_rn(h ? x[3] : x[1], __shfl_xor_sync(0xffffffffu, h ? x[1] : x[3], 1));
    const int m = q >> 1;
    return __fadd_rn(m ? y1 : y0, __shfl_xor_sync(0xffffffffu, m ? y0 : y1, 2));
  } else if constexpr (V == 2) {
    const float y = __fadd_rn(x[h], __shfl_xor_sync(0xffffffffu, x[1 - h], 1));
    return __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, 2));
  } else {
    const float y = __fadd_rn(x[0], __shfl_xor_sync(0xffffffffu, x[0], 1));
    return __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, 2));
  }
}

// K1g: block b takes samples 32b .. 32b+31 at every level; warp w takes
// levels w, w + warps, ... For each level lane k works out sample k's key,
// first vertex and fractions (level_key: K1's keys); then in 4 steps of 8
// samples each group of 4 lanes takes one sample, lane q = 2a + b its
// (x, y) pair (a, b), whose z-neighbours v, v + 1 are 2F contiguous values
// of the row. For each V features (a chunk; any F works) the lane loads
// them V values a vertex, the 4 steps' 8 loads in flight together, weighs
// them (ux uy) (1 - wz) and (ux uy) wz, and the group adds its 4 lanes'
// terms (group_sum), every product and sum rounded
// on its own (no fused multiply-add), so that the arithmetic is a fixed
// order of f32 operations. Dynamic shared memory: the block's positions
// (32 x 3), read once, coalesced, and, where it fits (`staged`), its chunk
// of out (32 x L x F, contiguous), written as 16-byte pieces; else each
// feature is written to out where it is summed.
template <bool kBF16, int V>
__global__ void __launch_bounds__(kGenFwdWarps * 32)
    encode_fwd_f_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                        const float* __restrict__ scale, const int4* __restrict__ lvl,
                        float* __restrict__ out, int n, int L, int F, int W,
                        uint32_t hash_mask, int staged) {
  extern __shared__ float smem[];
  float* pos_s = smem;       // (32, 3)
  float* out_s = smem + 96;  // (32, L, F), as in out, where staged
  const int lane = threadIdx.x & 31;
  const long i0 = (long)blockIdx.x * 32;
  const int live_n = (int)min((long)32, (long)n - i0);
  const int LF = L * F;
  for (int e = threadIdx.x; e < live_n * 3; e += blockDim.x) pos_s[e] = __ldg(pos + i0 * 3 + e);
  __syncthreads();
  float* dst = staged ? out_s : out + i0 * LF;  // sample k, level l, feature f at (k L + l) F + f
  const int q = lane & 3, a = q >> 1, b = q & 1, dv = a * 9 + b * 3;
  const int fq = V == 4 ? 2 * b + a : V == 2 ? b : 0;  // the feature group_sum leaves lane q
  for (int l = threadIdx.x >> 5; l < L; l += blockDim.x >> 5) {
    float w[3] = {0.0f, 0.0f, 0.0f};
    int o[3] = {0, 0, 0};
    int key = 0;
    if (lane < live_n)
      key = level_key(pos_s, lane, __ldg(scale + l), __ldg(lvl + l), hash_mask, w, o);
    const int v0 = (o[0] * 3 + o[1]) * 3 + o[2];
    // step s: the group's sample k[s], its run's first value and its weights
    int k[4];
    long r[4];
    float w0[4], w1[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      k[s] = s * 8 + (lane >> 2);
      const int kk = __shfl_sync(0xffffffffu, key, k[s]);
      const int kv = __shfl_sync(0xffffffffu, v0, k[s]);
      const float wx = __shfl_sync(0xffffffffu, w[0], k[s]);
      const float wy = __shfl_sync(0xffffffffu, w[1], k[s]);
      const float wz = __shfl_sync(0xffffffffu, w[2], k[s]);
      r[s] = (long)kk * W + (long)(kv + dv) * F;
      const float wxy = __fmul_rn(a ? wx : __fsub_rn(1.0f, wx), b ? wy : __fsub_rn(1.0f, wy));
      w0[s] = __fmul_rn(wxy, __fsub_rn(1.0f, wz));
      w1[s] = __fmul_rn(wxy, wz);
    }
    for (int f = 0; f < F; f += V) {
      float t[4][2][V];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int j = 0; j < V; ++j) t[s][0][j] = t[s][1][j] = 0.0f;
        if (k[s] < live_n) {
          load_vec<kBF16, V>(table, r[s] + f, t[s][0]);
          load_vec<kBF16, V>(table, r[s] + F + f, t[s][1]);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float x[V];
#pragma unroll
        for (int j = 0; j < V; ++j)
          x[j] = __fadd_rn(__fmul_rn(w0[s], t[s][0][j]), __fmul_rn(w1[s], t[s][1][j]));
        const float sum = group_sum<V>(x, q);
        if (q < V && k[s] < live_n) dst[((long)k[s] * L + l) * F + f + fq] = sum;
      }
    }
  }
  if (!staged) return;
  __syncthreads();
  float* o = out + i0 * LF;  // 16-byte aligned where out is: i0 is a multiple of 32
  const int count = live_n * LF;
  int done = 0;
  if (reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    done = (count >> 2) << 2;
    for (int e = threadIdx.x; e < (count >> 2); e += blockDim.x)
      reinterpret_cast<float4*>(o)[e] = reinterpret_cast<const float4*>(out_s)[e];
  }
  for (int e = done + threadIdx.x; e < count; e += blockDim.x) o[e] = out_s[e];
}

constexpr int kGenBwdWarps = 16;  // K2g: warps (levels) a block, at most
constexpr int kGenStageLd = 33;   // K2g: the staged cotangent's row stride (32 samples + 1)
constexpr int kGenChunk = 8;      // K2g: a corner's features an entry holds, at most
constexpr size_t kSmemOptIn = 232448;  // the H100's most shared memory a block (227 KB)

// K2g's dynamic shared memory in 4-byte words: positions (32 x 3), the dpos
// terms (L x 32 x 3), the cotangent (L F x kGenStageLd) where staged, and a
// warp's entries (32 x (8 Fc + 1), Fc = min(F, kGenChunk)) with their rows
// and first columns (2 x 32).
size_t gen_bwd_words(int L, int F, int warps, bool staged) {
  const size_t fc = F < kGenChunk ? F : kGenChunk;
  return 96 + 96 * (size_t)L + (staged ? (size_t)kGenStageLd * L * F : 0) +
         (size_t)warps * (32 * (8 * fc + 1) + 64);
}

using GenBwdKernel = void (*)(const float*, const void*, const float*, const int4*,
                              const float*, float*, float*, int, int, int, int, uint32_t, int);

// K2g: block b takes samples 32b .. 32b+31 at every level, lane = sample;
// warp w takes levels w, w + warps, ... in turn. For each level a lane
// loads its sample's cube V values at a time (the 8 corners' loads of a
// step in flight together), computes its dpos term with the first
// design's arithmetic (each corner's features in order, the corners in slot
// order) and writes its updates to its entry in the warp's slice of shared
// memory: all 8F (corner c's feature f at c F + f, so that run q of the
// cube, corners 2q and 2q + 1, is values 2qF .. 2qF + 2F - 1) or, kChunked
// (F > kGenChunk), kGenChunk features of each corner at a time. The warp
// then adds its 32 entries into dtable with consecutive lanes on
// consecutive values, so that the lanes on one 32-byte sector make one L2
// request. The cotangent of sample k, level l, feature f is
// g[(l F + f) gs + k gk]: staged in shared memory (gs = kGenStageLd, gk =
// 1) or, where it does not fit, read from gfeat (gs = 1, gk = L F). The two
// forms of the entries are two instantiations because the one that holds
// a whole cube compiles to the faster kernel at F <= kGenChunk (on the
// H100 0.110 against 0.124 ms at F = 4, PERF.md §6), the chunked one at
// F = 16.
template <bool kBF16, int V, bool kChunked>
__global__ void __launch_bounds__(kGenBwdWarps * 32)
    encode_bwd_f_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                        const float* __restrict__ scale, const int4* __restrict__ lvl,
                        const float* __restrict__ gfeat, float* __restrict__ dpos,
                        float* __restrict__ dtable, int n, int L, int F, int W,
                        uint32_t hash_mask, int staged) {
  extern __shared__ float smem[];
  float* pos_s = smem;         // (32, 3)
  float* part = smem + 96;     // (L, 32, 3): each level's dpos term
  float* g_s = part + 96 * L;  // (L F, kGenStageLd) where staged
  const int Fc = kChunked ? kGenChunk : F;  // a corner's features an entry holds
  const int S = 8 * Fc + 1;  // an entry's stride (odd: no bank conflicts)
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  float* ent = g_s + (staged ? kGenStageLd * L * F : 0) + (threadIdx.x >> 5) * (32 * S + 64);
  int* rows = reinterpret_cast<int*>(ent + 32 * S);  // an entry's row and first column
  int* cols = rows + 32;
  const long i0 = (long)blockIdx.x * 32;
  const int live_n = (int)min((long)32, (long)n - i0);
  const int LF = L * F;
  for (int e = threadIdx.x; e < live_n * 3; e += blockDim.x) pos_s[e] = __ldg(pos + i0 * 3 + e);
  const float* g = gfeat + i0 * LF;
  int gs = 1, gk = LF;
  if (staged) {  // read coalesced, stored transposed
    for (int e = threadIdx.x; e < live_n * LF; e += blockDim.x) {
      const int k = e / LF;
      g_s[(e - k * LF) * kGenStageLd + k] = __ldg(gfeat + i0 * LF + e);
    }
    g = g_s, gs = kGenStageLd, gk = 1;
  }
  __syncthreads();
  const bool live = lane < live_n;
  // a whole cube's entry: the lane's first value of the scatter (entry k0,
  // value j0) and its step of 32
  const int E = 8 * F, k0 = lane / E, j0 = lane - k0 * E, dk = 32 / E, dj = 32 % E;
  const int D = 2 * F;  // a run's values
  for (int l = threadIdx.x >> 5; l < L; l += warps) {
    const float sc = __ldg(scale + l);
    float w[3] = {0.0f, 0.0f, 0.0f};
    int o[3] = {0, 0, 0};
    int key = 0;
    if (live) key = level_key(pos_s, lane, sc, __ldg(lvl + l), hash_mask, w, o);
    const float u[3][2] = {{1.0f - w[0], w[0]}, {1.0f - w[1], w[1]}, {1.0f - w[2], w[2]}};
    // du[d][s]: d loss / d (weight of slot o + s in dimension d)
    float du[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
    const int v0 = (o[0] * 3 + o[1]) * 3 + o[2];
    const float* gl = g + (long)l * F * gs + (long)lane * gk;  // gl[f gs]: feature f
    float wt[8];  // kChunked: the corners' weights
    if (live) {
      const long row = (long)key * W;
      float gv[8];  // d loss / d (corner c's weight), its features in order
#pragma unroll
      for (int c = 0; c < 8; ++c) gv[c] = 0.0f;
      for (int f = 0; f < F; f += V) {
        float t[8][V];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          load_vec<kBF16, V>(table, row + (v0 + (c >> 2) * 9 + ((c >> 1) & 1) * 3 + (c & 1)) * F + f,
                             t[c]);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float gf = gl[(f + j) * gs];
#pragma unroll
          for (int c = 0; c < 8; ++c) gv[c] = __fadd_rn(gv[c], __fmul_rn(t[c][j], gf));
        }
      }
      float* e = ent + lane * S;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int a = c >> 2, b = (c >> 1) & 1, z = c & 1;
        du[0][a] = __fadd_rn(du[0][a], __fmul_rn(__fmul_rn(gv[c], u[1][b]), u[2][z]));
        du[1][b] = __fadd_rn(du[1][b], __fmul_rn(__fmul_rn(gv[c], u[0][a]), u[2][z]));
        du[2][z] = __fadd_rn(du[2][z], __fmul_rn(__fmul_rn(gv[c], u[0][a]), u[1][b]));
        wt[c] = __fmul_rn(__fmul_rn(u[0][a], u[1][b]), u[2][z]);
        if constexpr (!kChunked)
          for (int f = 0; f < F; ++f) e[c * F + f] = __fmul_rn(wt[c], gl[f * gs]);
      }
      rows[lane] = key;
      cols[lane] = v0 * F;
    }
    if constexpr (!kChunked) {
      __syncwarp();
      // the warp's live_n x 8F values, 32 a step: lane takes value j of
      // entry k, value j - 2qF of its run q, which starts (9 (q >> 1) +
      // 3 (q & 1)) F past the entry's first column
      for (int k = k0, j = j0; k < live_n;) {
        const float val = ent[k * S + j];
        if (val != 0.0f) {
          const int q = (j >= D) + (j >= 2 * D) + (j >= 3 * D);
          const int col = cols[k] + ((q >> 1) * 9 + (q & 1) * 3) * F + j - q * D;
          atomicAdd(dtable + (long)rows[k] * W + col, val);
        }
        k += dk, j += dj;
        if (j >= E) j -= E, ++k;
      }
      __syncwarp();
    } else {
      for (int f0 = 0; f0 < F; f0 += Fc) {  // features f0 .. f0 + fc - 1 of each corner
        const int fc = min(Fc, F - f0), Ec = 8 * fc;
        if (live) {
          float* e = ent + lane * S;
#pragma unroll
          for (int c = 0; c < 8; ++c)
            for (int f = 0; f < fc; ++f) e[c * fc + f] = __fmul_rn(wt[c], gl[(f0 + f) * gs]);
        }
        __syncwarp();
        // the warp's live_n x 8 fc values, 32 a step: lane takes value j of
        // entry k, corner c's feature f0 + j - c fc, which lies (9 (c >> 2)
        // + 3 ((c >> 1) & 1) + (c & 1)) F + f0 past the entry's first column
        int k = lane / Ec, j = lane - k * Ec;
        const int dkc = 32 / Ec, djc = 32 % Ec;
        while (k < live_n) {
          const float val = ent[k * S + j];
          if (val != 0.0f) {
            int c = 0;
#pragma unroll
            for (int m = 1; m < 8; ++m) c += j >= m * fc;
            const int off = (c >> 2) * 9 + ((c >> 1) & 1) * 3 + (c & 1);
            atomicAdd(dtable + (long)rows[k] * W + cols[k] + off * F + f0 + j - c * fc, val);
          }
          k += dkc, j += djc;
          if (j >= Ec) j -= Ec, ++k;
        }
        __syncwarp();
      }
    }
    // the slots o and o + 1 weigh 1 - w and w: d w = du[1] - du[0]
#pragma unroll
    for (int d = 0; d < 3; ++d)
      part[(l * 32 + lane) * 3 + d] = __fmul_rn(__fsub_rn(du[d][1], du[d][0]), sc);
  }
  __syncthreads();
  // dpos: t sums sample t / 3, dimension t % 3 over the levels in level order
  for (int t = threadIdx.x; t < live_n * 3; t += blockDim.x) {
    float acc = 0.0f;
    for (int l = 0; l < L; ++l) acc = __fadd_rn(acc, part[l * 96 + t]);
    dpos[i0 * 3 + t] = acc;
  }
}

// K2g's kernel for a table type, a load width V and the entries' form.
template <bool kChunked>
GenBwdKernel gen_bwd_kernel(int table_bf16, int V) {
  if (table_bf16)
    return V == 4   ? &encode_bwd_f_kernel<true, 4, kChunked>
           : V == 2 ? &encode_bwd_f_kernel<true, 2, kChunked>
                    : &encode_bwd_f_kernel<true, 1, kChunked>;
  return V == 4   ? &encode_bwd_f_kernel<false, 4, kChunked>
         : V == 2 ? &encode_bwd_f_kernel<false, 2, kChunked>
                  : &encode_bwd_f_kernel<false, 1, kChunked>;
}

}  // namespace

extern "C" {

// pos (n, 3) f32; table (rows, 64) bf16 (table_bf16=1) or f32; scale (L,)
// f32; lvl (L, 4) int32 = (res, bdim, dense flag, row offset); out
// (n, L*2) f32. All device pointers.
int blocked_encode_fwd(const float* pos, const void* table, int table_bf16,
                       const float* scale, const int* lvl, float* out, int n,
                       int L, unsigned int hash_mask, void* stream) {
  if (n == 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(L);  // 4.4 KB at 16 levels
  const unsigned int blocks = (unsigned int)((n + 31) / 32);
  const unsigned int threads = 32 * (L < kFwdWarps ? L : kFwdWarps);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* lv = reinterpret_cast<const int4*>(lvl);
  if (table_bf16)
    encode_fwd_kernel<true><<<blocks, threads, smem, s>>>(pos, table, scale, lv,
                                                          out, n, L, hash_mask);
  else
    encode_fwd_kernel<false><<<blocks, threads, smem, s>>>(pos, table, scale, lv,
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
  if (L < 1) return (int)cudaErrorInvalidValue;
  const int warps = L < kBwdWarps ? L : kBwdWarps;
  const size_t smem = bwd_smem_bytes(L, warps);
  if (smem > 48 * 1024) {  // many levels: opt in to more shared memory
    cudaError_t e = cudaFuncSetAttribute(
        table_bf16 ? encode_bwd_kernel<true> : encode_bwd_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned int blocks = (unsigned int)((n + 31) / 32);
  const unsigned int threads = 32 * warps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* lv = reinterpret_cast<const int4*>(lvl);
  if (table_bf16)
    encode_bwd_kernel<true><<<blocks, threads, smem, s>>>(
        pos, table, scale, lv, gfeat, dpos, dtable, n, L, hash_mask);
  else
    encode_bwd_kernel<false><<<blocks, threads, smem, s>>>(
        pos, table, scale, lv, gfeat, dpos, dtable, n, L, hash_mask);
  return (int)cudaGetLastError();
}

// K1g. table (rows, W) bf16 (table_bf16=1) or f32, W >= 27 * F; out
// (n, L*F) f32; the rest as blocked_encode_fwd. A vertex's values are
// loaded V = 4, 2 or 1 at a time: the largest V that divides F and W and to
// whose width the table is aligned. The block's output is staged where it
// fits in kGenFwdStage bytes with the positions (L F <= 381), else written
// where it is summed.
int blocked_encode_fwd_f(const float* pos, const void* table, int table_bf16,
                         const float* scale, const int* lvl, float* out, int n, int L,
                         int F, int W, unsigned int hash_mask, void* stream) {
  if (n == 0) return 0;
  if (L < 1 || F < 1 || W < 27 * F) return (int)cudaErrorInvalidValue;
  const uintptr_t at = reinterpret_cast<uintptr_t>(table);
  const int elt = table_bf16 ? 2 : 4;
  int V = 4;
  while (V > 1 && (F % V || W % V || at % (V * elt))) V /= 2;
  const size_t staged_bytes = (96 + (size_t)32 * L * F) * sizeof(float);
  const bool staged = staged_bytes <= kGenFwdStage;
  GenFwdKernel kernel = table_bf16 ? (V == 4   ? &encode_fwd_f_kernel<true, 4>
                                     : V == 2 ? &encode_fwd_f_kernel<true, 2>
                                              : &encode_fwd_f_kernel<true, 1>)
                                   : (V == 4   ? &encode_fwd_f_kernel<false, 4>
                                     : V == 2 ? &encode_fwd_f_kernel<false, 2>
                                              : &encode_fwd_f_kernel<false, 1>);
  const unsigned int blocks = (unsigned int)((n + 31) / 32);
  const unsigned int threads = 32 * (L < kGenFwdWarps ? L : kGenFwdWarps);
  kernel<<<blocks, threads, staged ? staged_bytes : 96 * sizeof(float),
           reinterpret_cast<cudaStream_t>(stream)>>>(pos, table, scale,
                                                     reinterpret_cast<const int4*>(lvl), out, n,
                                                     L, F, W, hash_mask, staged ? 1 : 0);
  return (int)cudaGetLastError();
}

// K2g. gfeat (n, L*F) f32; dpos (n, 3) f32 (written); dtable (rows, W) f32
// (added into: the caller passes zeros). The table's loads take V = 4, 2 or
// 1 values at once: the largest that divides F and W and to whose width
// the table is aligned. The block stages the cotangent where a warp's
// layout with it fits in 227 KB, and takes as many warps as levels (at
// most kGenBwdWarps) as far as 48 KB allows; one warp that needs more opts
// in to it. Returns cudaErrorInvalidValue where even one warp's layout
// without the staged cotangent does not fit (some 600 levels).
int blocked_encode_bwd_f(const float* pos, const void* table, int table_bf16,
                         const float* scale, const int* lvl, const float* gfeat, float* dpos,
                         float* dtable, int n, int L, int F, int W, unsigned int hash_mask,
                         void* stream) {
  if (n == 0) return 0;
  if (L < 1 || F < 1 || W < 27 * F) return (int)cudaErrorInvalidValue;
  const uintptr_t at = reinterpret_cast<uintptr_t>(table);
  const int elt = table_bf16 ? 2 : 4;
  int V = 4;
  while (V > 1 && (F % V || W % V || at % (V * elt))) V /= 2;
  // as many warps as fit in 48 KB (or one, in as much as it needs), then
  // as few as take the same levels a warp
  const int most = L < kGenBwdWarps ? L : kGenBwdWarps;
  bool staged = gen_bwd_words(L, F, 1, true) * 4 <= kSmemOptIn;
  if (gen_bwd_words(L, F, 1, staged) * 4 > kSmemOptIn) return (int)cudaErrorInvalidValue;
  int warps = most;
  while (warps > 1 && gen_bwd_words(L, F, warps, staged) * 4 > 48 * 1024) --warps;
  warps = (L + (L + warps - 1) / warps - 1) / ((L + warps - 1) / warps);
  const size_t smem = gen_bwd_words(L, F, warps, staged) * 4;
  GenBwdKernel kernel = F > kGenChunk ? gen_bwd_kernel<true>(table_bf16, V)
                                      : gen_bwd_kernel<false>(table_bf16, V);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned int blocks = (unsigned int)((n + 31) / 32);
  kernel<<<blocks, 32 * warps, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      pos, table, scale, reinterpret_cast<const int4*>(lvl), gfeat, dpos, dtable, n, L, F, W,
      hash_mask, staged ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
