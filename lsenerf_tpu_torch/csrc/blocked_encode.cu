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
// and scattered atomics, now 8F values and 8F atomics a sample-level. The
// design is the simple one, with no layout tuned to a given F:
// - K1g: one thread a (sample, level), thread t = sample t / L, level
//   t % L, so a warp's F-wide outputs are one contiguous run. Keys and
//   fractions come from K1's level_key (the same keys, bit for bit). It
//   adds the 8 vertices of the cube in slot order, weights (ux * uy) * uz
//   as the plain version forms them: the plain version's 27-term sum less
//   the 19 terms whose weight is exactly 0.
// - K2g: one thread a sample, walking its levels in order, so dpos is one
//   sum a sample in registers, with no atomics and the same bits from call
//   to call. Its table gradient is 8F exact f32 atomics a sample-level
//   (none where the update is 0), adding in no fixed order.

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

constexpr int kGenFwdThreads = 128;  // K1g: threads a block, one a (sample, level)
constexpr int kGenBwdThreads = 64;   // K2g: threads a block, one a sample

// Element e of the table as f32.
template <bool kBF16>
__device__ __forceinline__ float load_value(const void* __restrict__ table, long e) {
  if (kBF16)
    return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(table) + e)
                           << 16);
  return __ldg(reinterpret_cast<const float*>(table) + e);
}

// K1g: thread t takes sample t / L at level t % L; out[t * F + f] is its
// feature f.
template <bool kBF16>
__global__ void __launch_bounds__(kGenFwdThreads)
    encode_fwd_f_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                        const float* __restrict__ scale, const int4* __restrict__ lvl,
                        float* __restrict__ out, int n, int L, int F, int W,
                        uint32_t hash_mask) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)n * L) return;
  const long i = t / L;
  const int l = (int)(t - i * L);
  float w[3];
  int o[3];
  const long row = (long)level_key(pos, i, __ldg(scale + l), __ldg(lvl + l), hash_mask, w, o) * W;
  const float u[3][2] = {{1.0f - w[0], w[0]}, {1.0f - w[1], w[1]}, {1.0f - w[2], w[2]}};
  long e[8];
  float wt[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int a = c >> 2, b = (c >> 1) & 1, z = c & 1;
    e[c] = row + (long)((((o[0] + a) * 3 + o[1] + b) * 3 + o[2] + z) * F);
    wt[c] = __fmul_rn(__fmul_rn(u[0][a], u[1][b]), u[2][z]);
  }
  float* dst = out + t * F;
  for (int f = 0; f < F; ++f) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc = __fadd_rn(acc, __fmul_rn(wt[c], load_value<kBF16>(table, e[c] + f)));
    dst[f] = acc;
  }
}

// K2g: thread i takes sample i at every level, in level order.
template <bool kBF16>
__global__ void __launch_bounds__(kGenBwdThreads)
    encode_bwd_f_kernel(const float* __restrict__ pos, const void* __restrict__ table,
                        const float* __restrict__ scale, const int4* __restrict__ lvl,
                        const float* __restrict__ gfeat, float* __restrict__ dpos,
                        float* __restrict__ dtable, int n, int L, int F, int W,
                        uint32_t hash_mask) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    const float sc = __ldg(scale + l);
    float w[3];
    int o[3];
    const long row = (long)level_key(pos, i, sc, __ldg(lvl + l), hash_mask, w, o) * W;
    const float* g = gfeat + (i * L + l) * F;
    const float u[3][2] = {{1.0f - w[0], w[0]}, {1.0f - w[1], w[1]}, {1.0f - w[2], w[2]}};
    // du[d][s]: d loss / d (weight of slot o + s in dimension d)
    float du[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int a = c >> 2, b = (c >> 1) & 1, z = c & 1;
      const long e = row + (long)((((o[0] + a) * 3 + o[1] + b) * 3 + o[2] + z) * F);
      float gv = 0.0f;  // d loss / d (this vertex's weight)
      for (int f = 0; f < F; ++f)
        gv = __fadd_rn(gv, __fmul_rn(load_value<kBF16>(table, e + f), __ldg(g + f)));
      du[0][a] = __fadd_rn(du[0][a], __fmul_rn(__fmul_rn(gv, u[1][b]), u[2][z]));
      du[1][b] = __fadd_rn(du[1][b], __fmul_rn(__fmul_rn(gv, u[0][a]), u[2][z]));
      du[2][z] = __fadd_rn(du[2][z], __fmul_rn(__fmul_rn(gv, u[0][a]), u[1][b]));
      const float wt = __fmul_rn(__fmul_rn(u[0][a], u[1][b]), u[2][z]);
      for (int f = 0; f < F; ++f) {
        const float upd = __fmul_rn(wt, __ldg(g + f));
        if (upd != 0.0f) atomicAdd(dtable + e + f, upd);
      }
    }
    // the slots o and o + 1 weigh 1 - w and w: d w = du[1] - du[0]
#pragma unroll
    for (int d = 0; d < 3; ++d)
      acc[d] = __fadd_rn(acc[d], __fmul_rn(__fsub_rn(du[d][1], du[d][0]), sc));
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) dpos[i * 3 + d] = acc[d];
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
// (n, L*F) f32; the rest as blocked_encode_fwd.
int blocked_encode_fwd_f(const float* pos, const void* table, int table_bf16,
                         const float* scale, const int* lvl, float* out, int n, int L,
                         int F, int W, unsigned int hash_mask, void* stream) {
  if (n == 0) return 0;
  if (L < 1 || F < 1 || W < 27 * F) return (int)cudaErrorInvalidValue;
  const long threads = (long)n * L;
  const unsigned int blocks = (unsigned int)((threads + kGenFwdThreads - 1) / kGenFwdThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* lv = reinterpret_cast<const int4*>(lvl);
  if (table_bf16)
    encode_fwd_f_kernel<true><<<blocks, kGenFwdThreads, 0, s>>>(pos, table, scale, lv, out, n,
                                                                L, F, W, hash_mask);
  else
    encode_fwd_f_kernel<false><<<blocks, kGenFwdThreads, 0, s>>>(pos, table, scale, lv, out, n,
                                                                 L, F, W, hash_mask);
  return (int)cudaGetLastError();
}

// K2g. gfeat (n, L*F) f32; dpos (n, 3) f32 (written); dtable (rows, W) f32
// (added into: the caller passes zeros).
int blocked_encode_bwd_f(const float* pos, const void* table, int table_bf16,
                         const float* scale, const int* lvl, const float* gfeat, float* dpos,
                         float* dtable, int n, int L, int F, int W, unsigned int hash_mask,
                         void* stream) {
  if (n == 0) return 0;
  if (L < 1 || F < 1 || W < 27 * F) return (int)cudaErrorInvalidValue;
  const unsigned int blocks = (unsigned int)((n + kGenBwdThreads - 1) / kGenBwdThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int4* lv = reinterpret_cast<const int4*>(lvl);
  if (table_bf16)
    encode_bwd_f_kernel<true><<<blocks, kGenBwdThreads, 0, s>>>(
        pos, table, scale, lv, gfeat, dpos, dtable, n, L, F, W, hash_mask);
  else
    encode_bwd_f_kernel<false><<<blocks, kGenBwdThreads, 0, s>>>(
        pos, table, scale, lv, gfeat, dpos, dtable, n, L, F, W, hash_mask);
  return (int)cudaGetLastError();
}

}  // extern "C"
