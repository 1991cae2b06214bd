// The field's MLP head for Hopper (sm_90a): forward (K9a) and backward
// (K9b).
//
// The head is the chain after the hash encode (models/field.py::head; its
// plain version head_plain there): the base MLP (L*F -> 64 -> 16,
// ReLU) on the bf16-rounded features, density = average_init_density *
// exp(h[0]) * selector, the degree-4 spherical harmonics of the direction,
// the colour input [SH (16), geo = h[1:16] (15), the ray's appearance code
// (E)] rounded to bf16, the colour MLP (31 + E -> 64 -> 64 -> 3, ReLU) and
// the sigmoid. The JAX package has no kernel for it (XLA fuses the MLPs);
// the reference runs it as tiny-cuda-nn's fully fused 64-wide networks. In
// the port it was ~200 small torch kernels a step, forward and backward
// (matmuls, casts, activations, the concatenation and autograd's bias
// reductions), each writing and reading an n x 64 f32 intermediate.
//
// K9a head_fwd_kernel computes density (n, 1) and rgb (n, 3); without
// directions it is the density alone (the occupancy update's density_fn);
// where a backward follows it also writes each tile's activations (the two
// base layers' and the two hidden colour layers', 832 bytes a sample).
// K9b head_bwd_kernel reads them back and runs each sample's backward: the
// feature cotangent (bf16-rounded where the plain path rounds it: the
// input of K2/K7b), the direction cotangent, each sample's code cotangent
// and every weight and bias gradient; head_sum_kernel, its second launch,
// sums the blocks' weight-gradient partials and the codes' per-sample
// terms of each ray in a fixed order.
//
// Same function as the plain chain: f32 weights, f32 FMA sums, bf16
// rounding at the two MLP inputs and at their cotangents only (where
// compute_dtype is bfloat16); no tensor-core product (TF32 or bf16 of f32
// weights would be another function). Only the order of the f32 sums
// differs from cuBLAS's.
//
// What bounds it on the card: f32 FMA. A sample is 11,392 multiply-adds
// forward (32x64 + 64x16 + 63x64 + 64x64 + 64x3 at L*F = 32, E = 32), and
// as many again for the input cotangents and for the weight gradients:
// 34,176 a train step, 0.057 ms at 67 TFLOP/s for 56,160 samples (0.019 ms
// forward). The bytes (the features in, density and rgb out, the saved
// activations out and back: ~2 KB a sample) are ~0.035 ms at 3.35 TB/s,
// spread over both kernels. Measured, each product runs at about half the
// FMA rate: a 4 x 4 tile a thread reads 2 bytes of shared memory a FMA,
// twice what the shared memory serves at the FMA rate.
//
// Design:
// - Persistent blocks of 256 threads walk tiles of 64 samples (tile t,
//   t + gridDim.x, ...): each block loads the ~50 KB of f32 weights into
//   shared memory once, and every 64-wide activation of a tile stays in
//   shared memory, feature-major ([row][sample], rows 68 floats apart so
//   that float4 reads of a row's samples and of a weight row's columns are
//   free of bank conflicts). A tile's inputs are loaded into registers a
//   tile ahead (Inputs), so their latency hides under the tile before.
// - K9b reads the forward's activations that K9a saved instead of
//   recomputing them: a third of its products, for 832 bytes a sample
//   written and read (about 17% of K9b's time against ~5% of K9a's).
// - Each layer is a register-tiled product from shared memory: a thread
//   holds 4 samples x 4 outputs, and a step of the sum reads two float4
//   (the forward: 4 samples of one input row, 4 columns of one weight row)
//   for 16 FMAs; the backward's products with the transposed weights read
//   four cotangent rows and four weight rows for 64 FMAs; the weight
//   gradients sum 4 samples of 4 activation rows and 4 cotangent rows (64
//   FMAs) into a thread's own 16 elements. In the two 64-wide colour
//   layers' backward the weight gradient and the cotangent each take half
//   the block with 4 x 8 tiles (12 float4 for 128 FMAs), a quarter less
//   shared-memory traffic a FMA.
// - No atomics, so every output is the same bits at every call: each
//   element of a weight gradient belongs to one thread, which adds the
//   tile's sum into the block's partial in shared memory in tile order;
//   the block writes its partial once, and head_sum_kernel adds the
//   blocks' partials in block order (a replayed graph equals its eager
//   steps bit for bit). The codes' cotangents of a ray's k samples are
//   summed there too, in sample order.
// - What varies between paths is read from the arguments: compute_dtype
//   (bf16), the codes (null: none; a stride of 0: one code for every ray),
//   k = n / m samples a ray, the directions (null: density only), whether
//   a backward follows (saved) and which gradients are wanted (null
//   outputs are skipped: a frozen field asks for no weight gradient). The
//   presets' widths (L*F = 32, codes of 32 or none) take kernels compiled
//   for them; any other width up to 64 the ones that read it.
// - The C entries launch on the caller's stream, allocate nothing and
//   return cudaGetLastError(); head_smem gives the shared memory a launch
//   needs, which the wrapper holds against the card's limit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// lsenerf_tpu_torch/ops/field_head.py (_HeadArgs) mirrors this layout.
struct HeadArgs {
  const float* feats;        // (n, D) the encode's features
  const uint8_t* sel;        // (n,) the in-bounds selector
  const float* dirs;         // (n, 3), or null: the density alone
  const float* codes;        // rows of E floats code_stride apart, one a ray; or null
  const float* w0;           // base MLP: (D, 64), (64,), (64, 16), (16,)
  const float* b0;
  const float* w1;
  const float* b1;
  const float* v0;           // colour MLP: (CIN, 64), (64,), (64, 64), (64,), (64, 3), (3,)
  const float* c0;
  const float* v1;
  const float* c1;
  const float* v2;
  const float* c2;
  float* density;            // K9a: (n, 1)
  float* rgb;                // K9a: (n, 3), or null; K9b reads it
  float* saved;              // K9a writes, K9b reads: each tile's activations (kSaved rows
                             // of 64), or null (K9a: no backward follows)
  const float* g_density;    // K9b: the cotangents, (n, 1) and (n, 3); null reads zeros
  const float* g_rgb;
  float* g_feats;            // K9b outputs, each null where not wanted: (n, D)
  float* g_dirs;             // (n, 3)
  float* g_codes;            // (m, E)
  float* code_terms;         // (n, E) scratch where g_codes and k > 1
  float* partials;           // (blocks, P) scratch where g_params
  float* g_params;           // (P,): w0, b0, w1, b1, v0, c0, v1, c1, v2, c2 in turn
  float aid;                 // average_init_density
  int n, m, k, D, E;
  int code_stride;           // floats from one ray's code to the next (0: one code)
  int bf16;                  // round the MLP inputs and their cotangents to bf16
  int blocks;                // K9b's grid (the partials' rows)
};

}  // extern "C"

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;     // samples a tile
constexpr int kLD = 68;    // floats between the rows of a tile's activations
constexpr int kLW = 68;    // ... of a 64-wide weight
constexpr int kLW1 = 20;   // ... of the base MLP's 16-wide output layer
constexpr int kLW2 = 4;    // ... of the colour MLP's 3-wide output layer
constexpr int kSH = 16;    // degree-4 spherical harmonics
constexpr int kGeo = 15;
constexpr int kSaved = 64 + 16 + 64 + 64;  // a tile's saved rows: H1, HS, G1, G2

__host__ __device__ inline int color_in(int E) { return kSH + kGeo + E; }

// The flat gradient's offsets (g_params and each block's partial).
struct Params {
  int w0, b0, w1, b1, v0, c0, v1, c1, v2, c2, total;
};

__host__ __device__ inline Params params_of(int D, int CIN) {
  Params p;
  int o = 0;
  p.w0 = o; o += D * 64;
  p.b0 = o; o += 64;
  p.w1 = o; o += 64 * 16;
  p.b1 = o; o += 16;
  p.v0 = o; o += CIN * 64;
  p.c0 = o; o += 64;
  p.v1 = o; o += 64 * 64;
  p.c1 = o; o += 64;
  p.v2 = o; o += 64 * 3;
  p.c2 = o; o += 3;
  p.total = o;
  return p;
}

// Shared memory in floats, every offset a multiple of 4 (16 bytes).
// Forward: A holds the features, then the colour input, then the second
// colour layer; B the first base layer, then the first colour layer.
// Backward: a buffer each, the cotangents written over their activations
// (dG2 over G2, dG1 over G1, dH over HS, dH1 over H1), dCB and dX into OUT.
struct Smem {
  int w0, b0, w1, b1, v0, c0, v1, c1, v2, c2;
  int xb, h1, hs, cb, g1, g2, dz, out, ss, sp, acc, total;
};

__host__ __device__ inline int up4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

__host__ __device__ inline Smem smem_of(int D, int CIN, bool backward) {
  Smem s;
  int o = 0;
  s.w0 = o; o += up16(D) * kLW;
  s.b0 = o; o += 64;
  s.w1 = o; o += 64 * kLW1;
  s.b1 = o; o += 16;
  s.v0 = o; o += up16(CIN) * kLW;
  s.c0 = o; o += 64;
  s.v1 = o; o += 64 * kLW;
  s.c1 = o; o += 64;
  s.v2 = o; o += 64 * kLW2;
  s.c2 = o; o += 4;
  const int wide = up16(D > CIN ? D : CIN);
  if (!backward) {
    s.xb = s.cb = s.g2 = o; o += (wide > 64 ? wide : 64) * kLD;   // A
    s.h1 = s.g1 = o; o += 64 * kLD;                               // B
    s.hs = o; o += 16 * kLD;
    s.ss = o; o += 11 * kT;
    s.sp = o; o += 4 * 4 * kT;
    s.dz = s.out = s.acc = 0;
  } else {
    s.xb = o; o += up16(D) * kLD;
    s.h1 = o; o += 64 * kLD;
    s.hs = o; o += 16 * kLD;
    s.cb = o; o += up16(CIN) * kLD;
    s.g1 = o; o += 64 * kLD;
    s.g2 = o; o += 64 * kLD;
    s.dz = o; o += 4 * kLD;
    s.out = o; o += wide * kLD;
    s.sp = 0;
    s.ss = o; o += 11 * kT;
    s.acc = o; o += up4(params_of(D, CIN).total);
  }
  s.total = o;
  return s;
}

// per-sample values in SS: directions [3][kT], selector, and (backward)
// the density's and rgb's cotangents
constexpr int kSsDirs = 0, kSsSel = 3 * kT, kSsGd = 4 * kT, kSsGrgb = 5 * kT, kSsRgb = 8 * kT;

__device__ __forceinline__ float bf16_round(float x) {
  // round to nearest even, as torch's float -> bfloat16 cast
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// A thread's place in the 16 x 16 grid of 4-wide groups a tile's products
// split into: across() runs over 8 consecutive lanes of a warp, down() over
// its 4 groups of 8, so that what a warp reads of one row (8 float4, 128
// bytes) or of 4 rows 68 floats apart (one float4 each) is one wavefront.
__device__ __forceinline__ int across() { return ((threadIdx.x >> 5) & 1) * 8 + (threadIdx.x & 7); }
__device__ __forceinline__ int down() { return (threadIdx.x >> 6) * 4 + ((threadIdx.x >> 3) & 3); }

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// A (rows, cols) row-major weight into shared memory, rows ld floats apart,
// the pad columns and the rows past `rows` up to a multiple of 16 zero;
// float4 loads where the columns come in fours and the weight is aligned,
// several in flight a thread.
__device__ void load_weight(float* s, const float* g, int rows, int cols, int ld) {
  if ((cols & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0) {
    const int q = cols >> 2, n = rows * q;
#pragma unroll 4
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / q, c = (i - r * q) * 4;
      *reinterpret_cast<float4*>(s + r * ld + c) = ld4(g + i * 4);
    }
    for (int i = threadIdx.x; i < up16(rows) * ld; i += kThreads) {
      const int r = i / ld, c = i - r * ld;
      if (c >= cols || r >= rows) s[i] = 0.f;
    }
    return;
  }
  for (int i = threadIdx.x; i < up16(rows) * ld; i += kThreads) {
    const int r = i / ld, c = i - r * ld;
    s[i] = c < cols && r < rows ? g[r * cols + c] : 0.f;
  }
}

__device__ void load_row(float* s, const float* g, int cols, int ld) {
  for (int c = threadIdx.x; c < ld; c += kThreads) s[c] = c < cols ? g[c] : 0.f;
}

__device__ void load_weights(float* sm, const Smem& L, const HeadArgs& a, int D, int CIN,
                             bool color) {
  load_weight(sm + L.w0, a.w0, D, 64, kLW);
  load_row(sm + L.b0, a.b0, 64, 64);
  load_weight(sm + L.w1, a.w1, 64, 16, kLW1);
  load_row(sm + L.b1, a.b1, 16, 16);
  if (!color) return;
  load_weight(sm + L.v0, a.v0, CIN, 64, kLW);
  load_row(sm + L.c0, a.c0, 64, 64);
  load_weight(sm + L.v1, a.v1, 64, 64, kLW);
  load_row(sm + L.c1, a.c1, 64, 64);
  load_weight(sm + L.v2, a.v2, 64, 3, kLW2);
  load_row(sm + L.c2, a.c2, 3, 4);
}

// A tile's inputs as a thread holds them from their loads, issued a tile
// ahead so that they land while the tile before computes, to their stores
// into shared memory: element tid + 256 r of the tile's features and of
// its codes, and thread tid's element of the directions, the rgb
// cotangent (tid < 192), the selector and the density cotangent (tid <
// 64). DT and ET are D and E where known at compile time (0 and -1: read
// from the arguments, D and E up to 64).
template <int DT, int ET>
struct Inputs {
  static constexpr int RF = DT ? (kT * DT + kThreads - 1) / kThreads : 16;
  static constexpr int RC = ET >= 0 ? (kT * ET + kThreads - 1) / kThreads : 16;
  float f[RF];
  float c[RC > 0 ? RC : 1];
  float dir, grgb, y, sel, gd;

  __device__ __forceinline__ void load(const HeadArgs& a, int D, int base, int nt, bool bwd) {
    const long long at = (long long)base * D;
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      const int i = threadIdx.x + r * kThreads;
      f[r] = i < nt * D ? a.feats[at + i] : 0.f;
    }
    const int t = threadIdx.x;
    const bool in3 = t < 3 * nt;
    dir = a.dirs && in3 ? a.dirs[(long long)base * 3 + t] : 0.f;
    grgb = bwd && a.g_rgb && in3 ? a.g_rgb[(long long)base * 3 + t] : 0.f;
    y = bwd && in3 ? a.rgb[(long long)base * 3 + t] : 0.f;
    sel = t < nt && a.sel[base + t] ? 1.f : 0.f;
    gd = bwd && a.g_density && t < nt ? a.g_density[base + t] : 0.f;
  }

  __device__ __forceinline__ void load_codes(const HeadArgs& a, int E, int base, int nt) {
    if (!a.codes) return;
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int i = threadIdx.x + r * kThreads;
      const int s = i / E, e = i - s * E;
      c[r] = i < kT * E && s < nt
                 ? a.codes[(long long)((base + s) / a.k) * a.code_stride + e] : 0.f;
    }
  }

  // the features (rounded where bf16) into xb, the rest into ss
  __device__ __forceinline__ void store(float* xb, float* ss, int D, bool bf16) const {
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < kT * D) {
        const int s = i / D, d = i - s * D;
        xb[d * kLD + s] = bf16 ? bf16_round(f[r]) : f[r];
      }
    }
    const int t = threadIdx.x;
    if (t < 3 * kT) {
      const int s = t / 3, j = t - s * 3;
      ss[kSsDirs + j * kT + s] = dir;
      ss[kSsGrgb + j * kT + s] = grgb;
      ss[kSsRgb + j * kT + s] = y;
    }
    if (t < kT) {
      ss[kSsSel + t] = sel;
      ss[kSsGd + t] = gd;
    }
  }

  // the codes (rounded where bf16) into the colour input's rows 31 on
  __device__ __forceinline__ void store_codes(float* cb, int E, bool bf16) const {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < kT * E) {
        const int s = i / E, e = i - s * E;
        cb[(kSH + kGeo + e) * kLD + s] = bf16 ? bf16_round(c[r]) : c[r];
      }
    }
  }
};

// out[c][s] = act(sum_k in[k][s] * w[k][c] + b[c]) for 64 outputs c: a
// thread's 4 samples x 4 outputs, k in order (KC: K known at compile time).
template <bool Relu, int KC = 0>
__device__ __forceinline__ void layer64(const float* in, int K, const float* w, const float* b, float* out) {
  if (KC) K = KC;
  const int c0 = down() * 4, s0 = across() * 4;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < K; ++k) {
    const float4 x = ld4(in + k * kLD + s0);
    const float4 wv = ld4(w + k * kLW + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(comp(x, i), comp(wv, j), acc[i][j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = acc[i][j] + b[c0 + j];
      if (Relu) v[i] = fmaxf(v[i], 0.f);
    }
    st4(out + (c0 + j) * kLD + s0, v[0], v[1], v[2], v[3]);
  }
}

// hs[c][s] = sum_k h1[k][s] * w1[k][c] + b1[c], the base MLP's 16 outputs:
// a thread's sample x 4 outputs.
__device__ void layer16(const float* in, const float* w, const float* b, float* out) {
  const int c0 = (threadIdx.x & 3) * 4, s = threadIdx.x >> 2;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int k = 0; k < 64; ++k) {
    const float x = in[k * kLD + s];
    const float4 wv = ld4(w + k * kLW1 + c0);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(x, comp(wv, j), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[(c0 + j) * kLD + s] = acc[j] + b[c0 + j];
}

// The colour MLP's 3 outputs: four threads a sample each sum 16 rows into
// sp[q][j][s]; rgb_logit adds the four in order and the bias.
__device__ void layer3_partials(const float* in, const float* w, float* sp) {
  const int s = threadIdx.x & 63, q = threadIdx.x >> 6;
  float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = q * 16; k < q * 16 + 16; ++k) {
    const float x = in[k * kLD + s];
    const float4 wv = ld4(w + k * kLW2);
    acc[0] = fmaf(x, wv.x, acc[0]);
    acc[1] = fmaf(x, wv.y, acc[1]);
    acc[2] = fmaf(x, wv.z, acc[2]);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) sp[(q * 4 + j) * kT + s] = acc[j];
}

__device__ __forceinline__ float rgb_of(const float* sp, const float* c2, int j, int s) {
  const float z = ((sp[j * kT + s] + sp[(4 + j) * kT + s]) + sp[(8 + j) * kT + s]) +
                  sp[(12 + j) * kT + s] + c2[j];
  return 1.f / (1.f + expf(-z));  // torch's sigmoid
}

// Real spherical harmonics of degree 4 in the plain version's order of f32
// operations (ops/sh.py: each op rounded, no FMA contraction).
__device__ void sh_encode(float x, float y, float z, float* o) {
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  const float xy = __fmul_rn(x, y), yz = __fmul_rn(y, z), xz = __fmul_rn(x, z);
  const float zz5 = __fsub_rn(1.f, __fmul_rn(5.f, zz));
  o[0] = 0.28209479177387814f;
  o[1] = __fmul_rn(-0.48860251190291987f, y);
  o[2] = __fmul_rn(0.48860251190291987f, z);
  o[3] = __fmul_rn(-0.48860251190291987f, x);
  o[4] = __fmul_rn(1.0925484305920792f, xy);
  o[5] = __fmul_rn(-1.0925484305920792f, yz);
  o[6] = __fsub_rn(__fmul_rn(0.94617469575755997f, zz), 0.31539156525251999f);
  o[7] = __fmul_rn(-1.0925484305920792f, xz);
  o[8] = __fmul_rn(0.54627421529603959f, __fsub_rn(xx, yy));
  o[9] = __fmul_rn(__fmul_rn(0.59004358992664352f, y), __fadd_rn(__fmul_rn(-3.f, xx), yy));
  o[10] = __fmul_rn(__fmul_rn(2.8906114426405538f, xy), z);
  o[11] = __fmul_rn(__fmul_rn(0.45704579946446572f, y), zz5);
  o[12] = __fmul_rn(__fmul_rn(0.3731763325901154f, z), __fsub_rn(__fmul_rn(5.f, zz), 3.f));
  o[13] = __fmul_rn(__fmul_rn(0.45704579946446572f, x), zz5);
  o[14] = __fmul_rn(__fmul_rn(1.4453057213202769f, z), __fsub_rn(xx, yy));
  o[15] = __fmul_rn(__fmul_rn(0.59004358992664352f, x), __fadd_rn(-xx, __fmul_rn(3.f, yy)));
}

// The direction's cotangent from the SH components' cotangents g.
__device__ void sh_backward(float x, float y, float z, const float* g, float* d) {
  const float C1 = 0.48860251190291987f, C2 = 1.0925484305920792f, C3 = 0.94617469575755997f;
  const float C5 = 0.54627421529603959f, C6 = 0.59004358992664352f, C7 = 2.8906114426405538f;
  const float C8 = 0.45704579946446572f, C9 = 0.3731763325901154f, C10 = 1.4453057213202769f;
  const float xx = x * x, yy = y * y, zz = z * z;
  float dx = -C1 * g[3], dy = -C1 * g[1], dz = C1 * g[2];
  dx += C2 * (y * g[4] - z * g[7]);
  dy += C2 * (x * g[4] - z * g[5]);
  dz += C2 * (-y * g[5] - x * g[7]) + 2.f * C3 * z * g[6];
  dx += 2.f * C5 * x * g[8];
  dy += -2.f * C5 * y * g[8];
  dx += -6.f * C6 * x * y * g[9] + C6 * (3.f * yy - 3.f * xx) * g[15];
  dy += C6 * (3.f * yy - 3.f * xx) * g[9] + 6.f * C6 * x * y * g[15];
  dx += C7 * y * z * g[10];
  dy += C7 * x * z * g[10];
  dz += C7 * x * y * g[10];
  dy += C8 * (1.f - 5.f * zz) * g[11];
  dz += -10.f * C8 * z * (y * g[11] + x * g[13]);
  dx += C8 * (1.f - 5.f * zz) * g[13];
  dz += C9 * (15.f * zz - 3.f) * g[12];
  dx += 2.f * C10 * x * z * g[14];
  dy += -2.f * C10 * y * z * g[14];
  dz += C10 * (xx - yy) * g[14];
  d[0] = dx;
  d[1] = dy;
  d[2] = dz;
}

// A shared-memory buffer's `rows` rows (kLD floats apart) into rows [r0,
// r0 + rows) of a tile's saved activations (kT floats a row), a float4 a
// thread at a time.
__device__ __forceinline__ void save_rows(float* g, const float* buf, int r0, int rows) {
#pragma unroll
  for (int i = threadIdx.x; i < rows * 16; i += kThreads) {
    const int r = i >> 4, q = (i & 15) * 4;
    *reinterpret_cast<float4*>(g + (r0 + r) * kT + q) = ld4(buf + r * kLD + q);
  }
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async): issued now, landed after copy_wait.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  *reinterpret_cast<float4*>(dst) = ld4(src);
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most `pending` of this thread's committed copy groups are
// in flight
template <int pending>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
#endif
}

// Rows [r0, r0 + rows) of a tile's saved activations (K9a's save_rows) into
// a shared-memory buffer, as cp.async copies of 16 bytes.
__device__ __forceinline__ void copy_saved(const float* g, float* buf, int r0, int rows) {
#pragma unroll
  for (int i = threadIdx.x; i < rows * 16; i += kThreads) {
    const int r = i >> 4, q = (i & 15) * 4;
    copy16(buf + r * kLD + q, g + (r0 + r) * kT + q);
  }
}

// The colour input's SH and geo rows, rounded where bf16, into cb (the
// codes' rows: Inputs::store_codes).
__device__ void color_input(const HeadArgs& a, float* sm, const Smem& L) {
  float* cb = sm + L.cb;
  const float* hs = sm + L.hs;
  const float* ss = sm + L.ss;
  const bool r = a.bf16;
  if (threadIdx.x < kT) {
    const int s = threadIdx.x;
    float o[kSH];
    sh_encode(ss[kSsDirs + s], ss[kSsDirs + kT + s], ss[kSsDirs + 2 * kT + s], o);
#pragma unroll
    for (int i = 0; i < kSH; ++i) cb[i * kLD + s] = r ? bf16_round(o[i]) : o[i];
  } else {
    for (int i = threadIdx.x - kT; i < kGeo * kT; i += kThreads - kT) {
      const int g = i / kT, s = i - g * kT;
      const float v = hs[(1 + g) * kLD + s];
      cb[(kSH + g) * kLD + s] = r ? bf16_round(v) : v;
    }
  }
}

// r[s][i] = sum_j dy[j][s] * w[c_i][j] (w row-major, rows ldw floats apart)
// for a thread's 4 samples and its outputs c_i = cbase + (tid & 15) + 16 i
// below C: the products with the transposed weights, j in order.
__device__ __forceinline__ void transposed(const float* dy, int J, const float* w, int ldw, int C,
                                           int cbase, float r[4][4]) {
  const int cg = down(), s0 = across() * 4;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) r[s][i] = 0.f;
  for (int j = 0; j < J; j += 4) {
    float4 x[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) x[jj] = ld4(dy + (j + jj) * kLD + s0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (cbase + 16 * i >= C) break;  // uniform; w's rows are zero up to a multiple of 16
      const float4 wv = ld4(w + (cbase + cg + 16 * i) * ldw + j);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v = r[s][i];
        v = fmaf(comp(x[0], s), wv.x, v);
        v = fmaf(comp(x[1], s), wv.y, v);
        v = fmaf(comp(x[2], s), wv.z, v);
        v = fmaf(comp(x[3], s), wv.w, v);
        r[s][i] = v;
      }
    }
  }
}

// buf[c_i][s] = r[s][i] where buf[c_i][s] > 0 (the ReLU's backward over
// its output), else 0: 64 outputs, written over the activations.
__device__ void store_masked(float* buf, const float r[4][4]) {
  const int cg = down(), s0 = across() * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* p = buf + (cg + 16 * i) * kLD + s0;
    const float4 h = ld4(p);
    st4(p, h.x > 0.f ? r[0][i] : 0.f, h.y > 0.f ? r[1][i] : 0.f, h.z > 0.f ? r[2][i] : 0.f,
        h.w > 0.f ? r[3][i] : 0.f);
  }
}

// out[c_i][s] = r[s][i] (rounded where bf16) for c_i below C.
__device__ void store_rows(float* out, const float r[4][4], int C, int cbase, bool round) {
  const int cg = down(), s0 = across() * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = cbase + cg + 16 * i;
    if (c >= C) continue;
    float v[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) v[s] = round ? bf16_round(r[s][i]) : r[s][i];
    st4(out + c * kLD + s0, v[0], v[1], v[2], v[3]);
  }
}

// acc[k][c] += sum_s x[k][s] * dy[c][s] over the tile's samples, in order,
// for the thread's rows k = kbase + across() + 16 a below K (x's rows are
// zero up to a multiple of 16) and columns c = down() + 16 b below C: one
// weight's gradient.
template <int C>
__device__ __forceinline__ void weight_grad(const float* x, int K, const float* dy, float* acc) {
  constexpr int NB = (C + 15) / 16;
  const int kg = across(), cg = down();
  for (int kbase = 0; kbase < K; kbase += 64) {
    float r[4][NB];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < NB; ++b) r[i][b] = 0.f;
#pragma unroll 2
    for (int s = 0; s < kT; s += 4) {
      float4 d[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int c = cg + 16 * b;
        d[b] = c < C ? ld4(dy + c * kLD + s) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kbase + 16 * i >= K) break;  // uniform
        const float4 v = ld4(x + (kbase + kg + 16 * i) * kLD + s);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          float t = r[i][b];
          t = fmaf(v.x, d[b].x, t);
          t = fmaf(v.y, d[b].y, t);
          t = fmaf(v.z, d[b].z, t);
          t = fmaf(v.w, d[b].w, t);
          r[i][b] = t;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kbase + kg + 16 * i;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const int c = cg + 16 * b;
        if (k < K && c < C) acc[k * C + c] += r[i][b];
      }
    }
  }
}

// The two 64-wide colour layers' backward phases split the block: warps 0-3
// take the weight gradient (weight_grad8), warps 4-7 the cotangent through
// the transposed weight (transposed8), each a 4 x 8 tile a thread, so a
// step of the sum reads 12 float4 for 128 FMAs where the 4 x 4 tiles read
// 8 for 64. In a half, across() runs over 8 lanes and 2 warps (16 groups)
// and down8() over a warp's 4 groups of 8 lanes and 2 warps (8 groups).
__device__ __forceinline__ int down8() { return ((threadIdx.x >> 6) & 1) * 4 + ((threadIdx.x >> 3) & 3); }

// weight_grad with C = 64 on warps 0-3: rows k = kbase + across() + 16 a
// below K (zero up to a multiple of 16), columns c = down8() + 8 b.
__device__ __forceinline__ void weight_grad8(const float* x, int K, const float* dy, float* acc) {
  const int kg = across(), cg = down8();
  for (int kbase = 0; kbase < K; kbase += 64) {
    float r[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 8; ++b) r[i][b] = 0.f;
    for (int s = 0; s < kT; s += 4) {
      float4 d[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) d[b] = ld4(dy + (cg + 8 * b) * kLD + s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (kbase + 16 * i >= K) break;  // uniform
        const float4 v = ld4(x + (kbase + kg + 16 * i) * kLD + s);
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          float t = r[i][b];
          t = fmaf(v.x, d[b].x, t);
          t = fmaf(v.y, d[b].y, t);
          t = fmaf(v.z, d[b].z, t);
          t = fmaf(v.w, d[b].w, t);
          r[i][b] = t;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kbase + kg + 16 * i;
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (k < K) acc[k * 64 + cg + 8 * b] += r[i][b];
    }
  }
}

// transposed with J = 64 on warps 4-7: samples across() * 4, outputs
// c = cbase + down8() + 8 i below C (w's rows zero up to a multiple of 16).
__device__ __forceinline__ void transposed8(const float* dy, const float* w, int C, int cbase,
                                            float r[4][8]) {
  const int cg = down8(), s0 = across() * 4;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 8; ++i) r[s][i] = 0.f;
  for (int j = 0; j < 64; j += 4) {
    float4 x[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) x[jj] = ld4(dy + (j + jj) * kLD + s0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (cbase + 8 * i >= up16(C)) break;  // uniform
      const float4 wv = ld4(w + (cbase + cg + 8 * i) * kLW + j);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float v = r[s][i];
        v = fmaf(comp(x[0], s), wv.x, v);
        v = fmaf(comp(x[1], s), wv.y, v);
        v = fmaf(comp(x[2], s), wv.z, v);
        v = fmaf(comp(x[3], s), wv.w, v);
        r[s][i] = v;
      }
    }
  }
}

// transposed8's outputs: masked by the ReLU over buf (written over it), or
// rounded where bf16 into out's rows below C.
__device__ __forceinline__ void store8(float* buf, const float r[4][8], bool mask, int C,
                                       int cbase, bool round) {
  const int cg = down8(), s0 = across() * 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = cbase + cg + 8 * i;
    if (c >= C) continue;
    float* p = buf + c * kLD + s0;
    float v[4];
    if (mask) {
      const float4 h = ld4(p);
      v[0] = h.x > 0.f ? r[0][i] : 0.f;
      v[1] = h.y > 0.f ? r[1][i] : 0.f;
      v[2] = h.z > 0.f ? r[2][i] : 0.f;
      v[3] = h.w > 0.f ? r[3][i] : 0.f;
    } else {
#pragma unroll
      for (int s = 0; s < 4; ++s) v[s] = round ? bf16_round(r[s][i]) : r[s][i];
    }
    st4(p, v[0], v[1], v[2], v[3]);
  }
}

// One bias gradient element: the sum over the tile's samples of a
// cotangent row, four chains of 16 added in order.
__device__ __forceinline__ float row_sum(const float* row) {
  float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int s = 0; s < kT; s += 4) {
    const float4 v = ld4(row + s);
    t.x += v.x;
    t.y += v.y;
    t.z += v.z;
    t.w += v.w;
  }
  return ((t.x + t.y) + t.z) + t.w;
}

template <int DT, int ET>
__global__ void __launch_bounds__(kThreads, 2) head_fwd_kernel(const __grid_constant__ HeadArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = DT ? DT : a.D, E = ET >= 0 ? ET : (a.codes ? a.E : 0), CIN = color_in(E);
  const bool color = a.rgb != nullptr, rnd = a.bf16 != 0;
  const Smem L = smem_of(D, CIN, false);
  load_weights(sm, L, a, D, CIN, color);
  const int tiles = (a.n + kT - 1) / kT;
  Inputs<DT, ET> in;
  int t = blockIdx.x;
  if (t < tiles) {
    in.load(a, D, t * kT, min(kT, a.n - t * kT), false);
    if (color) in.load_codes(a, E, t * kT, min(kT, a.n - t * kT));
  }
  for (; t < tiles; t += gridDim.x) {
    const int base = t * kT, nt = min(kT, a.n - base);
    const int next = t + gridDim.x, nbase = next * kT, nnt = min(kT, a.n - nbase);
    __syncthreads();
    in.store(sm + L.xb, sm + L.ss, D, rnd);
    if (next < tiles) in.load(a, D, nbase, nnt, false);
    __syncthreads();
    float* saved = a.saved ? a.saved + (long long)t * kSaved * kT : nullptr;
    layer64<true>(sm + L.xb, D, sm + L.w0, sm + L.b0, sm + L.h1);
    __syncthreads();
    layer16(sm + L.h1, sm + L.w1, sm + L.b1, sm + L.hs);
    if (saved) save_rows(saved, sm + L.h1, 0, 64);
    __syncthreads();
    if ((int)threadIdx.x < nt) {
      const int s = threadIdx.x;
      const float d = __fmul_rn(a.aid, expf(sm[L.hs + s]));
      a.density[base + s] = __fmul_rn(d, sm[L.ss + kSsSel + s]);
    }
    if (!color) continue;
    color_input(a, sm, L);
    in.store_codes(sm + L.cb, E, rnd);
    if (next < tiles) in.load_codes(a, E, nbase, nnt);
    if (saved) save_rows(saved, sm + L.hs, 64, 16);
    __syncthreads();
    layer64<true>(sm + L.cb, CIN, sm + L.v0, sm + L.c0, sm + L.g1);
    __syncthreads();
    layer64<true, 64>(sm + L.g1, 64, sm + L.v1, sm + L.c1, sm + L.g2);
    if (saved) save_rows(saved, sm + L.g1, 80, 64);
    __syncthreads();
    layer3_partials(sm + L.g2, sm + L.v2, sm + L.sp);
    if (saved) save_rows(saved, sm + L.g2, 144, 64);
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * kT; i += kThreads) {
      const int s = i / 3, j = i - s * 3;
      if (s < nt) a.rgb[(long long)(base + s) * 3 + j] = rgb_of(sm + L.sp, sm + L.c2, j, s);
    }
  }
}

template <int DT, int ET>
__global__ void __launch_bounds__(kThreads, 1) head_bwd_kernel(const __grid_constant__ HeadArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int D = DT ? DT : a.D, E = ET >= 0 ? ET : (a.codes ? a.E : 0), CIN = color_in(E);
  const Smem L = smem_of(D, CIN, true);
  const Params P = params_of(D, CIN);
  const bool wgrad = a.g_params != nullptr;
  const bool rnd = a.bf16 != 0;
  float* acc = sm + L.acc;
  float* ss = sm + L.ss;
  load_weights(sm, L, a, D, CIN, true);
  if (wgrad)
    for (int i = threadIdx.x; i < P.total; i += kThreads) acc[i] = 0.f;
  for (int i = threadIdx.x; i < 4 * kLD; i += kThreads) sm[L.dz + i] = 0.f;
  // the pad rows the weight gradients read: zero, never written
  for (int i = D * kLD + threadIdx.x; i < up16(D) * kLD; i += kThreads) sm[L.xb + i] = 0.f;
  for (int i = CIN * kLD + threadIdx.x; i < up16(CIN) * kLD; i += kThreads) sm[L.cb + i] = 0.f;
  const int tiles = (a.n + kT - 1) / kT;
  Inputs<DT, ET> in;
  int t = blockIdx.x;
  if (t < tiles) {
    in.load(a, D, t * kT, min(kT, a.n - t * kT), true);
    in.load_codes(a, E, t * kT, min(kT, a.n - t * kT));
  }
  for (; t < tiles; t += gridDim.x) {
    const int base = t * kT, nt = min(kT, a.n - base);
    const int next = t + gridDim.x, nbase = next * kT, nnt = min(kT, a.n - nbase);
    __syncthreads();
    // the forward's activations, saved by K9a, in two groups of copies: HS
    // and G2, needed first, then G1 and H1, which land while the colour
    // input, dZ and the last colour layer's products run; the tile's inputs
    const float* saved = a.saved + (long long)t * kSaved * kT;
    copy_saved(saved, sm + L.hs, 64, 16);
    copy_saved(saved, sm + L.g2, 144, 64);
    copy_commit();
    copy_saved(saved, sm + L.g1, 80, 64);
    copy_saved(saved, sm + L.h1, 0, 64);
    copy_commit();
    in.store(sm + L.xb, ss, D, rnd);
    if (next < tiles) in.load(a, D, nbase, nnt, true);
    copy_wait<1>();
    __syncthreads();
    color_input(a, sm, L);
    in.store_codes(sm + L.cb, E, rnd);
    if (next < tiles) in.load_codes(a, E, nbase, nnt);
    // the sigmoid's and the density's backward: dZ, and dH's row 0 (the
    // colour input read dH's other rows)
    if (threadIdx.x < 3 * kT) {
      const int j = threadIdx.x >> 6, s = threadIdx.x & 63;
      const float y = ss[kSsRgb + j * kT + s];
      const float g = ss[kSsGrgb + j * kT + s];
      sm[L.dz + j * kLD + s] = __fmul_rn(__fmul_rn(g, __fsub_rn(1.f, y)), y);
    } else {
      const int s = threadIdx.x - 3 * kT;
      const float h0 = sm[L.hs + s];
      const float g = __fmul_rn(__fmul_rn(ss[kSsGd + s], ss[kSsSel + s]), a.aid);
      sm[L.hs + s] = __fmul_rn(g, expf(fminf(fmaxf(h0, -15.f), 15.f)));
    }
    __syncthreads();
    float r[4][4];
    // colour layer 3: dV2, then dG2 over G2
    if (wgrad) weight_grad<3>(sm + L.g2, 64, sm + L.dz, acc + P.v2);
    transposed(sm + L.dz, 4, sm + L.v2, kLW2, 64, 0, r);
    __syncthreads();
    store_masked(sm + L.g2, r);
    copy_wait<0>();
    __syncthreads();
    // colour layer 2: dV1 (warps 0-3), then dG1 over G1 (warps 4-7)
    float r8[4][8];
    const bool half = threadIdx.x < kThreads / 2;
    if (half) {
      if (wgrad) weight_grad8(sm + L.g1, 64, sm + L.g2, acc + P.v1);
    } else {
      transposed8(sm + L.g2, sm + L.v1, 64, 0, r8);
    }
    __syncthreads();
    if (!half) store8(sm + L.g1, r8, true, 64, 0, false);
    __syncthreads();
    // colour layer 1: dV0 (warps 0-3), then the colour input's cotangent
    // into OUT (warps 4-7)
    if (half) {
      if (wgrad) weight_grad8(sm + L.cb, CIN, sm + L.g1, acc + P.v0);
    } else {
      for (int cbase = 0; cbase < CIN; cbase += 64) {
        transposed8(sm + L.g1, sm + L.v0, CIN, cbase, r8);
        store8(sm + L.out, r8, false, CIN, cbase, rnd);
      }
    }
    __syncthreads();
    // its pieces: geo's into dH's rows 1-15, the directions', the codes'
    const float* out = sm + L.out;
    for (int i = threadIdx.x; i < kGeo * kT; i += kThreads) {
      const int g = i / kT, s = i - g * kT;
      sm[L.hs + (1 + g) * kLD + s] = out[(kSH + g) * kLD + s];
    }
    if (a.g_dirs && (int)threadIdx.x < nt) {
      const int s = threadIdx.x;
      float g[kSH], d[3];
#pragma unroll
      for (int i = 0; i < kSH; ++i) g[i] = out[i * kLD + s];
      sh_backward(ss[kSsDirs + s], ss[kSsDirs + kT + s], ss[kSsDirs + 2 * kT + s], g, d);
#pragma unroll
      for (int j = 0; j < 3; ++j) a.g_dirs[(long long)(base + s) * 3 + j] = d[j];
    }
    if (a.g_codes) {
      float* dst = a.k > 1 ? a.code_terms : a.g_codes;
      for (int i = threadIdx.x; i < nt * E; i += kThreads) {
        const int s = i / E, e = i - s * E;
        dst[(long long)(base + s) * E + e] = out[(kSH + kGeo + e) * kLD + s];
      }
    }
    __syncthreads();
    // base layer 2: dW1, then dH1 over H1
    if (wgrad) weight_grad<16>(sm + L.h1, 64, sm + L.hs, acc + P.w1);
    transposed(sm + L.hs, 16, sm + L.w1, kLW1, 64, 0, r);
    __syncthreads();
    store_masked(sm + L.h1, r);
    __syncthreads();
    // base layer 1: dW0, the features' cotangent into OUT, the biases
    if (wgrad) weight_grad<64>(sm + L.xb, D, sm + L.h1, acc + P.w0);
    if (a.g_feats)
      for (int cbase = 0; cbase < D; cbase += 64) {
        transposed(sm + L.h1, 64, sm + L.w0, kLW, D, cbase, r);
        store_rows(sm + L.out, r, D, cbase, rnd);
      }
    if (wgrad && threadIdx.x < 211) {
      const int i = threadIdx.x;
      const float* row;
      int at;
      if (i < 64) row = sm + L.h1 + i * kLD, at = P.b0 + i;
      else if (i < 80) row = sm + L.hs + (i - 64) * kLD, at = P.b1 + i - 64;
      else if (i < 144) row = sm + L.g1 + (i - 80) * kLD, at = P.c0 + i - 80;
      else if (i < 208) row = sm + L.g2 + (i - 144) * kLD, at = P.c1 + i - 144;
      else row = sm + L.dz + (i - 208) * kLD, at = P.c2 + i - 208;
      acc[at] += row_sum(row);
    }
    __syncthreads();
    if (a.g_feats)
      for (int i = threadIdx.x; i < nt * D; i += kThreads) {
        const int s = i / D, d = i - s * D;
        a.g_feats[(long long)(base + s) * D + d] = sm[L.out + d * kLD + s];
      }
  }
  if (wgrad) {
    __syncthreads();
    float* part = a.partials + (long long)blockIdx.x * P.total;
    for (int i = threadIdx.x; i < P.total; i += kThreads) part[i] = acc[i];
  }
}

// K9b's second launch: each weight-gradient element the sum of the blocks'
// partials in block order, then each ray's code cotangent the sum of its k
// samples' terms in order.
__global__ void __launch_bounds__(kThreads) head_sum_kernel(const __grid_constant__ HeadArgs a) {
  const int D = a.D, E = a.codes ? a.E : 0;
  const int P = a.g_params ? params_of(D, color_in(E)).total : 0;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < P) {
    float s = 0.f;
    for (int b = 0; b < a.blocks; ++b) s += a.partials[(long long)b * P + i];
    a.g_params[i] = s;
    return;
  }
  i -= P;
  if (a.g_codes && a.k > 1 && i < (long long)a.m * E) {
    const long long r = i / E, e = i - r * E;
    const float* t = a.code_terms + r * a.k * E + e;
    float s = 0.f;
    for (int j = 0; j < a.k; ++j) s += t[(long long)j * E];
    a.g_codes[i] = s;
  }
}

int smem_bytes(int D, int E, bool backward) {
  return (int)sizeof(float) * smem_of(D, color_in(E), backward).total;
}

template <typename Kernel>
int launch(Kernel kernel, const HeadArgs& a, int grid, int bytes, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  if (grid == 0) {  // persistent: the blocks that fit on the card at once, at most a tile each
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, bytes);
    const int tiles = (a.n + kT - 1) / kT, slots = (per_sm > 1 ? per_sm : 1) * (sms > 1 ? sms : 1);
    grid = tiles < slots ? tiles : slots;
  }
  kernel<<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The shared memory a launch of K9a (backward 0) or K9b (1) takes at D
// features and E-wide codes (0: none), in bytes.
extern "C" int head_smem(int D, int E, int backward) { return smem_bytes(D, E, backward != 0); }

// The widths of every preset (16 levels x F 2, codes of 32 or none) take
// kernels with D and E known at compile time; any other width the one that
// reads them from the arguments.
extern "C" int head_fwd(const HeadArgs* args, cudaStream_t stream) {
  const HeadArgs a = *args;
  if (a.n <= 0) return 0;
  const int E = a.codes ? a.E : 0, bytes = smem_bytes(a.D, E, false);
  if (a.D == 32 && E == 32) return launch(head_fwd_kernel<32, 32>, a, 0, bytes, stream);
  if (a.D == 32 && E == 0) return launch(head_fwd_kernel<32, 0>, a, 0, bytes, stream);
  return launch(head_fwd_kernel<0, -1>, a, 0, bytes, stream);
}

extern "C" int head_bwd(const HeadArgs* args, cudaStream_t stream) {
  const HeadArgs a = *args;
  if (a.n <= 0) return 0;
  const int E = a.codes ? a.E : 0, bytes = smem_bytes(a.D, E, true);
  int err;
  if (a.D == 32 && E == 32) err = launch(head_bwd_kernel<32, 32>, a, a.blocks, bytes, stream);
  else if (a.D == 32 && E == 0) err = launch(head_bwd_kernel<32, 0>, a, a.blocks, bytes, stream);
  else err = launch(head_bwd_kernel<0, -1>, a, a.blocks, bytes, stream);
  if (err != cudaSuccess) return err;
  const long long P = a.g_params ? params_of(a.D, color_in(E)).total : 0;
  const long long codes = a.g_codes && a.k > 1 ? (long long)a.m * a.E : 0;
  if (P + codes > 0)
    head_sum_kernel<<<(int)((P + codes + kThreads - 1) / kThreads), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
