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
// Same function as the plain chain to f32 accuracy. K9a is f32 FMA with
// each sum in k order from zero, as cuBLAS sums these products (the
// density is the plain chain's bits), so that the ReLUs K9b's masks read
// and the bf16 rounding of the colour input fall the plain chain's way. A
// forward on the tensor cores (tried: PERF.md §6) put a few
// units a step within an ulp of zero on the other side of their ReLU,
// which takes a bias gradient up to 1e-3 from the plain chain's, past
// TOLERANCE at 7 of 30 seeded shapes, whatever the products' accuracy.
// K9b runs every product on the tensor cores: each f32 operand is split
// into three bf16 pieces that sum back to it exactly (x = h + m + l, 8
// significant bits each: split2), and a product keeps every cross term of
// 2^-24 of it or more -- hh, hm, mh, mm, hl, lh: six bf16 MMAs (mma.sync
// m16n8k16, f32 accumulation) -- dropping ml, lm and ll (under 2^-26). An
// operand that is bf16 already (the features and the colour input where
// compute_dtype is bfloat16) is one piece, and its product with a split
// operand (three MMAs) is exact. hh goes into one accumulator and the small
// terms into another, added in f32 at the end of each product: every
// accumulation on the tensor cores rounds, and so the hh chain takes one
// rounding a 16-deep step (all six terms in one accumulator read 3.5x the
// error). Measured against f64 on an H100 (a 64 -> 64 layer, 56,192
// samples, PERF.md §6): 4.7e-8 forward and 6.6e-8 for the input cotangent
// (cuBLAS f32: 1.0e-7 and 1.4e-7), 1.1e-7 / 1.2e-7 with weights and
// activations spread over 1e-3..1e3; one bf16 product reads 2.3e-3 and
// TF32 2.7e-4. bf16 rounding stays where the plain chain has it: the two
// MLP inputs and their cotangents (where compute_dtype is bfloat16).
//
// What bounds it on the card: a sample is 11,392 multiply-adds forward
// (32x64 + 64x16 + 63x64 + 64x64 + 64x3 at L*F = 32, E = 32): K9a 0.019 ms
// at 67 TFLOP/s of f32 FMA for 56,160 samples, where a 4 x 4 register tile
// reads 2 bytes of shared memory a FMA, twice what shared memory serves at
// the FMA rate. The backward is as many again for the input cotangents
// and for the weight gradients: split, 4,200 m16n8k16 MMAs a 64-sample
// tile in bf16, 0.015 ms at 989 TFLOP/s (mma.sync reaches about two thirds
// of that rate). The bytes (the features in, density and rgb out, the
// saved activations out and back: ~2 KB a sample) are ~0.035 ms at 3.35
// TB/s, spread over both kernels.
//
// Design:
// - Persistent blocks of 256 threads (8 warps) walk tiles of 64 samples
//   (tile t, t + gridDim.x, ...); each block loads the weights into shared
//   memory once.
// - K9a (PR 26's): the f32 weights and every 64-wide activation of a tile
//   in shared memory, feature-major, rows 68 floats apart; each layer a
//   register-tiled product, 4 samples x 4 outputs a thread, k in order;
//   a tile's inputs loaded a tile ahead. It writes the activations K9b
//   reads (saved).
// - K9b: the weights as bf16 pieces, transposed ([out][in], rows 8 bf16
//   longer than the width so that ldmatrix's eight rows fall in eight bank
//   groups). A phase a layer: dX = dY W^T (the input cotangents, a warp 16
//   samples and half the columns) and dW^T = dY^T X (the weight gradients,
//   the samples the depth of the product), both from sample-major pieces
//   ([sample][feature]) in shared memory that the phase before wrote, read
//   by ldmatrix (.trans where the product needs it the other way); the
//   bias gradients are one more column of each weight gradient's product,
//   against a constant B of ones. It reads the activations K9a saved
//   instead of recomputing them, each phase's rows copied by cp.async into
//   a buffer the phase before left free (head_bwd_kernel). The weight
//   gradients of a tile are added in f32 into each lane's own accumulators
//   (registers; the biases' in shared memory).
// - No atomics, so every output is the same bits at every call: each
//   element of a weight gradient belongs to one lane, which adds each
//   tile's product into it in tile order; the block writes its partial
//   once, and head_sum_kernel adds the blocks' partials in block order (a
//   replayed graph equals its eager steps bit for bit). The codes'
//   cotangents of a ray's k samples are summed there too, in sample order.
// - What varies between paths is read from the arguments: compute_dtype
//   (bf16), the codes (null: none; a stride of 0: one code for every ray),
//   k = n / m samples a ray, the directions (null: density only), whether
//   a backward follows (saved) and which gradients are wanted (null
//   outputs are skipped: a frozen field asks for no weight gradient). The
//   presets' widths (L*F = 32, codes of 32 or none) take kernels compiled
//   for them (K9b also for bf16 or f32); any other width up to 64 the ones
//   that read it.
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
constexpr int kSH = 16;    // degree-4 spherical harmonics
constexpr int kGeo = 15;
constexpr int kSaved = 64 + 16 + 64 + 64;  // a tile's saved rows: H1, HS, G1, G2
constexpr int kPad = 8;    // bf16 past a row's width: ldmatrix's 8 rows in 8 bank groups
constexpr int kLD = 68;    // K9a: floats between the rows of a tile's activations
constexpr int kLW = 68;    // ... of a 64-wide weight
constexpr int kLW1 = 20;   // ... of the base MLP's 16-wide output layer
constexpr int kLW2 = 4;    // ... of the colour MLP's 3-wide output layer

__host__ __device__ inline int color_in(int E) { return kSH + kGeo + E; }
__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

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

// K9b's shared memory in bytes, every offset a multiple of 16. A matrix of
// bf16 pieces is three planes of rows x (width + kPad). The weights,
// transposed: W0 (64 x Dp), W1 (16 x 64), V0 (64 x Cp), V1 (64 x 64), V2
// (16 x 64, rows 3 on zero); the biases (f32); BIG1, BIG2 and MID (64
// samples x Wb, Wb, 64) in turn (see head_bwd_kernel), ZB (dZ, 64 x 16,
// columns 3 on zero) and HB (dHS, 64 x 16), SS the directions, SHG the SH
// cotangents (f32) and BACC the bias gradients' accumulators (f32).
struct Smem {
  int w0, w1, v0, v1, v2, bias, big1, big2, mid, zb, hb, ss, shg, bacc, total;
  int Dp, Cp, Wb;
};

__host__ __device__ inline int pieces(int rows, int width) { return 3 * rows * (width + kPad) * 2; }

__host__ __device__ inline Smem smem_of(int D, int CIN) {
  Smem s;
  s.Dp = up16(D);
  s.Cp = up16(CIN);
  s.Wb = s.Dp > s.Cp ? s.Dp : s.Cp;
  if (s.Wb < 64) s.Wb = 64;
  int o = 0;
  s.w0 = o; o += pieces(64, s.Dp);
  s.w1 = o; o += pieces(16, 64);
  s.v0 = o; o += pieces(64, s.Cp);
  s.v1 = o; o += pieces(64, 64);
  s.v2 = o; o += pieces(16, 64);
  s.bias = o; o += 212 * 4;  // b0 (64), b1 (16), c0 (64), c1 (64), c2 (4)
  s.big1 = o; o += pieces(kT, s.Wb);
  s.mid = o; o += pieces(kT, 64);
  s.big2 = o; o += pieces(kT, s.Wb);
  s.zb = o; o += pieces(kT, 16);
  s.hb = o; o += pieces(kT, 16);
  s.ss = o; o += 3 * kT * 4;
  s.shg = o; o += kSH * kT * 4;
  s.bacc = o; o += 212 * 4;
  s.total = o;
  return s;
}

// the biases' offsets in floats (Smem::bias and Smem::bacc)
constexpr int kB0 = 0, kB1 = 64, kC0 = 80, kC1 = 144, kC2 = 208;

__device__ __forceinline__ float bf16_round(float x) {
  // round to nearest even, as torch's float -> bfloat16 cast
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return __uint_as_float(0x7fc00000u);
  u += 0x7fffu + ((u >> 16) & 1u);
  return __uint_as_float(u & 0xffff0000u);
}

// -- the tensor cores' operands ----------------------------------------------------

// (lo, hi) rounded to bf16 (nearest even) into one register, lo in the low half
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ float low_f(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float high_f(uint32_t p) { return __uint_as_float(p & 0xffff0000u); }

// (x0, x1) as three packed bf16 pairs h, m, l with x = h + m + l exactly:
// each remainder is exact in f32, and 8 + 8 + 8 significant bits hold an
// f32's 24 (for |x| above 2^-102; the sum then loses only bits under
// bf16's smallest subnormal).
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& h, uint32_t& m, uint32_t& l) {
  h = pack_rn(x0, x1);
  const float r0 = x0 - low_f(h), r1 = x1 - high_f(h);
  m = pack_rn(r0, r1);
  l = pack_rn(r0 - low_f(m), r1 - high_f(m));
}

// bf16 pieces in shared memory: piece p of element (r, c) at p * plane + r * ld + c
struct Mat {
  uint16_t* p;
  int ld, plane;
};

__device__ __forceinline__ Mat mat(uint8_t* sm, int off, int rows, int width) {
  Mat m;
  m.p = reinterpret_cast<uint16_t*>(sm + off);
  m.ld = width + kPad;
  m.plane = rows * m.ld;
  return m;
}

// (x0, x1) at (r, c), (r, c + 1): split into three pieces, or rounded to
// bf16 (one piece, the others zero) where `round`; c even.
__device__ __forceinline__ void put2(const Mat& M, int r, int c, float x0, float x1, bool round) {
  uint32_t h, m, l;
  if (round) {
    h = pack_rn(x0, x1);
    m = l = 0u;
  } else {
    split2(x0, x1, h, m, l);
  }
  uint32_t* q = reinterpret_cast<uint32_t*>(M.p + r * M.ld + c);
  const int plane = M.plane >> 1;
  q[0] = h;
  q[plane] = m;
  q[2 * plane] = l;
}

// one element: the pieces of x (or x rounded where `round`)
__device__ __forceinline__ void put1(const Mat& M, int r, int c, float x, bool round) {
  uint16_t* q = M.p + r * M.ld + c;
  if (round) {
    q[0] = static_cast<uint16_t>(pack_rn(x, 0.f));
    q[M.plane] = q[2 * M.plane] = 0;
    return;
  }
  uint32_t h, m, l;
  split2(x, 0.f, h, m, l);
  q[0] = static_cast<uint16_t>(h);
  q[M.plane] = static_cast<uint16_t>(m);
  q[2 * M.plane] = static_cast<uint16_t>(l);
}

// x rounded to bf16 at (r, c) of plane 0 alone: for an operand that the
// products read as one piece (bf16 already), whose other planes they skip
__device__ __forceinline__ void put1h(const Mat& M, int r, int c, float x) {
  M.p[r * M.ld + c] = static_cast<uint16_t>(pack_rn(x, 0.f));
}

// x at (r, c) as put1h where `round`, else as its three pieces
__device__ __forceinline__ void put_in(const Mat& M, int r, int c, float x, bool round) {
  if (round) put1h(M, r, c, x);
  else put1(M, r, c, x, false);
}

// whether (r, c) and (r, c + 1) are nonzero (a ReLU's output: its h piece
// is nonzero wherever it is positive, down to bf16's subnormals)
__device__ __forceinline__ uint32_t positive2(const Mat& M, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(M.p + r * M.ld + c) & 0x7fff7fffu;
}

__device__ __forceinline__ void ldsm4(uint32_t r[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm4t(uint32_t r[4], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm2(uint32_t r[2], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm2t(uint32_t r[2], const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// c += a b: a 16 x 16 bf16 A fragment, a 16 x 8 B fragment, f32 accumulation
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }
__device__ __forceinline__ int warp() { return threadIdx.x >> 5; }

// A's 16 x 16 fragment at rows m0, depth k0 of piece base: stored [m][k]
// (T: [k][m], loaded transposed)
template <bool T>
__device__ __forceinline__ void load_a(uint32_t r[4], const uint16_t* base, int ld, int m0, int k0) {
  const int l = lane(), i = l >> 3;
  if (!T) ldsm4(r, base + (m0 + (l & 7) + (i & 1) * 8) * ld + k0 + (i >> 1) * 8);
  else ldsm4t(r, base + (k0 + (l & 7) + (i >> 1) * 8) * ld + m0 + (i & 1) * 8);
}

// the row a lane gives ldmatrix for half `half` of B's 16 x 8 fragment at
// depth k0, columns n0: stored [n][k] (T: [k][n])
template <bool T>
__device__ __forceinline__ const uint16_t* b_row(const uint16_t* base, int ld, int n0, int k0,
                                                 int half) {
  const int l = lane() & 7;
  return T ? base + (k0 + half * 8 + l) * ld + n0 : base + (n0 + l) * ld + k0 + half * 8;
}

// B's fragment, each of its P pieces
template <int P, bool T>
__device__ __forceinline__ void load_b(uint32_t b[P][2], const Mat& B, int n0, int k0) {
  const int q = lane() >> 3;
  if (P == 3) {
    uint32_t r[4];
    const uint16_t* p = b_row<T>(B.p + (q >> 1) * B.plane, B.ld, n0, k0, q & 1);
    if (T) ldsm4t(r, p); else ldsm4(r, p);
    b[0][0] = r[0];
    b[0][1] = r[1];
    b[1 % P][0] = r[2];
    b[1 % P][1] = r[3];
  }
  const uint16_t* p = b_row<T>(B.p + (P - 1) * B.plane, B.ld, n0, k0, q & 1);
  if (T) ldsm2t(b[P - 1], p); else ldsm2(b[P - 1], p);
}

// The product of A's m-tile at row m0 (PA pieces; TA: stored transposed)
// and B's nt column tiles from n0 (PB pieces; TB: stored transposed), over
// depth kd (a multiple of 16): the hh terms into hi, the rest into lo, each
// tile j's from zero. With Bias, bh/bl also take the m-tile's row sums of A
// (its product with a column of ones).
template <int NT, int PA, int PB, bool TA, bool TB, bool Bias = false>
__device__ __forceinline__ void product(float (&hi)[NT][4], float (&lo)[NT][4], const Mat& A, int m0,
                                        const Mat& B, int n0, int nt, int kd, float (&bh)[4],
                                        float (&bl)[4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) hi[j][q] = lo[j][q] = 0.f;
  if (Bias)
#pragma unroll
    for (int q = 0; q < 4; ++q) bh[q] = bl[q] = 0.f;
  float lo2[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t one = (lane() >> 2) == 0 ? 0x3f803f80u : 0u;  // a column of bf16 ones
  const uint32_t ones[2] = {one, one};
#pragma unroll 2
  for (int k0 = 0; k0 < kd; k0 += 16) {
    uint32_t a[PA][4];
#pragma unroll
    for (int p = 0; p < PA; ++p) load_a<TA>(a[p], A.p + p * A.plane, A.ld, m0, k0);
    if (Bias) {
      mma(bh, a[0], ones);
      if (PA == 3) {
        mma(bl, a[2], ones);
        mma(bl, a[1], ones);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
      uint32_t b[PB][2];
      load_b<PB, TB>(b, B, n0 + 8 * j, k0);
      // one tile alone: the 2^-16 terms into a chain of their own, so that
      // fewer MMAs wait on each other
      float* small = NT == 1 ? lo2 : lo[j];
      mma(hi[j], a[0], b[0]);
      if (PB == 3) mma(small, a[0], b[2 % PB]);
      if (PA == 3) mma(small, a[2 % PA], b[0]);
      if (PA == 3 && PB == 3) mma(small, a[1 % PA], b[1 % PB]);
      if (PB == 3) mma(lo[j], a[0], b[1 % PB]);
      if (PA == 3) mma(lo[j], a[1 % PA], b[0]);
    }
  }
  if (NT == 1)
#pragma unroll
    for (int q = 0; q < 4; ++q) lo[0][q] += lo2[q];
}

// product with PB = 1 where the B operand is bf16 already (`exact`), else 3
template <int NT, bool TA, bool TB, bool Bias = false>
__device__ __forceinline__ void product_b(bool exact, float (&hi)[NT][4], float (&lo)[NT][4],
                                          const Mat& A, int m0, const Mat& B, int n0, int nt,
                                          int kd, float (&bh)[4], float (&bl)[4]) {
  if (exact) product<NT, 3, 1, TA, TB, Bias>(hi, lo, A, m0, B, n0, nt, kd, bh, bl);
  else product<NT, 3, 3, TA, TB, Bias>(hi, lo, A, m0, B, n0, nt, kd, bh, bl);
}

// A lane's place in a 16 x 8 output tile: rows g, g + 8; columns 2t, 2t + 1
__device__ __forceinline__ int frag_g() { return lane() >> 2; }
__device__ __forceinline__ int frag_t() { return lane() & 3; }

// -- the weights ----------------------------------------------------------------

// K9b: a (rows, cols) row-major f32 weight as a thread holds it between
// its loads and its stores into zeroed pieces, transposed ([col][row]): a
// warp takes blocks of 8 columns x 8 rows (U of them: every block of the
// widest weight the kernels take), a lane a column and a pair of rows, so
// that its loads are 32-byte sectors and its two values one 32-bit word of
// each piece, the warp's words in 32 banks.
template <int U>
struct WeightLoad {
  float x[U][2];

  __device__ __forceinline__ static void place(int u, int cols, int& r, int& c) {
    const int cgs = (cols + 7) >> 3, b = warp() + u * (kThreads / 32);
    c = (b % cgs) * 8 + (lane() & 7);
    r = (b / cgs) * 8 + (lane() >> 3) * 2;
  }

  __device__ __forceinline__ void load(const float* g, int rows, int cols) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int r, c;
      place(u, cols, r, c);
      x[u][0] = c < cols && r < rows ? g[r * cols + c] : 0.f;
      x[u][1] = c < cols && r + 1 < rows ? g[(r + 1) * cols + c] : 0.f;
    }
  }

  __device__ __forceinline__ void store(const Mat& W, int rows, int cols) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int r, c;
      place(u, cols, r, c);
      if (c < cols && r < rows) put2(W, c, r, x[u][0], x[u][1], false);
    }
  }
};

__device__ void load_row(float* s, const float* g, int n, int total) {
  for (int c = threadIdx.x; c < total; c += kThreads) s[c] = c < n ? g[c] : 0.f;
}

// K9b's weights into pieces (their pads zero) and the biases as they are,
// every weight's loads in flight before the first store.
__device__ void load_weights(uint8_t* sm, const Smem& L, const HeadArgs& a, int D, int CIN) {
  WeightLoad<8> w0, v1;  // up to 64 x 64
  WeightLoad<2> w1;
  WeightLoad<12> v0;  // up to 96 x 64
  WeightLoad<1> v2;
  w0.load(a.w0, D, 64);
  w1.load(a.w1, 64, 16);
  v0.load(a.v0, CIN, 64);
  v1.load(a.v1, 64, 64);
  v2.load(a.v2, 64, 3);
  uint4* z = reinterpret_cast<uint4*>(sm);
  for (int i = threadIdx.x; i < L.bias / 16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  float* bias = reinterpret_cast<float*>(sm + L.bias);
  load_row(bias + kB0, a.b0, 64, 64);
  load_row(bias + kB1, a.b1, 16, 16);
  load_row(bias + kC0, a.c0, 64, 64);
  load_row(bias + kC1, a.c1, 64, 64);
  load_row(bias + kC2, a.c2, 3, 4);
  __syncthreads();
  w0.store(mat(sm, L.w0, 64, L.Dp), D, 64);
  w1.store(mat(sm, L.w1, 16, 64), 64, 16);
  v0.store(mat(sm, L.v0, 64, L.Cp), CIN, 64);
  v1.store(mat(sm, L.v1, 64, 64), 64, 64);
  v2.store(mat(sm, L.v2, 16, 64), 64, 3);
  __syncthreads();
}

// -- a tile's inputs -------------------------------------------------------------

// K9b's per-sample inputs of a tile as a thread holds them from their
// loads, issued a tile ahead so that they land while the tile before
// computes, to their use: element tid + 256 r of the tile's codes, and
// thread tid's element of the directions, the rgb cotangent and rgb (tid <
// 192), the selector and the density cotangent (tid < 64). ET is E where
// known at compile time (-1: read from the arguments, up to 64).
template <int ET>
struct Inputs {
  static constexpr int RC = ET >= 0 ? (kT * ET + kThreads - 1) / kThreads : 16;
  float c[RC > 0 ? RC : 1];
  float dir, grgb, y, sel, gd;

  __device__ __forceinline__ void load_samples(const HeadArgs& a, int base, int nt, bool bwd) {
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
    const double kinv = 1.0 / a.k;
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int i = threadIdx.x + r * kThreads;
      const int s = i / E, e = i - s * E;
      // the sample's ray (base + s) / k, by a product and a correction
      int ray = static_cast<int>((base + s) * kinv);
      ray += (ray + 1) * a.k <= base + s;
      ray -= ray * a.k > base + s;
      c[r] = i < kT * E && s < nt ? a.codes[(long long)ray * a.code_stride + e] : 0.f;
    }
  }

  // the directions into ss ([3][kT])
  __device__ __forceinline__ void store_dirs(float* ss) const {
    const int t = threadIdx.x;
    if (t < 3 * kT) {
      const int s = t / 3, j = t - s * 3;
      ss[j * kT + s] = dir;
    }
  }

  // the codes (rounded where bf16) into the colour input's columns 31 on,
  // zeros on to Cp
  __device__ __forceinline__ void store_codes(const Mat& CB, int E, int Cp, bool bf16) const {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      const int i = threadIdx.x + r * kThreads;
      if (i < kT * E) {
        const int s = i / E, e = i - s * E;
        put_in(CB, s, kSH + kGeo + e, c[r], bf16);
      }
    }
    const int from = color_in(E), w = Cp - from;
    for (int i = threadIdx.x; i < kT * w; i += kThreads) {
      const int s = i / w, col = from + i - s * w;
      put_in(CB, s, col, 0.f, bf16);
    }
  }
};

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

// The colour input's SH columns (0-15) of the tile's samples from the
// directions in ss, rounded where bf16: four threads a sample, each
// storing four of them.
__device__ __forceinline__ void store_sh(const Mat& CB, const float* ss, bool bf16) {
  const int s = threadIdx.x & (kT - 1), q = (threadIdx.x >> 6) * 4;
  float o[kSH];
  sh_encode(ss[s], ss[kT + s], ss[2 * kT + s], o);
#pragma unroll
  for (int i = 0; i < kSH; i += 4) {
    if (i == q)
#pragma unroll
      for (int k = 0; k < 4; ++k) put_in(CB, s, i + k, o[i + k], bf16);
  }
}

// -- K9a: PR 26's f32 FMA forward ---------------------------------------------------

// K9a's shared memory in floats, every offset a multiple of 4 (16 bytes):
// the f32 weights, rows kLW apart; A holds the features, then the colour
// input, then the second colour layer; B the first base layer, then the
// first colour layer; SS the directions and the selector; SP the last
// layer's partial sums.
struct FwdSmem {
  int w0, b0, w1, b1, v0, c0, v1, c1, v2, c2;
  int xb, h1, hs, cb, g1, g2, ss, sp, total;
};

__host__ __device__ inline FwdSmem fwd_smem_of(int D, int CIN) {
  FwdSmem s;
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
  s.xb = s.cb = s.g2 = o; o += (wide > 64 ? wide : 64) * kLD;   // A
  s.h1 = s.g1 = o; o += 64 * kLD;                               // B
  s.hs = o; o += 16 * kLD;
  s.ss = o; o += 4 * kT;
  s.sp = o; o += 4 * 4 * kT;
  s.total = o;
  return s;
}

// per-sample values in SS: directions [3][kT], the selector
constexpr int kFwdDirs = 0, kFwdSel = 3 * kT;

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
__device__ void load_weight_f32(float* s, const float* g, int rows, int cols, int ld) {
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


__device__ void load_weights_f32(float* sm, const FwdSmem& L, const HeadArgs& a, int D, int CIN,
                             bool color) {
  load_weight_f32(sm + L.w0, a.w0, D, 64, kLW);
  load_row(sm + L.b0, a.b0, 64, 64);
  load_weight_f32(sm + L.w1, a.w1, 64, 16, kLW1);
  load_row(sm + L.b1, a.b1, 16, 16);
  if (!color) return;
  load_weight_f32(sm + L.v0, a.v0, CIN, 64, kLW);
  load_row(sm + L.c0, a.c0, 64, 64);
  load_weight_f32(sm + L.v1, a.v1, 64, 64, kLW);
  load_row(sm + L.c1, a.c1, 64, 64);
  load_weight_f32(sm + L.v2, a.v2, 64, 3, kLW2);
  load_row(sm + L.c2, a.c2, 3, 4);
}

// K9a's inputs of a tile as a thread holds them from their loads, issued a
// tile ahead so that they land while the tile before computes, to their
// stores into shared memory: element tid + 256 r of the tile's features and
// of its codes, and thread tid's element of the directions (tid < 192) and
// the selector (tid < 64). DT and ET are D and E where known at compile
// time (0 and -1: read from the arguments, D and E up to 64).
template <int DT, int ET>
struct FwdInputs {
  static constexpr int RF = DT ? (kT * DT + kThreads - 1) / kThreads : 16;
  static constexpr int RC = ET >= 0 ? (kT * ET + kThreads - 1) / kThreads : 16;
  float f[RF];
  float c[RC > 0 ? RC : 1];
  float dir, sel;

  __device__ __forceinline__ void load(const HeadArgs& a, int D, int base, int nt) {
    const long long at = (long long)base * D;
#pragma unroll
    for (int r = 0; r < RF; ++r) {
      const int i = threadIdx.x + r * kThreads;
      f[r] = i < nt * D ? a.feats[at + i] : 0.f;
    }
    const int t = threadIdx.x;
    dir = a.dirs && t < 3 * nt ? a.dirs[(long long)base * 3 + t] : 0.f;
    sel = t < nt && a.sel[base + t] ? 1.f : 0.f;
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

  // the features (rounded where bf16) into xb, the directions and the
  // selector into ss
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
      ss[kFwdDirs + j * kT + s] = dir;
    }
    if (t < kT) ss[kFwdSel + t] = sel;
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

// The colour input's SH and geo rows, rounded where bf16, into cb (the
// codes' rows: FwdInputs::store_codes).
__device__ void color_input_f32(const HeadArgs& a, float* sm, const FwdSmem& L) {
  float* cb = sm + L.cb;
  const float* hs = sm + L.hs;
  const float* ss = sm + L.ss;
  const bool r = a.bf16;
  if (threadIdx.x < kT) {
    const int s = threadIdx.x;
    float o[kSH];
    sh_encode(ss[kFwdDirs + s], ss[kFwdDirs + kT + s], ss[kFwdDirs + 2 * kT + s], o);
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

template <int DT, int ET>
__global__ void __launch_bounds__(kThreads, 2) head_fwd_kernel(const __grid_constant__ HeadArgs a) {
  extern __shared__ __align__(16) uint8_t sm8[];
  float* sm = reinterpret_cast<float*>(sm8);
  const int D = DT ? DT : a.D, E = ET >= 0 ? ET : (a.codes ? a.E : 0), CIN = color_in(E);
  const bool color = a.rgb != nullptr, rnd = a.bf16 != 0;
  const FwdSmem L = fwd_smem_of(D, CIN);
  load_weights_f32(sm, L, a, D, CIN, color);
  const int tiles = (a.n + kT - 1) / kT;
  FwdInputs<DT, ET> in;
  int t = blockIdx.x;
  if (t < tiles) {
    in.load(a, D, t * kT, min(kT, a.n - t * kT));
    if (color) in.load_codes(a, E, t * kT, min(kT, a.n - t * kT));
  }
  for (; t < tiles; t += gridDim.x) {
    const int base = t * kT, nt = min(kT, a.n - base);
    const int next = t + gridDim.x, nbase = next * kT, nnt = min(kT, a.n - nbase);
    __syncthreads();
    in.store(sm + L.xb, sm + L.ss, D, rnd);
    if (next < tiles) in.load(a, D, nbase, nnt);
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
      a.density[base + s] = __fmul_rn(d, sm[L.ss + kFwdSel + s]);
    }
    if (!color) continue;
    color_input_f32(a, sm, L);
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

// The weight-gradient accumulators of a lane: each 16 x 8 tile of dW^T it
// owns (NT of them), added to in f32 after each tile's product.
template <int NT>
struct Acc {
  float v[NT][4];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] = 0.f;
  }

  __device__ __forceinline__ void add(const float (&hi)[NT][4], const float (&lo)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) v[j][q] += hi[j][q] + lo[j][q];
  }

  // into the partial: dW[k][o] at p + k * outs + o for the tile's outputs o
  // = m0 + row (below `outs`) and inputs k = n0 + 8 j + column (below `ins`)
  __device__ __forceinline__ void write(float* part, int m0, int n0, int nt, int outs,
                                        int ins) const {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = m0 + frag_g() + 8 * (q >> 1), k = n0 + 8 * j + 2 * frag_t() + (q & 1);
        if (o < outs && k < ins) part[k * outs + o] = v[j][q];
      }
    }
  }
};

// The bias column of a product (the lanes of column 0: rows g, g + 8) into
// the block's accumulators at acc[m0 + row] for rows below `outs`.
__device__ __forceinline__ void add_bias(float* acc, int m0, int outs, const float (&bh)[4],
                                         const float (&bl)[4]) {
  if (frag_t() != 0) return;
  const int r = m0 + frag_g();
  if (r < outs) acc[r] += bh[0] + bl[0];
  if (r + 8 < outs) acc[r + 8] += bh[2] + bl[2];
}

// -- K9b's staging: the next phase's rows copied into a free buffer -----------------

// 16 bytes from global to shared memory without passing through registers
// (cp.async): issued now, landed after staged().
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// this thread's copies landed (a barrier then shows everyone's)
__device__ __forceinline__ void staged() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// n floats of g (16-byte aligned; n a multiple of 4) into st
__device__ __forceinline__ void stage(float* st, const float* g, int n) {
  for (int i = threadIdx.x * 4; i < n; i += kThreads * 4) copy16(st + i, g + i);
}

// a tile's features (nt x D floats from f) into st as [64][D], zeros past nt
__device__ __forceinline__ void stage_feats(float* st, const float* f, int nt, int D) {
  const int n = nt * D;
  if ((reinterpret_cast<uintptr_t>(f) & 15) == 0 && (n & 3) == 0) stage(st, f, n);
  else
    for (int i = threadIdx.x; i < n; i += kThreads) st[i] = f[i];
  for (int i = n + threadIdx.x; i < kT * D; i += kThreads) st[i] = 0.f;
}

// a staged tile's 64 saved rows ([64][kT] floats) into a sample-major
// matrix as pieces: item i of a warp covers samples (q & 7) * 8 + (lane &
// 7) and the feature pair (q >> 3) * 4 + (lane >> 3), q = 8 warp + i, so
// that the warp's stores hit 32 banks
__device__ __forceinline__ void unstage64(const float* st, const Mat& M) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = warp() * 8 + i, s = ((q & 7) << 3) + (lane() & 7), f = ((q >> 3) << 3) + ((lane() >> 3) << 1);
    put2(M, s, f, st[f * kT + s], st[(f + 1) * kT + s], false);
  }
}

// K9b: the backward of 64-sample tiles, a phase a layer. The phases'
// buffers turn: before each phase the rows it reads are copied (cp.async)
// into a buffer the phase before leaves free, so that no phase waits on
// device memory:
//   P0  G2 (MID's copy) -> BIG1; dZ -> ZB; dHS[0] -> HB
//   P1  dG2 -> MID; dV2                       copying G1 -> BIG2
//       G1 (BIG2's copy) -> BIG1
//   P2  dG1 -> BIG2; dV1                      copying HS[1:16] -> ZB
//       CB (geo from ZB's copy) -> BIG1
//   P3  dCB -> SHG, HB[1:16], the codes; dV0  copying H1 -> MID
//       H1 (MID's copy) -> BIG1; the directions' cotangent
//   P4  dH1 -> BIG2; dW1                      copying the features -> MID
//       X (MID's copy) -> BIG1
//   P5  dX out; dW0                           copying the next G2, HS[0] -> MID
template <int DT, int ET, bool RND>
__global__ void __launch_bounds__(kThreads, 1) head_bwd_kernel(const __grid_constant__ HeadArgs a) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int D = DT ? DT : a.D, E = ET >= 0 ? ET : (a.codes ? a.E : 0), CIN = color_in(E);
  // the column tiles a warp takes of the colour input and of the features
  constexpr int NTC = ET >= 0 ? (ET + kSH + kGeo + 15) / 16 : 6;
  constexpr int NTD = DT ? (DT + 15) / 16 : 4;
  const Smem L = smem_of(D, CIN);
  const Params P = params_of(D, CIN);
  const int ntc = L.Cp / 16, ntd = L.Dp / 16;
  const Mat W0 = mat(sm, L.w0, 64, L.Dp), W1 = mat(sm, L.w1, 16, 64);
  const Mat V0 = mat(sm, L.v0, 64, L.Cp), V1 = mat(sm, L.v1, 64, 64), V2 = mat(sm, L.v2, 16, 64);
  const Mat BIG1 = mat(sm, L.big1, kT, L.Wb), BIG2 = mat(sm, L.big2, kT, L.Wb);
  const Mat MID = mat(sm, L.mid, kT, 64), ZB = mat(sm, L.zb, kT, 16), HB = mat(sm, L.hb, kT, 16);
  float* mid_st = reinterpret_cast<float*>(MID.p);  // the staged rows, as f32
  float* big2_st = reinterpret_cast<float*>(BIG2.p);
  float* zb_st = reinterpret_cast<float*>(ZB.p);
  float* ss = reinterpret_cast<float*>(sm + L.ss);
  float* shg = reinterpret_cast<float*>(sm + L.shg);
  float* bacc = reinterpret_cast<float*>(sm + L.bacc);
  const bool wgrad = a.g_params != nullptr;
  constexpr bool rnd = RND;  // a.bf16: bf16 MLP inputs and cotangents
  load_weights(sm, L, a, D, CIN);
  for (int i = threadIdx.x; i < 212; i += kThreads) bacc[i] = 0.f;
  const int w = warp(), g = frag_g(), tq = frag_t(), mt = (w & 3) * 16, half = w >> 2;
  Acc<1> aV2, aW1;
  Acc<4> aV1;
  Acc<NTC> aV0;
  Acc<NTD> aW0;
  aV2.zero();
  aW1.zero();
  aV1.zero();
  aV0.zero();
  aW0.zero();
  const int tiles = (a.n + kT - 1) / kT;
  Inputs<ET> in;
  int t = blockIdx.x;
  if (t < tiles) {
    const int nt = min(kT, a.n - t * kT);
    in.load_samples(a, t * kT, nt, true);
    in.load_codes(a, E, t * kT, nt);
    stage(mid_st, a.saved + ((long long)t * kSaved + 144) * kT, 64 * kT);  // G2
    stage(mid_st + 64 * kT, a.saved + ((long long)t * kSaved + 64) * kT, kT);  // HS[0]
  }
  float hi[4][4], lo[4][4], h1[1][4], l1[1][4], hc[NTC][4], lc[NTC][4], hd[NTD][4], ld[NTD][4];
  float bh[4], bl[4];
  for (; t < tiles; t += gridDim.x) {
    const int base = t * kT, nt = min(kT, a.n - base);
    const int next = t + gridDim.x, nbase = next * kT, nnt = min(kT, a.n - nbase);
    const float* sv = a.saved + (long long)t * kSaved * kT;
    staged();
    __syncthreads();
    // P0: G2 into BIG1; dZ (the sigmoid's backward) into ZB; the density's
    // backward into HB's column 0 (dHS[0]); the directions into ss
    unstage64(mid_st, BIG1);
    if (threadIdx.x < 3 * kT) {
      const int s = threadIdx.x / 3, j = threadIdx.x - s * 3;
      put1(ZB, s, j, __fmul_rn(__fmul_rn(in.grgb, __fsub_rn(1.f, in.y)), in.y), false);
    }
    for (int i = threadIdx.x; i < kT * 13; i += kThreads) put1(ZB, i / 13, 3 + i % 13, 0.f, true);
    if (threadIdx.x < kT) {
      const float h0 = mid_st[64 * kT + threadIdx.x];
      const float gh = __fmul_rn(__fmul_rn(in.gd, in.sel), a.aid);
      put1(HB, threadIdx.x, 0, __fmul_rn(gh, expf(fminf(fmaxf(h0, -15.f), 15.f))), false);
    }
    in.store_dirs(ss);
    if (next < tiles) in.load_samples(a, nbase, nnt, true);
    __syncthreads();
    // P1, colour layer 3: dG2 = (dZ V2^T) * (G2 > 0) into MID; dV2^T = dZ^T
    // G2 and its bias column (warp 0)
    stage(big2_st, sv + 80 * kT, 64 * kT);  // G1
    {
      const int n0 = half * 32;
      product<4, 3, 3, false, true>(hi, lo, ZB, mt, V2, n0, 4, 16, bh, bl);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = mt + g + 8 * h, c = n0 + 8 * j + 2 * tq;
          const uint32_t pos = positive2(BIG1, s, c);
          put2(MID, s, c, pos & 0xffffu ? hi[j][2 * h] + lo[j][2 * h] : 0.f,
               pos >> 16 ? hi[j][2 * h + 1] + lo[j][2 * h + 1] : 0.f, false);
        }
      if (wgrad) {
        if (w == 0) {
          product<1, 3, 3, true, true, true>(h1, l1, ZB, 0, BIG1, 0, 1, kT, bh, bl);
          add_bias(bacc + kC2, 0, 3, bh, bl);
        } else {
          product<1, 3, 3, true, true>(h1, l1, ZB, 0, BIG1, 8 * w, 1, kT, bh, bl);
        }
        aV2.add(h1, l1);
      }
    }
    staged();
    __syncthreads();
    unstage64(big2_st, BIG1);  // G1
    __syncthreads();
    // P2, colour layer 2: dG1 = (dG2 V1^T) * (G1 > 0) into BIG2; dV1^T =
    // dG2^T G1 and its bias column (warps 0-3)
    stage(zb_st, sv + 65 * kT, kGeo * kT);  // geo = HS[1:16]
    {
      const int n0 = half * 32;
      product<4, 3, 3, false, true>(hi, lo, MID, mt, V1, n0, 4, 64, bh, bl);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = mt + g + 8 * h, c = n0 + 8 * j + 2 * tq;
          const uint32_t pos = positive2(BIG1, s, c);
          put2(BIG2, s, c, pos & 0xffffu ? hi[j][2 * h] + lo[j][2 * h] : 0.f,
               pos >> 16 ? hi[j][2 * h + 1] + lo[j][2 * h + 1] : 0.f, false);
        }
      if (wgrad) {
        if (half == 0) {
          product<4, 3, 3, true, true, true>(hi, lo, MID, mt, BIG1, n0, 4, kT, bh, bl);
          add_bias(bacc + kC1, mt, 64, bh, bl);
        } else {
          product<4, 3, 3, true, true>(hi, lo, MID, mt, BIG1, n0, 4, kT, bh, bl);
        }
        aV1.add(hi, lo);
      }
    }
    staged();
    __syncthreads();
    // the colour input into BIG1: SH, geo = HS[1:16], the codes
    store_sh(BIG1, ss, rnd);
    for (int i = threadIdx.x; i < kGeo * kT; i += kThreads)
      put_in(BIG1, i % kT, kSH + i / kT, zb_st[i], rnd);
    in.store_codes(BIG1, E, L.Cp, rnd);
    if (next < tiles) in.load_codes(a, E, nbase, nnt);
    __syncthreads();
    // P3, colour layer 1: the colour input's cotangent dCB = dG1 V0^T
    // (rounded where bf16): its SH columns into shg, geo's into HB's
    // columns 1-15, the codes' out; dV0^T = dG1^T CB and its bias column
    // (warps 0-3)
    stage(mid_st, sv, 64 * kT);  // H1
    {
      const int n0 = half * 8 * ntc;
      product<NTC, 3, 3, false, true>(hc, lc, BIG2, mt, V0, n0, ntc, 64, bh, bl);
      float* dst = a.k > 1 ? a.code_terms : a.g_codes;
#pragma unroll
      for (int j = 0; j < NTC; ++j) {
        if (j >= ntc) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = mt + g + 8 * (q >> 1), c = n0 + 8 * j + 2 * tq + (q & 1);
          float v = hc[j][q] + lc[j][q];
          if (rnd) v = bf16_round(v);
          if (c < kSH) shg[c * kT + s] = v;
          else if (c < kSH + kGeo) put1(HB, s, c - kGeo, v, false);
          else if (c < CIN && a.g_codes && s < nt)
            dst[(long long)(base + s) * E + c - kSH - kGeo] = v;
        }
      }
      if (wgrad) {
        if (half == 0) {
          product_b<NTC, true, true, true>(rnd, hc, lc, BIG2, mt, BIG1, n0, ntc, kT, bh, bl);
          add_bias(bacc + kC0, mt, 64, bh, bl);
        } else {
          product_b<NTC, true, true>(rnd, hc, lc, BIG2, mt, BIG1, n0, ntc, kT, bh, bl);
        }
        aV0.add(hc, lc);
      }
    }
    staged();
    __syncthreads();
    unstage64(mid_st, BIG1);  // H1
    if (a.g_dirs && (int)threadIdx.x < nt) {
      const int s = threadIdx.x;
      float gs[kSH], d[3];
#pragma unroll
      for (int i = 0; i < kSH; ++i) gs[i] = shg[i * kT + s];
      sh_backward(ss[s], ss[kT + s], ss[2 * kT + s], gs, d);
#pragma unroll
      for (int j = 0; j < 3; ++j) a.g_dirs[(long long)(base + s) * 3 + j] = d[j];
    }
    __syncthreads();
    // P4, base layer 2: dH1 = (dHS W1^T) * (H1 > 0) into BIG2; dW1^T = dHS^T
    // H1 and its bias column (warp 0)
    stage_feats(mid_st, a.feats + (long long)base * D, nt, D);
    {
      const int n0 = half * 32;
      product<4, 3, 3, false, true>(hi, lo, HB, mt, W1, n0, 4, 16, bh, bl);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = mt + g + 8 * h, c = n0 + 8 * j + 2 * tq;
          const uint32_t pos = positive2(BIG1, s, c);
          put2(BIG2, s, c, pos & 0xffffu ? hi[j][2 * h] + lo[j][2 * h] : 0.f,
               pos >> 16 ? hi[j][2 * h + 1] + lo[j][2 * h + 1] : 0.f, false);
        }
      if (wgrad) {
        if (w == 0) {
          product<1, 3, 3, true, true, true>(h1, l1, HB, 0, BIG1, 0, 1, kT, bh, bl);
          add_bias(bacc + kB1, 0, 16, bh, bl);
        } else {
          product<1, 3, 3, true, true>(h1, l1, HB, 0, BIG1, 8 * w, 1, kT, bh, bl);
        }
        aW1.add(h1, l1);
      }
    }
    staged();
    __syncthreads();
    // X (rounded where bf16) into BIG1, zeros on to Dp
    for (int i = threadIdx.x; i < kT * L.Dp; i += kThreads) {
      const int s = i / L.Dp, d = i - s * L.Dp;
      put_in(BIG1, s, d, d < D ? mid_st[s * D + d] : 0.f, rnd);
    }
    __syncthreads();
    // P5, base layer 1: the features' cotangent dX = dH1 W0^T (rounded where
    // bf16) out; dW0^T = dH1^T X and its bias column (warps 0-3)
    if (next < tiles) {
      stage(mid_st, a.saved + ((long long)next * kSaved + 144) * kT, 64 * kT);  // G2
      stage(mid_st + 64 * kT, a.saved + ((long long)next * kSaved + 64) * kT, kT);  // HS[0]
    }
    {
      const int n0 = half * 8 * ntd;
      if (a.g_feats) {
        product<NTD, 3, 3, false, true>(hd, ld, BIG2, mt, W0, n0, ntd, 64, bh, bl);
#pragma unroll
        for (int j = 0; j < NTD; ++j) {
          if (j >= ntd) break;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int s = mt + g + 8 * (q >> 1), c = n0 + 8 * j + 2 * tq + (q & 1);
            const float v = hd[j][q] + ld[j][q];
            if (c < D && s < nt) a.g_feats[(long long)(base + s) * D + c] = rnd ? bf16_round(v) : v;
          }
        }
      }
      if (wgrad) {
        if (half == 0) {
          product_b<NTD, true, true, true>(rnd, hd, ld, BIG2, mt, BIG1, n0, ntd, kT, bh, bl);
          add_bias(bacc + kB0, mt, 64, bh, bl);
        } else {
          product_b<NTD, true, true>(rnd, hd, ld, BIG2, mt, BIG1, n0, ntd, kT, bh, bl);
        }
        aW0.add(hd, ld);
      }
    }
  }
  staged();
  if (wgrad) {
    __syncthreads();
    float* part = a.partials + (long long)blockIdx.x * P.total;
    aV2.write(part + P.v2, 0, 8 * w, 1, 3, 64);
    aV1.write(part + P.v1, mt, half * 32, 4, 64, 64);
    aV0.write(part + P.v0, mt, half * 8 * ntc, ntc, 64, CIN);
    aW1.write(part + P.w1, 0, 8 * w, 1, 16, 64);
    aW0.write(part + P.w0, mt, half * 8 * ntd, ntd, 64, D);
    for (int i = threadIdx.x; i < 64; i += kThreads) {
      part[P.b0 + i] = bacc[kB0 + i];
      part[P.c0 + i] = bacc[kC0 + i];
      part[P.c1 + i] = bacc[kC1 + i];
    }
    if (threadIdx.x < 16) part[P.b1 + threadIdx.x] = bacc[kB1 + threadIdx.x];
    if (threadIdx.x < 3) part[P.c2 + threadIdx.x] = bacc[kC2 + threadIdx.x];
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
  return backward ? smem_of(D, color_in(E)).total : 4 * fwd_smem_of(D, color_in(E)).total;
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

// K9b in bf16 (the MLP inputs and their cotangents rounded) or f32
template <int DT, int ET>
int launch_bwd(const HeadArgs& a, int bytes, cudaStream_t stream) {
  if (a.bf16) return launch(head_bwd_kernel<DT, ET, true>, a, a.blocks, bytes, stream);
  return launch(head_bwd_kernel<DT, ET, false>, a, a.blocks, bytes, stream);
}

extern "C" int head_bwd(const HeadArgs* args, cudaStream_t stream) {
  const HeadArgs a = *args;
  if (a.n <= 0) return 0;
  const int E = a.codes ? a.E : 0, bytes = smem_bytes(a.D, E, true);
  int err;
  if (a.D == 32 && E == 32) err = launch_bwd<32, 32>(a, bytes, stream);
  else if (a.D == 32 && E == 0) err = launch_bwd<32, 0>(a, bytes, stream);
  else err = launch_bwd<0, -1>(a, bytes, stream);
  if (err != cudaSuccess) return err;
  const long long P = a.g_params ? params_of(a.D, color_in(E)).total : 0;
  const long long codes = a.g_codes && a.k > 1 ? (long long)a.m * a.E : 0;
  if (P + codes > 0)
    head_sum_kernel<<<(int)((P + codes + kThreads - 1) / kThreads), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
