// Volume-rendering composite for Hopper (sm_90a): forward (K5a) and
// backward (K5b).
//
// K5a composite_fwd replaces the TPU-shaped chain of
//   lsenerf_tpu/ops/composite.py::render_weights (:29), accumulate (:78),
//   render_rgb (:83), render_depth (:117) and render_accumulation (:127):
// per ray the masked inf-safe alpha, alpha culling, the shifted exclusive
// transmittance, early stop, then rgb (with its background), depth and
// accumulation. K5b composite_bwd is its backward, which JAX leaves to
// autodiff through the chain: the gradients to density and rgb, given the
// cotangents of the three outputs. Their plain versions are
// lsenerf_tpu_torch/ops/composite.py::composite_fwd_plain (the chain) and
// composite_bwd_plain (the same backward written out in torch).
//
// What bounds them on the card: bytes, at ~25 bytes a sample read once
// (density, rgb, t_starts, t_ends, mask; K5b also the cotangents a ray) and
// 16 written (K5b's gradients), far below any operation count. At the main
// path's sizes (56K-197K samples) a launch moves 1.4-4.9 MB, 0.4-1.5 us at
// the H100 SXM's 3.35 TB/s, so much of a call's time is the launch itself,
// and each dependent memory round trip and shuffle chain of a warp adds to
// it (PERF.md: the time above an empty kernel's on the same grid).
//
// Design:
// - W lanes a ray, S consecutive samples a lane, 32 / W rays a warp; (W, S)
//   is picked from k at launch (dispatch: k = 16 gives W = 8, S = 2, four
//   rays a warp; k = 48 W = 16, S = 3), so that no lane idles at the
//   flagship's k and no scan runs on padding.
// - Every load first: a lane issues its S densities, t_starts, t_ends and
//   mask bytes, its 3 S colours as one contiguous run (float2 / float4 and
//   a 16- or 32-bit mask word where k is a multiple of S and the pointers
//   are aligned), the ray's background row and, in K5b, the cotangents,
//   before any shuffle: one memory latency a ray, not one a round. Under
//   the last_sample background the lane holding sample k - 1 hands its
//   colour over by shuffle.
// - The exclusive cumulative sum of sigma * delta: each lane sums its S
//   samples serially, in sample order, then a segmented warp scan
//   (__shfl_up_sync of width W, log2 W steps) gives the lanes before it,
//   and the lane walks its samples adding one at a time. No subtraction
//   anywhere, so an inf density (a hardened surface) gives transmittance 0
//   after it and never inf - inf. The five sums (acc, depth numerator, rgb)
//   are per-lane serial sums and xor reductions of width W.
// - Any k: past 128 samples (W = 32, S = 4) a ray is walked in tiles of 128,
//   the forward carrying its prefix from tile to tile. K5b then makes two
//   passes: the forward over the tiles for acc and the depth numerator,
//   keeping each tile's carry in per-warp shared memory sized at launch,
//   then the tiles in reverse, each forward recomputed from its carry, with
//   the suffix sum of w * dL/dw carried from tile to tile.
// - K5b's gradients: a lane's own stores of its S samples would land S words
//   apart, each store touching up to 3 S times the sectors it fills, so the
//   lanes stage their runs in the warp's shared memory and the warp stores
//   its rays' one contiguous run a word a lane.
// - Each sum and product is the plain version's operation (__fadd_rn,
//   __fmul_rn, __fdiv_rn: no FMA contraction), in its order where a ray's
//   terms meet (dL/dw, the background's blend), so only the sums over a
//   ray's samples differ from it in order.
// - K5b: with T_i the transmittance, dL/dsigma_i =
//   delta_i * [exp(-s_i) * dL/dalpha_i - sum_{j>i} w_j dL/dw_j] for a
//   sample kept and not culled (0 else), dL/dalpha_i = T_i dL/dw_i where
//   early stop keeps it, and dL/drgb_i = w_i * dL/drgb (+ the last sample's
//   share (1 - acc) * dL/drgb under the last_sample background). The suffix
//   sum is per-lane serial sums and a reverse segmented scan
//   (__shfl_down_sync of width W).
// - Every sum in a fixed order, no atomics: the same bits from call to
//   call. The culling threshold is a float, or a 0-dim device tensor
//   (min(alpha_thre, occs.mean())) read through its pointer: no host sync.
// - The C entries launch on the caller's stream, allocate nothing and
//   return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// lsenerf_tpu_torch/ops/composite.py (_CompositeArgs) mirrors this layout.
struct CompositeArgs {
  const float* density;   // (n, k)
  const float* rgb;       // (n, k, 3)
  const float* t_starts;  // (n, k)
  const float* t_ends;
  const uint8_t* mask;    // (n, k) bool
  const float* bg;        // (n, 3) the random background's colours, or null
  const float* thr_ptr;   // 0-dim culling threshold, or null (then thr)
  const float* g_rgb;     // K5b: (n, 3) cotangents, each null for zeros
  const float* g_depth;   // (n,)
  const float* g_acc;     // (n,)
  float* out_rgb;         // K5a: (n, 3)
  float* out_depth;       // (n,)
  float* out_acc;         // (n,)
  float* d_density;       // K5b: (n, k)
  float* d_rgb;           // (n, k, 3)
  int n, k;
  int cull;               // 0: no culling
  int bg_mode;            // 0 none, 1 bg colours, 2 black, 3 white, 4 last sample
  float thr, eps;         // culling threshold, early_stop_eps (<= 0: off)
};

}  // extern "C"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;     // warps a block
constexpr int kTileW = 32;    // the tiled layout: a warp a ray,
constexpr int kTileS = 4;     // 4 samples a lane, 128 a tile

// The width of a lane's vector loads: S floats as S / V loads of V.
template <int S>
constexpr int kVec = S % 4 == 0 ? 4 : S % 2 == 0 ? 2 : 1;

// One lane's S samples of a tile: what the forward leaves for the sums and
// the backward.
template <int S>
struct Tile {
  float w[S];       // weight
  float T[S];       // transmittance exp(-sum_{j'<j} s_j')
  float e0[S];      // exp(-sigma * delta) before culling
  float delta[S], tmid[S];
  float rgb[S][3];
  bool m[S], culled[S], live[S];
};

// The ray a lane serves: its index, its lane within the ray, whether the
// ray exists, whether its runs take vector loads, and the warp's first ray
// and its count of rays that exist.
struct Ray {
  long i, first;
  int lr, rays;
  bool ok, vec;
};

template <int W>
__device__ __forceinline__ float ray_sum(float x) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o, W));
  return x;
}

// n consecutive floats from q into v, as vector loads of V (q aligned).
template <int V, int N>
__device__ __forceinline__ void load_vec(const float* q, float v[N]) {
#pragma unroll
  for (int u = 0; u < N / V; ++u) {
    if constexpr (V == 4) {
      const float4 x = __ldg(reinterpret_cast<const float4*>(q) + u);
      v[4 * u] = x.x, v[4 * u + 1] = x.y, v[4 * u + 2] = x.z, v[4 * u + 3] = x.w;
    } else if constexpr (V == 2) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(q) + u);
      v[2 * u] = x.x, v[2 * u + 1] = x.y;
    } else {
      v[u] = __ldg(q + u);
    }
  }
}

// The lane's run of S samples from element e of a (n, k) array, C values a
// sample (those before the ray's end, `left` of them; 0 past it): vector
// loads where the run is whole and aligned.
template <int S, int C>
__device__ __forceinline__ void load_run(const float* p, long e, int left, bool vec,
                                         float v[C * S]) {
  const float* q = p + C * e;
  if (vec && left >= S) {
    load_vec<kVec<S>, C * S>(q, v);
    return;
  }
#pragma unroll
  for (int u = 0; u < C * S; ++u) v[u] = u < C * left ? __ldg(q + u) : 0.f;
}

template <int S>
__device__ __forceinline__ void load_mask(const uint8_t* p, long e, int left, bool vec, bool m[S]) {
  constexpr int V = kVec<S>;
  if (V > 1 && vec && left >= S) {
#pragma unroll
    for (int u = 0; u < S / V; ++u) {
      uint32_t x;
      if constexpr (V == 4) x = __ldg(reinterpret_cast<const unsigned int*>(p + e) + u);
      else x = __ldg(reinterpret_cast<const unsigned short*>(p + e) + u);
#pragma unroll
      for (int b = 0; b < V; ++b) m[V * u + b] = ((x >> (8 * b)) & 0xffu) != 0;
    }
    return;
  }
#pragma unroll
  for (int s = 0; s < S; ++s) m[s] = s < left && p[e + s] != 0;
}

// The forward of tile t of the ray for this lane's S samples, given the
// sum of s over the ray's earlier tiles (carry). Returns the sum through
// this tile, the same in every lane of the ray.
template <int W, int S>
__device__ __forceinline__ float tile_forward(const CompositeArgs& A, const Ray& R, int t,
                                              float carry, float thr, Tile<S>& L) {
  const int j0 = t * W * S + R.lr * S;
  const int left = R.ok ? A.k - j0 : 0;  // samples of the run before the ray's end
  const long e = R.i * A.k + j0;
  float dens[S], t0[S], t1[S], rgb[3 * S];
  load_run<S, 1>(A.density, e, left, R.vec, dens);
  load_run<S, 1>(A.t_starts, e, left, R.vec, t0);
  load_run<S, 1>(A.t_ends, e, left, R.vec, t1);
  load_mask<S>(A.mask, e, left, R.vec, L.m);
  load_run<S, 3>(A.rgb, e, left, R.vec, rgb);
  float sv[S], a[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) L.rgb[s][c] = rgb[3 * s + c];
    const float sigma = L.m[s] ? dens[s] : 0.f;
    L.delta[s] = L.m[s] ? __fsub_rn(t1[s], t0[s]) : 0.f;
    const float s0 = __fmul_rn(sigma, L.delta[s]);
    L.tmid[s] = __fmul_rn(0.5f, __fadd_rn(t0[s], t1[s]));
    L.e0[s] = expf(-s0);
    const float al = __fsub_rn(1.f, L.e0[s]);
    L.culled[s] = A.cull && al <= thr;
    sv[s] = L.culled[s] ? 0.f : s0;
    a[s] = L.culled[s] ? 0.f : al;
  }
  float tot = sv[0];
#pragma unroll
  for (int s = 1; s < S; ++s) tot = __fadd_rn(tot, sv[s]);
  // the lanes' totals, summed over the ray's lanes up to this one
  float c = tot;
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const float y = __shfl_up_sync(kFull, c, o, W);
    if (R.lr >= o) c = __fadd_rn(c, y);
  }
  const float before = __shfl_up_sync(kFull, c, 1, W);
  float E = R.lr == 0 ? carry : __fadd_rn(carry, before);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    L.T[s] = expf(-E);
    L.live[s] = A.eps <= 0.f || L.T[s] > A.eps;
    L.w[s] = __fmul_rn(L.live[s] ? a[s] : 0.f, L.T[s]);
    E = __fadd_rn(E, sv[s]);
  }
  return __fadd_rn(carry, __shfl_sync(kFull, c, W - 1, W));
}

// Colour c3 of this lane's sample s (s uniform over the warp).
template <int S>
__device__ __forceinline__ float pick(const Tile<S>& L, int s, int c3) {
  float v = L.rgb[0][c3];
#pragma unroll
  for (int u = 1; u < S; ++u)
    if (u == s) v = L.rgb[u][c3];
  return v;
}

// The ray this lane serves; false where the whole warp has no ray.
template <int W, int S>
__device__ __forceinline__ bool locate(const CompositeArgs& A, Ray& R) {
  const int lane = threadIdx.x & 31;
  R.first = ((long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / W);
  if (R.first >= A.n) return false;  // warp-uniform
  const long rest = A.n - R.first;
  R.rays = rest < 32 / W ? (int)rest : 32 / W;
  R.i = R.first + lane / W;
  R.lr = lane & (W - 1);
  R.ok = R.i < A.n;
  constexpr int V = kVec<S>;
  const uintptr_t f = (uintptr_t)A.density | (uintptr_t)A.t_starts | (uintptr_t)A.t_ends |
                      (uintptr_t)A.rgb;
  R.vec = V > 1 && A.k % S == 0 && f % (4 * V) == 0 && (uintptr_t)A.mask % V == 0;
  return true;
}

// The background colour of a ray, bg_mode 1-3 (4: taken from the last sample).
__device__ __forceinline__ void fixed_background(const CompositeArgs& A, const Ray& R, float bg[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    bg[c] = (A.bg_mode == 1 && R.ok) ? __ldg(A.bg + R.i * 3 + c) : A.bg_mode == 3 ? 1.f : 0.f;
}

// Under the last_sample background, the colour of sample k - 1 from the
// lane that holds it, where tile t holds it.
template <int W, int S>
__device__ __forceinline__ void last_colour(const CompositeArgs& A, const Tile<S>& L, int t, float bg[3]) {
  const int last = A.k - 1;
  if (A.bg_mode != 4 || last < 0 || last / (W * S) != t) return;  // warp-uniform
  const int owner = (last % (W * S)) / S, s = last % S;
#pragma unroll
  for (int c = 0; c < 3; ++c) bg[c] = __shfl_sync(kFull, pick<S>(L, s, c), owner, W);
}

template <int W, int S, bool Tiled>
__global__ void __launch_bounds__(kWarps * 32) composite_fwd_kernel(const CompositeArgs A) {
  Ray R;
  if (!locate<W, S>(A, R)) return;
  const float thr = A.thr_ptr ? __ldg(A.thr_ptr) : A.thr;
  float bg[3];
  fixed_background(A, R, bg);
  const int tiles = Tiled ? (A.k + W * S - 1) / (W * S) : 1;
  float acc = 0.f, num = 0.f, col[3] = {0.f, 0.f, 0.f}, carry = 0.f;
  for (int t = 0; t < tiles; ++t) {
    Tile<S> L;
    carry = tile_forward<W, S>(A, R, t, carry, thr, L);
    last_colour<W, S>(A, L, t, bg);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc = __fadd_rn(acc, L.w[s]);
      num = __fadd_rn(num, __fmul_rn(L.w[s], L.tmid[s]));
#pragma unroll
      for (int c = 0; c < 3; ++c) col[c] = __fadd_rn(col[c], __fmul_rn(L.w[s], L.rgb[s][c]));
    }
  }
  acc = ray_sum<W>(acc);
  num = ray_sum<W>(num);
#pragma unroll
  for (int c = 0; c < 3; ++c) col[c] = ray_sum<W>(col[c]);
  if (R.ok && R.lr == 0) {
    // the plain version's operations in its order: comp + bg * (1 - acc)
    const float miss = __fsub_rn(1.f, acc);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      A.out_rgb[R.i * 3 + c] = A.bg_mode ? __fadd_rn(col[c], __fmul_rn(bg[c], miss)) : col[c];
    A.out_depth[R.i] = __fdiv_rn(num, __fadd_rn(acc, 1e-10f));
    A.out_acc[R.i] = acc;
  }
}

// The ray's terms of dL/dw_j = g_rgb . rgb_j + g_acc + t_mid_j * dnum - dden
// - g_rgb . bg, each an operation of the plain version in its order.
struct Grad {
  float gr[3], ga, dnum, dden, bgdot, miss;
};

// K5b's work on one tile, given the ray's terms: the gradients of this
// lane's samples, staged in the warp's scratch (stage: 32 S floats of
// d density, then 96 S of d rgb) and stored by the warp as one run, with
// `later` the sum of w * dL/dw over the ray's later tiles. Returns that sum
// through this tile.
template <int W, int S>
__device__ __forceinline__ float tile_backward(const CompositeArgs& A, const Ray& R, int t,
                                               const Tile<S>& L, float later, const Grad& D,
                                               float* stage) {
  float G[S], q[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float dot = __fadd_rn(__fadd_rn(__fmul_rn(D.gr[0], L.rgb[s][0]),
                                          __fmul_rn(D.gr[1], L.rgb[s][1])),
                                __fmul_rn(D.gr[2], L.rgb[s][2]));
    float g = __fsub_rn(__fadd_rn(__fadd_rn(dot, D.ga), __fmul_rn(L.tmid[s], D.dnum)), D.dden);
    if (A.bg_mode) g = __fsub_rn(g, D.bgdot);
    G[s] = g;
    q[s] = __fmul_rn(L.w[s], g);
  }
  float tot = q[S - 1];
#pragma unroll
  for (int s = S - 2; s >= 0; --s) tot = __fadd_rn(tot, q[s]);
  // the lanes' totals, summed over this lane and the ray's lanes after it
  float c = tot;
#pragma unroll
  for (int o = 1; o < W; o <<= 1) {
    const float y = __shfl_down_sync(kFull, c, o, W);
    if (R.lr + o < W) c = __fadd_rn(c, y);
  }
  const float next = __shfl_down_sync(kFull, c, 1, W);
  float after = R.lr == W - 1 ? later : __fadd_rn(later, next);
  const int j0 = t * W * S + R.lr * S;
  float dd[S], dr[3 * S];
#pragma unroll
  for (int s = S - 1; s >= 0; --s) {
    const float da = L.live[s] ? __fmul_rn(G[s], L.T[s]) : 0.f;
    const float ds = L.culled[s] ? 0.f : __fsub_rn(__fmul_rn(da, L.e0[s]), after);
    dd[s] = L.m[s] ? __fmul_rn(ds, L.delta[s]) : 0.f;
    const bool last = A.bg_mode == 4 && j0 + s == A.k - 1;
#pragma unroll
    for (int c3 = 0; c3 < 3; ++c3) {
      const float d = __fmul_rn(L.w[s], D.gr[c3]);
      dr[3 * s + c3] = last ? __fadd_rn(d, __fmul_rn(D.miss, D.gr[c3])) : d;
    }
    after = __fadd_rn(after, q[s]);
  }
  // a lane's run as its own stores would be S words 4 S bytes apart, each
  // store touching up to 3 S times the sectors it fills: the lanes stage
  // their runs and the warp stores its rays' one run (its tile of its one
  // ray where tiled, else its rays whole) a word a lane
  const int kt = min(W * S, A.k - t * W * S);  // the ray's samples in this tile
  const int base = (threadIdx.x & 31) / W * kt + R.lr * S;  // in the warp's run
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (R.ok && R.lr * S + s < kt) {
      stage[base + s] = dd[s];
#pragma unroll
      for (int c3 = 0; c3 < 3; ++c3) stage[32 * S + 3 * (base + s) + c3] = dr[3 * s + c3];
    }
  }
  __syncwarp();
  const long e = R.first * A.k + t * W * S;
  const int count = R.rays * kt;
  const int lane = threadIdx.x & 31;
  for (int u = lane; u < count; u += 32) A.d_density[e + u] = stage[u];
  for (int u = lane; u < 3 * count; u += 32) A.d_rgb[3 * e + u] = stage[32 * S + u];
  __syncwarp();
  return __fadd_rn(later, __shfl_sync(kFull, c, 0, W));
}

template <int W, int S, bool Tiled>
__global__ void __launch_bounds__(kWarps * 32) composite_bwd_kernel(const CompositeArgs A) {
  __shared__ float stages[kWarps][128 * S];  // a warp's gradients before they are stored
  extern __shared__ float carries[];         // tiled: a ray's carry into each tile
  Ray R;
  if (!locate<W, S>(A, R)) return;
  // every per-ray load first: the cotangents, the threshold, the background
  Grad D;
#pragma unroll
  for (int c = 0; c < 3; ++c) D.gr[c] = A.g_rgb && R.ok ? __ldg(A.g_rgb + R.i * 3 + c) : 0.f;
  const float gd = A.g_depth && R.ok ? __ldg(A.g_depth + R.i) : 0.f;
  D.ga = A.g_acc && R.ok ? __ldg(A.g_acc + R.i) : 0.f;
  const float thr = A.thr_ptr ? __ldg(A.thr_ptr) : A.thr;
  float bg[3];
  fixed_background(A, R, bg);
  const int tiles = Tiled ? (A.k + W * S - 1) / (W * S) : 1;
  float* mine = carries + (threadIdx.x >> 5) * tiles;  // tiled: a warp a ray
  Tile<S> L;
  float acc = 0.f, num = 0.f, carry = 0.f;
  for (int t = 0; t < tiles; ++t) {
    if (Tiled && R.lr == 0) mine[t] = carry;
    carry = tile_forward<W, S>(A, R, t, carry, thr, L);
    last_colour<W, S>(A, L, t, bg);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      acc = __fadd_rn(acc, L.w[s]);
      num = __fadd_rn(num, __fmul_rn(L.w[s], L.tmid[s]));
    }
  }
  acc = ray_sum<W>(acc);
  num = ray_sum<W>(num);
  const float den = __fadd_rn(acc, 1e-10f);
  D.dnum = __fdiv_rn(gd, den);
  D.dden = __fdiv_rn(__fmul_rn(gd, num), __fmul_rn(den, den));
  D.bgdot = __fadd_rn(__fadd_rn(__fmul_rn(D.gr[0], bg[0]), __fmul_rn(D.gr[1], bg[1])),
                      __fmul_rn(D.gr[2], bg[2]));
  D.miss = __fsub_rn(1.f, acc);
  if (Tiled) __syncwarp();
  float* stage = stages[threadIdx.x >> 5];
  float later = 0.f;
  for (int t = tiles - 1; t >= 0; --t) {
    if (Tiled) tile_forward<W, S>(A, R, t, mine[t], thr, L);
    later = tile_backward<W, S>(A, R, t, L, later, D, stage);
  }
}

// The (W, S) layout of a ray of k samples; past 128 samples the tiled one.
// At the main path's k = 16 and 48 these were the fastest on the H100 of
// the layouts tried (W = 4, 8, 16 and S = 2 to 8; PERF.md, K5's redesign).
template <template <int, int, bool> class Launch>
int dispatch(const CompositeArgs& A, cudaStream_t stream) {
  const int k = A.k;
  if (k <= 8) return Launch<8, 1, false>::run(A, stream);
  if (k <= 16) return Launch<8, 2, false>::run(A, stream);
  if (k <= 32) return Launch<16, 2, false>::run(A, stream);
  if (k <= 48) return Launch<16, 3, false>::run(A, stream);
  if (k <= 64) return Launch<16, 4, false>::run(A, stream);
  if (k <= kTileW * kTileS) return Launch<kTileW, kTileS, false>::run(A, stream);
  return Launch<kTileW, kTileS, true>::run(A, stream);
}

int blocks(const CompositeArgs& A, int W) {
  const long rays = (long)kWarps * (32 / W);
  return (int)((A.n + rays - 1) / rays);
}

template <int W, int S, bool Tiled>
struct Fwd {
  static int run(const CompositeArgs& A, cudaStream_t stream) {
    composite_fwd_kernel<W, S, Tiled><<<blocks(A, W), kWarps * 32, 0, stream>>>(A);
    return (int)cudaGetLastError();
  }
};

template <int W, int S, bool Tiled>
struct Bwd {
  static int run(const CompositeArgs& A, cudaStream_t stream) {
    size_t smem = 0;
    if (Tiled) {
      const int tiles = (A.k + W * S - 1) / (W * S);
      smem = sizeof(float) * kWarps * tiles;
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(composite_bwd_kernel<W, S, Tiled>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     (int)smem);
        if (err != cudaSuccess) return (int)err;
      }
    }
    composite_bwd_kernel<W, S, Tiled><<<blocks(A, W), kWarps * 32, smem, stream>>>(A);
    return (int)cudaGetLastError();
  }
};

template <int W, int S, bool Tiled>
struct Blocks {
  static int run(const CompositeArgs& A, cudaStream_t) { return blocks(A, W); }
};

__global__ void empty_kernel() {}

}  // namespace

extern "C" int composite_fwd(const CompositeArgs* args, cudaStream_t stream) {
  return dispatch<Fwd>(*args, stream);
}

extern "C" int composite_bwd(const CompositeArgs* args, cudaStream_t stream) {
  return dispatch<Bwd>(*args, stream);
}

// For timing only, on no path: the blocks of kWarps * 32 threads that K5a
// and K5b launch for these arguments, and an empty kernel on such a grid
// (the launch floor their device time is read against).
extern "C" int composite_blocks(const CompositeArgs* args) {
  return dispatch<Blocks>(*args, nullptr);
}

extern "C" int composite_empty(int blocks, int threads, cudaStream_t stream) {
  empty_kernel<<<blocks, threads, 0, stream>>>();
  return (int)cudaGetLastError();
}
