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
// What bounds them on the card: bytes, at ~24-28 bytes a sample read once
// (density, rgb, t_starts, t_ends, mask; K5b also the cotangents a ray) and
// 12-16 written (K5b's gradients), far below any operation count; at these
// sizes (56K-197K samples) launch latency and a warp's short dependent
// chains dominate.
//
// Design: one warp a ray, a lane a sample (k <= 64: two halves of 32), so a
// ray's samples are read in one coalesced sweep. The exclusive cumulative
// sum of sigma*delta is a warp scan (__shfl_up_sync), without subtraction,
// so an inf density (a hardened surface) gives transmittance 0 after it and
// never inf - inf. The sums over samples (rgb, depth, accumulation) are
// warp reductions. K5b recomputes the forward per lane, then takes the
// suffix sum over later samples of w_j * dL/dw_j by a reverse warp scan:
//   dL/dsigma_i = delta_i * [exp(-s_i) * dL/dalpha_i - sum_{j>i} w_j dL/dw_j]
// for a sample kept and not culled (0 else), dL/dalpha_i = T_i dL/dw_i where
// early stop keeps it, and dL/drgb_i = w_i * dL/drgb (+ the last sample's
// share (1 - acc) * dL/drgb under the last_sample background). Every sum is
// in a fixed order: no atomics, the same bits from call to call.
// The culling threshold is a float, or a 0-dim device tensor
// (min(alpha_thre, occs.mean())) read through its pointer: no host sync.
// The C entries launch on the caller's stream, allocate nothing and return
// cudaGetLastError().

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
constexpr int kWarps = 4;  // rays a block, a warp each

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Per lane, its two samples j = lane and lane + 32 of ray i: the forward's
// quantities.
struct Lane {
  float s0[2];    // sigma * delta before culling
  float a[2];     // alpha after culling, before early stop
  float T[2];     // transmittance exp(-sum_{j'<j} s_j')
  float w[2];     // weight
  float delta[2], tmid[2];
  bool m[2], culled[2], live[2];
};

__device__ Lane forward_lane(const CompositeArgs& A, long i, int lane) {
  Lane L;
  const float thr = A.thr_ptr ? __ldg(A.thr_ptr) : A.thr;
  float s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    L.m[h] = false;
    L.delta[h] = L.tmid[h] = L.s0[h] = 0.f;
    if (j < A.k) {
      const long e = i * A.k + j;
      const float t0 = __ldg(A.t_starts + e), t1 = __ldg(A.t_ends + e);
      L.m[h] = A.mask[e] != 0;
      const float sigma = L.m[h] ? __ldg(A.density + e) : 0.f;
      L.delta[h] = L.m[h] ? __fsub_rn(t1, t0) : 0.f;
      L.s0[h] = __fmul_rn(sigma, L.delta[h]);
      L.tmid[h] = __fmul_rn(0.5f, __fadd_rn(t0, t1));
    }
    const float al = __fsub_rn(1.f, expf(-L.s0[h]));
    L.culled[h] = A.cull && al <= thr;
    s[h] = L.culled[h] ? 0.f : L.s0[h];
    L.a[h] = L.culled[h] ? 0.f : al;
  }
  // exclusive cumulative sum of s over the ray's samples, no subtraction
  float carry = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float c = s[h];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(kFull, c, o);
      if (lane >= o) c += y;
    }
    const float excl = __shfl_up_sync(kFull, c, 1);
    const float E = lane == 0 ? carry : carry + excl;
    carry += __shfl_sync(kFull, c, 31);
    L.T[h] = expf(-E);
    L.live[h] = A.eps <= 0.f || L.T[h] > A.eps;
    L.w[h] = (L.live[h] ? L.a[h] : 0.f) * L.T[h];
  }
  return L;
}

// The ray's background colour (bg_mode > 0) given its rgb row.
__device__ __forceinline__ void background(const CompositeArgs& A, long i, float bg[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (A.bg_mode == 1) bg[c] = __ldg(A.bg + i * 3 + c);
    else if (A.bg_mode == 3) bg[c] = 1.f;
    else if (A.bg_mode == 4) bg[c] = __ldg(A.rgb + (i * A.k + A.k - 1) * 3 + c);
    else bg[c] = 0.f;
  }
}

__global__ void __launch_bounds__(kWarps * 32) composite_fwd_kernel(const CompositeArgs A) {
  const int lane = threadIdx.x & 31;
  const long i = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= A.n) return;  // warp-uniform
  const Lane L = forward_lane(A, i, lane);
  float acc = 0.f, num = 0.f, col[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j < A.k) {
      const long e = i * A.k + j;
      acc += L.w[h];
      num += L.w[h] * L.tmid[h];
#pragma unroll
      for (int c = 0; c < 3; ++c) col[c] += L.w[h] * __ldg(A.rgb + e * 3 + c);
    }
  }
  acc = warp_sum(acc);
  num = warp_sum(num);
#pragma unroll
  for (int c = 0; c < 3; ++c) col[c] = warp_sum(col[c]);
  if (lane == 0) {
    float bg[3];
    background(A, i, bg);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      A.out_rgb[i * 3 + c] = A.bg_mode ? col[c] + bg[c] * (1.f - acc) : col[c];
    A.out_depth[i] = num / (acc + 1e-10f);
    A.out_acc[i] = acc;
  }
}

__global__ void __launch_bounds__(kWarps * 32) composite_bwd_kernel(const CompositeArgs A) {
  const int lane = threadIdx.x & 31;
  const long i = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= A.n) return;  // warp-uniform
  const Lane L = forward_lane(A, i, lane);
  float gr[3] = {0.f, 0.f, 0.f};
  if (A.g_rgb) {
#pragma unroll
    for (int c = 0; c < 3; ++c) gr[c] = __ldg(A.g_rgb + i * 3 + c);
  }
  const float gd = A.g_depth ? __ldg(A.g_depth + i) : 0.f;
  const float ga = A.g_acc ? __ldg(A.g_acc + i) : 0.f;
  float rgb[2][3];
  float acc = 0.f, num = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[h][c] = j < A.k ? __ldg(A.rgb + (i * A.k + j) * 3 + c) : 0.f;
    acc += L.w[h];
    num += L.w[h] * L.tmid[h];
  }
  acc = warp_sum(acc);
  num = warp_sum(num);
  // dL/dw_j = g_rgb . (rgb_j - bg) + g_acc + depth's terms
  float bg[3];
  background(A, i, bg);
  const float bgdot = A.bg_mode ? gr[0] * bg[0] + gr[1] * bg[1] + gr[2] * bg[2] : 0.f;
  const float den = acc + 1e-10f;
  const float dnum = gd / den;
  const float dden = -gd * num / (den * den);
  float G[2], q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    G[h] = gr[0] * rgb[h][0] + gr[1] * rgb[h][1] + gr[2] * rgb[h][2] - bgdot + ga + dden +
           L.tmid[h] * dnum;
    q[h] = G[h] * L.w[h];
  }
  // suffix sums over later samples of q: the second half first
  float later = 0.f;  // the sum of q over the halves after this one
  float after[2];
#pragma unroll
  for (int h = 1; h >= 0; --h) {
    float c = q[h];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_down_sync(kFull, c, o);
      if (lane + o < 32) c += y;
    }
    const float next = __shfl_down_sync(kFull, c, 1);
    after[h] = lane == 31 ? later : later + next;
    later += __shfl_sync(kFull, c, 0);
  }
  const long e0 = i * A.k;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    if (j >= A.k) continue;
    const float da = L.live[h] ? G[h] * L.T[h] : 0.f;
    const float ds = L.culled[h] ? 0.f : da * expf(-L.s0[h]) - after[h];
    A.d_density[e0 + j] = L.m[h] ? ds * L.delta[h] : 0.f;
    const float last = (A.bg_mode == 4 && j == A.k - 1) ? 1.f - acc : 0.f;
#pragma unroll
    for (int c = 0; c < 3; ++c) A.d_rgb[(e0 + j) * 3 + c] = L.w[h] * gr[c] + last * gr[c];
  }
}

int launch(void (*kernel)(CompositeArgs), const CompositeArgs* args, cudaStream_t stream) {
  const int blocks = (args->n + kWarps - 1) / kWarps;
  kernel<<<blocks, kWarps * 32, 0, stream>>>(*args);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int composite_fwd(const CompositeArgs* args, cudaStream_t stream) {
  return launch(composite_fwd_kernel, args, stream);
}

extern "C" int composite_bwd(const CompositeArgs* args, cudaStream_t stream) {
  return launch(composite_bwd_kernel, args, stream);
}
