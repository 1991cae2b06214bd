// Occupancy-skipping ray march for Hopper (sm_90a): K3 march_ts.
//
// K3 replaces the TPU-shaped march of
//   lsenerf_tpu/ops/march.py::march_rays (:298): the hierarchical branch
//   (:354-433) with packed_segment_lookup (:156), the flat branch
//   (:434-440), the one-hot stride compactions (:393-405, :466-478) and
//   proposal_resample (:216),
// whose supergrid is lsenerf_tpu/ops/occupancy.py::build_super_binaries
// (:171; the port builds it once a grid state, OccGridState.super_binaries).
// It computes what lsenerf_tpu_torch/ops/march.py::march_ts_plain computes:
// per ray (t_starts, t_ends, mask) of k slots, or of F slots with the
// proposal. Only the selection runs here; march_rays builds the positions
// from the differentiable origins and directions in torch.
//
// What bounds it on the card: latency, not bytes or operations. A ray reads
// 24 bytes and writes 9 a slot; its lookups are ~129 supergrid cells (16 KB
// in all, from L1), 192 fine cells (8 MiB bool grid, through L2) and 48
// EMA cells with the proposal (32 MiB f32 grid), each a dependent load
// after a chain of f32 arithmetic and a logf. The TPU compacted with
// one-hot matmuls; here a warp compacts its own ray.
//
// Design:
// - One warp a ray, a block 4 rays. A pass takes its candidates 32 at a
//   time, a candidate a lane; __ballot_sync gives the round's survivors and
//   a __popc of the lanes below gives each survivor's slot. A stride
//   compaction needs the ray's total count before it can select, so each
//   pass is two sweeps: the first keeps the rounds' ballots in shared
//   memory and counts; the second selects every stride-th survivor and
//   recomputes the t of the few it keeps (no per-candidate state is kept).
// - Phase 1 (hierarchical): the 129 segment boundaries against the
//   supergrid; a segment's far boundary comes from the next lane by
//   __shfl_down_sync (lane 31 computes its own). Phase 2: the 24 kept
//   segments x cf fine midpoints, whole segments to a round (32 / cf of
//   them), so that the packed rule's first and last midpoint of a segment
//   are lanes of the same round (__shfl_sync). Flat: the max_candidates
//   midpoints against the fine grid.
// - Proposal: a lane a slot (k <= 64: two halves), the EMA lookups, the
//   weight sum and the inverse CDF's cumulative sum in f64 by warp shuffles,
//   then a lane an output sample. With proposal_uniform_frac > 0 every
//   nonzero pdf entry is at least frac / k, so the f64 sums are exact and
//   any order gives the plain version's bits (march_ts_plain sums in f64).
// - Bits: the plain version runs as torch runs it on CUDA, and the kernel
//   repeats each operation's rounding: products and sums with __fmul_rn /
//   __fadd_rn (no contraction into FMAs), IEEE division (__fdiv_rn) and
//   reciprocal (__frcp_rn, torch's reciprocal and a scalar's __rtruediv__),
//   a tensor divided by a Python scalar as torch's CUDA kernel divides it
//   (a product with the scalar's f32 reciprocal, inv_step and inv_F),
//   log2 as logf(x) / f32(ln 2), (1+cone)^k as a double pow rounded once.
//   The selection is then the plain version's bits on the card.
// - The C entry launches on the caller's stream, allocates nothing and
//   returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// The march's inputs, outputs and scalars; lsenerf_tpu_torch/ops/march.py
// (_MarchArgs) mirrors this layout.
struct MarchArgs {
  const float* o;        // (n, 3)
  const float* d;        // (n, 3)
  const float* nears;    // (n,) or null
  const float* fars;     // (n,) or null
  const uint8_t* bin;    // (L, R, R, R) bool
  const uint8_t* sup;    // (L, S, S, S) bool, the supergrid (hierarchical)
  const float* occs;     // (L, R, R, R) f32 EMA (proposal)
  float* t_starts;       // (n, k) or (n, F)
  float* t_ends;
  uint8_t* mask;
  int n, levels, R, S;
  int hier, packed, cf, mc, k1, k, F;
  int geo;               // cone_angle > 0
  float aabb, inv_aabb, half, neg_half, near_plane, far_plane;
  float step, inv_step, t_crit, base;
  float lam, one_minus_lam, inv_F, F_f;
};

}  // extern "C"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;        // rays a block, a warp each
constexpr int kMaxRounds = 64;   // 32-candidate rounds a sweep
constexpr int kMaxSegs = 64;     // max_coarse_segments
constexpr int kMaxK = 64;        // max_samples
constexpr float kLn2 = 0.693147182464599609375f;  // float32(log(2))

struct Ray {
  float o[3], d[3];
  float t_lo, t_hi, n_lin, t_geo;
};

struct WarpSmem {
  uint32_t ballots[kMaxRounds];
  int segidx[kMaxSegs];
  float ts[kMaxK], te[kMaxK], dt[kMaxK], pdf[kMaxK], cdf[kMaxK];
};

// ts_at_indices: the boundary t of candidate index i.
__device__ __forceinline__ float ts_at(const MarchArgs& a, const Ray& r, float i) {
  if (!a.geo) return __fadd_rn(r.t_lo, __fmul_rn(i, a.step));
  if (i <= r.n_lin) return __fadd_rn(r.t_lo, __fmul_rn(fminf(i, r.n_lin), a.step));
  const float g = fmaxf(__fsub_rn(i, r.n_lin), 0.f);
  return __fmul_rn(r.t_geo, (float)pow((double)a.base, (double)g));
}

struct Cell {
  int lvl, x, y, z;
};

// occupancy.py::_cell_coords of the point at t on the ray, at resolution R.
__device__ __forceinline__ Cell cell_at(const MarchArgs& a, const Ray& r, float t, int R) {
  float p[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) p[c] = __fadd_rn(r.o[c], __fmul_rn(t, r.d[c]));
  const float mag = fmaxf(fmaxf(fabsf(p[0]), fabsf(p[1])), fabsf(p[2]));
  const float v = fmaxf(__fmul_rn(mag, a.inv_aabb), 1e-12f);
  const float l = fminf(fmaxf(ceilf(__fdiv_rn(logf(v), kLn2)), 0.f), (float)(a.levels - 1));
  const float half = __fmul_rn(a.aabb, exp2f(l));
  const float inv = __fmul_rn(__frcp_rn(__fmul_rn(2.f, half)), (float)R);
  int q[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    q[c] = (int)fminf(fmaxf(floorf(__fmul_rn(__fadd_rn(p[c], half), inv)), 0.f), (float)(R - 1));
  return Cell{(int)l, q[0], q[1], q[2]};
}

__device__ __forceinline__ long flat_index(const Cell& c, int R) {
  return (((long)c.lvl * R + c.x) * R + c.y) * R + c.z;
}

__device__ Ray setup_ray(const MarchArgs& a, int i) {
  Ray r;
  float tn = -INFINITY, tf = INFINITY;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = __ldg(a.o + 3 * i + c);
    r.d[c] = __ldg(a.d + 3 * i + c);
    const float dd = fabsf(r.d[c]) < 1e-10f ? 1e-10f : r.d[c];
    const float inv = __frcp_rn(dd);
    const float t0 = __fmul_rn(__fsub_rn(a.neg_half, r.o[c]), inv);
    const float t1 = __fmul_rn(__fsub_rn(a.half, r.o[c]), inv);
    tn = fmaxf(tn, fminf(t0, t1));
    tf = fminf(tf, fmaxf(t0, t1));
  }
  r.t_lo = fmaxf(fmaxf(tn, a.near_plane), 0.f);
  r.t_hi = fminf(tf, a.far_plane);
  if (a.nears) r.t_lo = fmaxf(r.t_lo, __ldg(a.nears + i));
  if (a.fars) r.t_hi = fminf(r.t_hi, __ldg(a.fars + i));
  r.n_lin = r.t_geo = 0.f;
  if (a.geo) {
    r.n_lin = ceilf(__fmul_rn(fmaxf(__fsub_rn(a.t_crit, r.t_lo), 0.f), a.inv_step));
    r.t_geo = __fadd_rn(r.t_lo, __fmul_rn(r.n_lin, a.step));
  }
  return r;
}

// A fine candidate of the final compaction: its t0 and its base width.
struct Cand {
  float t0, dts, mid;
};

// Phase-2 candidate `c` (slot c / cf, fine index c % cf of its segment).
__device__ __forceinline__ Cand hier_cand(const MarchArgs& a, const Ray& r, const WarpSmem& sm,
                                          int c, int nseg, int stride_c) {
  const int j = c / a.cf;
  const float seg = j < nseg ? (float)sm.segidx[j] : 0.f;
  const float fi = __fadd_rn(__fmul_rn(seg, (float)a.cf), (float)(c % a.cf));
  const float t0 = ts_at(a, r, fi), t1 = ts_at(a, r, __fadd_rn(fi, 1.f));
  return Cand{t0, __fmul_rn(__fsub_rn(t1, t0), (float)stride_c), __fmul_rn(0.5f, __fadd_rn(t0, t1))};
}

__device__ __forceinline__ Cand flat_cand(const MarchArgs& a, const Ray& r, int c) {
  const float t0 = ts_at(a, r, (float)c), t1 = ts_at(a, r, (float)(c + 1));
  return Cand{t0, __fsub_rn(t1, t0), __fmul_rn(0.5f, __fadd_rn(t0, t1))};
}

__global__ void __launch_bounds__(kWarps * 32) march_kernel(const MarchArgs a) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + w;
  if (i >= a.n) return;  // warp-uniform
  WarpSmem& sm = smem[w];
  const Ray r = setup_ray(a, i);
  const uint32_t below = (1u << lane) - 1u;

  // phase 1: segments of cf candidates against the supergrid
  int nseg = 0, stride_c = 1;
  if (a.hier) {
    const int rounds = (a.mc + 31) / 32;
    int count = 0;
    for (int rd = 0; rd < rounds; ++rd) {
      const int s = rd * 32 + lane;
      bool occ = false;
      float tc = 0.f;
      if (s <= a.mc) {
        tc = ts_at(a, r, (float)(s * a.cf));
        occ = __ldg(a.sup + flat_index(cell_at(a, r, tc, a.S), a.S)) != 0;
      }
      bool occ_next = __shfl_down_sync(kFull, (int)occ, 1) != 0;
      if (lane == 31 && s + 1 <= a.mc) {
        const float tn = ts_at(a, r, (float)((s + 1) * a.cf));
        occ_next = __ldg(a.sup + flat_index(cell_at(a, r, tn, a.S), a.S)) != 0;
      }
      const bool keep = s < a.mc && (occ || occ_next) && tc < r.t_hi;
      const uint32_t bal = __ballot_sync(kFull, keep);
      if (lane == 0) sm.ballots[rd] = bal;
      count += __popc(bal);
    }
    __syncwarp();
    stride_c = max(1, (count + a.k1 - 1) / a.k1);
    int base = 0;
    for (int rd = 0; rd < rounds; ++rd) {
      const uint32_t bal = sm.ballots[rd];
      const int slot = base + __popc(bal & below);
      if (((bal >> lane) & 1u) && slot % stride_c == 0) sm.segidx[slot / stride_c] = rd * 32 + lane;
      base += __popc(bal);
    }
    nseg = (count + stride_c - 1) / stride_c;
    __syncwarp();
  }

  // the fine candidates: phase 2's (whole segments a round) or the flat ones
  const int per_round = a.hier ? (32 / a.cf) * a.cf : 32;
  const int total = a.hier ? a.k1 * a.cf : a.mc;
  const int rounds = (total + per_round - 1) / per_round;
  int count = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    const int c = rd * per_round + lane;
    const bool active = lane < per_round && c < total;
    bool keep = false;
    if (a.hier) {
      const Cand cd = hier_cand(a, r, sm, active ? c : 0, nseg, stride_c);
      const Cell cl = cell_at(a, r, cd.mid, a.R);
      bool occ = __ldg(a.bin + flat_index(cl, a.R)) != 0;
      if (a.packed) {
        const int sup = ((cl.lvl * a.S + cl.x / a.cf) * a.S + cl.y / a.cf) * a.S + cl.z / a.cf;
        const int first = lane - lane % a.cf;
        const int s0 = __shfl_sync(kFull, sup, first);
        const int s1 = __shfl_sync(kFull, sup, first + a.cf - 1);
        occ = (sup == s0 || sup == s1) ? occ : true;
      }
      keep = active && c / a.cf < nseg && cd.mid < r.t_hi && occ;
    } else if (active) {
      const Cand cd = flat_cand(a, r, c);
      keep = __ldg(a.bin + flat_index(cell_at(a, r, cd.mid, a.R), a.R)) != 0 && cd.mid < r.t_hi;
    }
    const uint32_t bal = __ballot_sync(kFull, keep);
    if (lane == 0) sm.ballots[rd] = bal;
    count += __popc(bal);
  }
  __syncwarp();

  // stride compaction into k slots; the kept candidates' t recomputed
  const bool proposal = a.F > 0;
  const int k = a.k;
  const int stride = max(1, (count + k - 1) / k);
  const int nsel = (count + stride - 1) / stride;
  const long row = (long)i * k;
  int base = 0;
  for (int rd = 0; rd < rounds; ++rd) {
    const uint32_t bal = sm.ballots[rd];
    const int slot = base + __popc(bal & below);
    if (((bal >> lane) & 1u) && slot % stride == 0) {
      const int c = rd * per_round + lane;
      const Cand cd = a.hier ? hier_cand(a, r, sm, c, nseg, stride_c) : flat_cand(a, r, c);
      const float t1 = __fadd_rn(cd.t0, __fmul_rn(cd.dts, (float)stride));
      const int j = slot / stride;
      if (proposal) {
        sm.ts[j] = cd.t0;
        sm.te[j] = t1;
      } else {
        a.t_starts[row + j] = cd.t0;
        a.t_ends[row + j] = t1;
      }
    }
    base += __popc(bal);
  }
  for (int j = lane; j < k; j += 32) {
    if (j >= nsel) {
      if (proposal) {
        sm.ts[j] = sm.te[j] = 0.f;
      } else {
        a.t_starts[row + j] = a.t_ends[row + j] = 0.f;
      }
    }
    if (!proposal) a.mask[row + j] = j < nsel;
  }
  if (!proposal) return;
  __syncwarp();

  // proposal: inverse-CDF relocation of the k slots to F samples
  const float uni = nsel > 0 ? __fdiv_rn(1.f, (float)nsel) : 0.f;
  float wv[2];
  double wsum = 0.0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    wv[h] = 0.f;
    if (j < k) {
      const float ts = sm.ts[j], te = sm.te[j];
      const float dt = __fsub_rn(te, ts);
      sm.dt[j] = dt;
      if (j < nsel) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(ts, te));
        const float ema = __ldg(a.occs + flat_index(cell_at(a, r, mid, a.R), a.R));
        const float tau = __fmul_rn(__fmul_rn(ema, dt), a.inv_step);
        wv[h] = __fsub_rn(1.f, expf(-tau));
      }
    }
    wsum += (double)wv[h];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(kFull, wsum, o);
  const float ws = (float)wsum;
  double run = 0.0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    const float u = j < nsel ? uni : 0.f;
    float p = u;
    if (ws > 1e-12f)
      p = __fadd_rn(__fdiv_rn(__fmul_rn(a.one_minus_lam, wv[h]), fmaxf(ws, 1e-12f)),
                    __fmul_rn(a.lam, u));
    if (j >= k) p = 0.f;
    double c = (double)p;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double y = __shfl_up_sync(kFull, c, o);
      if (lane >= o) c += y;
    }
    c += run;
    run = __shfl_sync(kFull, c, 31);
    if (j < k) {
      sm.pdf[j] = p;
      sm.cdf[j] = (float)c;
    }
  }
  __syncwarp();
  const bool valid = nsel > 0;
  const long orow = (long)i * a.F;
  for (int f = lane; f < a.F; f += 32) {
    const float u = __fmul_rn(__fadd_rn((float)f, 0.5f), a.inv_F);
    int idx = 0;
    for (int j = 0; j < k; ++j) idx += u > sm.cdf[j];
    idx = min(idx, k - 1);
    const float t0 = sm.ts[idx], dt = sm.dt[idx], p = sm.pdf[idx];
    const float prev = idx > 0 ? sm.cdf[idx - 1] : 0.f;
    const float frac = fminf(fmaxf(__fdiv_rn(__fsub_rn(u, prev), fmaxf(p, 1e-12f)), 0.f), 1.f);
    const float tc = __fadd_rn(t0, __fmul_rn(frac, dt));
    float dtf = __fdiv_rn(dt, fmaxf(__fmul_rn(p, a.F_f), 1e-12f));
    if (!valid) dtf = 0.f;
    const float hw = __fmul_rn(0.5f, dtf);
    a.t_starts[orow + f] = __fsub_rn(tc, hw);
    a.t_ends[orow + f] = __fadd_rn(tc, hw);
    a.mask[orow + f] = valid;
  }
}

}  // namespace

extern "C" int march_ts(const MarchArgs* args, cudaStream_t stream) {
  const MarchArgs a = *args;
  const int blocks = (a.n + kWarps - 1) / kWarps;
  march_kernel<<<blocks, kWarps * 32, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
