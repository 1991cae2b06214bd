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
// What bounds it on the card: latency and issue, not bytes. A ray reads 24
// bytes and writes 9 a slot; its lookups are ~129 supergrid cells (16 KB in
// all, from L1), up to 192 fine cells (8 MiB bool grid, through L2) and 48
// EMA cells with the proposal (32 MiB f32 grid), each a load behind a chain
// of ~40 f32 operations with a logf, an IEEE division and a reciprocal. A
// train step's 3512 rays are ~27 warps an SM at a warp a ray: one ray's
// chain alone takes ~14 us on the H100, and the step's rays ~23 us. The TPU
// compacted with one-hot matmuls; here a warp compacts its own ray.
//
// Design:
// - One warp a ray, a block 4 rays. A sweep takes its candidates 32 at a
//   time (a round), a candidate a lane; __ballot_sync gives the round's
//   survivors and a __popc of the lanes below gives each survivor's slot. A
//   stride compaction needs the ray's total count before it can select, so
//   each pass counts first (the rounds' ballots kept in shared memory) and
//   selects every stride-th survivor after; strides that are powers of two
//   divide by shifts.
// - The cone-angle schedule's (1+cone)^g, g = 0..max_candidates, is a table
//   the wrapper builds with the plain version's own expression (march.py
//   growth_table) and passes by pointer; a boundary's t is one read of it
//   through L1 and one product, where the first design took an f64 pow
//   (~70% of the boundaries at a train step lie in that branch).
// - A sweep takes one round at a time: its lookups, then its ballot. At
//   3512-4096 rays the SM's ~27 warps hide the loads; 2, 4 or 8 rounds'
//   lookups in flight together cost registers and measured slower on the
//   H100 (PERF.md, K3's redesign).
//   The selecting pass recomputes a selected candidate's t from the table.
// - Phase 1 (hierarchical) looks each of the mc + 1 segment boundaries up
//   once against the supergrid. A segment is kept where either of its
//   boundaries is occupied: the keep word of a round is its occupancy word
//   OR'd with itself shifted down a bit and the next word's first bit. t
//   grows with the index, so rounds past t_hi are not looked up.
// - Phase 2 sweeps the kept segments x cf fine midpoints, whole segments to
//   a round (32 / cf of them), so that the packed rule's first and last
//   midpoint of a segment are lanes of the same round (__shfl_sync); only
//   the rounds that hold kept segments run. A segment wider than a warp (cf
//   > 32, the kernels' Long instances, chosen once a launch) spans rounds:
//   the kept segments' candidates lie end to end, 32 a round, and lanes 0-3
//   look up the first and last midpoint of the round's (at most two)
//   segments with cand_at's arithmetic, shuffled to the lanes for the
//   packed rule. Flat: the max_candidates midpoints against the fine grid.
// - Proposal: a lane a slot (k <= 64: two halves), both halves' EMA loads
//   together, the weight sum and the inverse CDF's cumulative sum in f64 by
//   warp shuffles; with proposal_uniform_frac > 0 every nonzero pdf entry is
//   at least frac / k, so the f64 sums are exact and any order gives the
//   plain version's bits (march_ts_plain sums in f64). Each output sample's
//   bin is the count of CDF entries below its quantile: two ballots over the
//   lanes' entries, the same comparisons as the plain version's.
// - Scratch: a warp's arrays (phase 1's words, the ballots, the kept
//   segments, the k slots, the proposal's pdf and CDF) are static shared
//   memory sized for 64 slots, 64 coarse segments and 64 rounds, which
//   every preset fits. A config past them (MarchArgs.wide, set by the
//   wrapper) runs the same code on the arrays at its own sizes (wide_words),
//   its proposal a lane a slot in rounds of 32, in dynamic shared memory up
//   to a block's 227 KB, and past it (MarchArgs.wide 2) in a global-memory
//   workspace of the wrapper's, wide_words a ray; so any max_samples,
//   max_coarse_segments, max_candidates and coarse_factor run, as in the
//   JAX package.
// - Bits: the plain version runs as torch runs it on CUDA, and the kernel
//   repeats each operation's rounding: products and sums with __fmul_rn /
//   __fadd_rn (no contraction into FMAs), IEEE division (__fdiv_rn) and
//   reciprocal (__frcp_rn, torch's reciprocal and a scalar's __rtruediv__),
//   a tensor divided by a Python scalar as torch's CUDA kernel divides it
//   (a product with the scalar's f32 reciprocal, inv_step and inv_F),
//   log2 as logf(x) / f32(ln 2); (1+cone)^g is the plain version's own
//   tensor. The selection is then the plain version's bits on the card.
// - The C entry launches on the caller's stream, allocates nothing and
//   returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// The march's inputs, outputs and scalars; lsenerf_tpu_torch/ops/march.py
// (_MarchArgs) mirrors this layout. New fields go at the end, so that an
// earlier build of this file reads a valid prefix.
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
  const float* growth;   // (max_candidates + 1,) f32 (1+cone)^g (geo only)
  int wide;              // 0: the static per-warp layout; wide_words' layout in dynamic
                         // shared memory (1) or in the global workspace (2)
  uint32_t* scratch;     // wide 2: the global workspace, n x wide_words words
};

}  // extern "C"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;        // rays a block, a warp each
// the static layout's capacities (every preset; ops/march.py STATIC_*)
constexpr int kMaxRounds = 64;   // 32-candidate rounds a sweep
constexpr int kMaxSegs = 64;     // max_coarse_segments
constexpr int kMaxK = 64;        // max_samples
constexpr float kLn2 = 0.693147182464599609375f;  // float32(log(2))

struct Ray {
  float o[3], d[3];
  float t_lo, t_hi, n_lin, t_geo;
};

// A warp's scratch, static: sized at compile time for every config within
// kMaxRounds, kMaxSegs and kMaxK.
struct WarpSmem {
  uint32_t occ[kMaxRounds + 2];  // phase 1: the boundaries' supergrid bits, a word a round
  uint32_t lt[kMaxRounds + 2];   // phase 1: boundary t < t_hi
  uint32_t ballots[kMaxRounds];  // the fine sweep's survivors
  int segidx[kMaxSegs];
  float ts[kMaxK], te[kMaxK], dt[kMaxK], pdf[kMaxK], cdf[kMaxK];
};

// A warp's scratch, wide: the same arrays at the launch's sizes, in dynamic
// shared memory or the global workspace (configs past the static
// capacities), and the proposal's bin of each output sample.
struct WarpPtrs {
  uint32_t *occ, *lt, *ballots;
  int *segidx, *idx;
  float *ts, *te, *dt, *pdf, *cdf;
};

// The wide layout's 32-bit words a warp (ops/march.py wide_words computes
// the same), its arrays carved from base where given.
__host__ __device__ inline int wide_words(const MarchArgs& a, uint32_t* base, WarpPtrs* p) {
  const int r1 = a.hier ? (a.mc + 32) / 32 : 0;  // phase 1's rounds of mc + 1 boundaries
  // the fine sweep's rounds: whole segments a round (32 / cf of them), end
  // to end where a segment is wider than a warp, or flat
  const int rounds = !a.hier ? (a.mc + 31) / 32
                     : a.cf > 32 ? (a.k1 * a.cf + 31) / 32
                                 : (a.k1 + 32 / a.cf - 1) / (32 / a.cf);
  const int sizes[10] = {r1 + 1, r1, rounds, a.hier ? a.k1 : 0, a.F, a.k, a.k, a.k, a.k, a.k};
  int words = 0;
  uint32_t* at[10];
  for (int u = 0; u < 10; ++u) {
    at[u] = base ? base + words : nullptr;
    words += sizes[u];
  }
  if (p) {
    *p = WarpPtrs{at[0], at[1], at[2], (int*)at[3], (int*)at[4], (float*)at[5], (float*)at[6],
                  (float*)at[7], (float*)at[8], (float*)at[9]};
  }
  return words;
}

// x / d and x % d for x >= 0: shifts where d is a power of two.
struct Div {
  int d, sh;
  bool pow2;
  __device__ __forceinline__ int div(int x) const { return pow2 ? x >> sh : x / d; }
  __device__ __forceinline__ int mod(int x) const { return pow2 ? x & (d - 1) : x % d; }
};

__device__ __forceinline__ Div make_div(int d) { return Div{d, __popc(d - 1), (d & (d - 1)) == 0}; }

// ts_at_indices: the boundary t of candidate index i (0 <= i <= max_candidates).
__device__ __forceinline__ float ts_at(const MarchArgs& a, const Ray& r, int idx) {
  const float i = (float)idx;
  if (!a.geo || i <= r.n_lin) return __fadd_rn(r.t_lo, __fmul_rn(i, a.step));
  return __fmul_rn(r.t_geo, __ldg(a.growth + (int)fmaxf(__fsub_rn(i, r.n_lin), 0.f)));
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

// The packed rule's key of a fine cell: its supercell's index.
__device__ __forceinline__ int super_index(const MarchArgs& a, const Cell& c, const Div& cf) {
  return ((c.lvl * a.S + cf.div(c.x)) * a.S + cf.div(c.y)) * a.S + cf.div(c.z);
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

// A fine candidate: its t0, its base width (widened by the coarse stride),
// its midpoint, and whether it lies in a kept segment (or the flat range).
struct Cand {
  float t0, dts, mid;
  bool on;
};

// Round rd's candidate of this lane: phase 2's (candidate c of slot c / cf,
// fine index c % cf of its segment; per_round is 32 where segments are wider
// than a warp) or the flat march's c.
template <typename Sm>
__device__ __forceinline__ Cand cand_at(const MarchArgs& a, const Ray& r, const Sm& sm, const Div& cf, int rd, int lane,
                                        int per_round, int nseg, int stride_c) {
  int fi;
  bool on;
  if (a.hier) {
    const int c = rd * per_round + lane;
    const int j = cf.div(c);
    on = lane < per_round && j < nseg;
    fi = (on ? sm.segidx[j] : 0) * a.cf + cf.mod(c);
  } else {
    fi = rd * 32 + lane;
    on = fi < a.mc;
    fi = on ? fi : 0;
  }
  const float t0 = ts_at(a, r, fi), t1 = ts_at(a, r, fi + 1);
  return Cand{t0, __fmul_rn(__fsub_rn(t1, t0), (float)stride_c),
              __fmul_rn(0.5f, __fadd_rn(t0, t1)), on};
}

// The proposal within the static layout (k <= 64): a lane a slot, two
// halves; both halves' EMA cells first, then both loads.
__device__ __forceinline__ void static_proposal(const MarchArgs& a, const Ray& r, WarpSmem& sm,
                                                int i, int lane, int nsel, float uni) {
  const int k = a.k;
  float dtv[2], ema[2];
  long cell[2];
  bool look[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = lane + 32 * h;
    dtv[h] = 0.f;
    look[h] = false;
    cell[h] = 0;
    if (j < k) {
      const float ts = sm.ts[j], te = sm.te[j];
      dtv[h] = __fsub_rn(te, ts);
      sm.dt[j] = dtv[h];
      if (j < nsel) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(ts, te));
        cell[h] = flat_index(cell_at(a, r, mid, a.R), a.R);
        look[h] = true;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) ema[h] = look[h] ? __ldg(a.occs + cell[h]) : 0.f;
  float wv[2];
  double wsum = 0.0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    wv[h] = 0.f;
    if (look[h]) {
      const float tau = __fmul_rn(__fmul_rn(ema[h], dtv[h]), a.inv_step);
      wv[h] = __fsub_rn(1.f, expf(-tau));
    }
    wsum += (double)wv[h];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(kFull, wsum, o);
  const float ws = (float)wsum;
  double run = 0.0;
  float cdfr[2];  // this lane's CDF entries; +inf past k (never below a quantile)
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
    cdfr[h] = INFINITY;
    if (j < k) {
      sm.pdf[j] = p;
      sm.cdf[j] = cdfr[h] = (float)c;
    }
  }
  __syncwarp();
  // each output's bin: the CDF entries below its quantile, counted by ballots
  int idx[2] = {0, 0};
  for (int f = 0; f < a.F; ++f) {
    const float u = __fmul_rn(__fadd_rn((float)f, 0.5f), a.inv_F);
    const int below_u = __popc(__ballot_sync(kFull, u > cdfr[0])) +
                        __popc(__ballot_sync(kFull, u > cdfr[1]));
    if (lane == (f & 31)) {
      if (f < 32) idx[0] = min(below_u, k - 1);
      else idx[1] = min(below_u, k - 1);
    }
  }
  const bool valid = nsel > 0;
  const long orow = (long)i * a.F;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = lane + 32 * h;
    if (f < a.F) {
      const int id = idx[h];
      const float u = __fmul_rn(__fadd_rn((float)f, 0.5f), a.inv_F);
      const float t0 = sm.ts[id], dt = sm.dt[id], p = sm.pdf[id];
      const float prev = id > 0 ? sm.cdf[id - 1] : 0.f;
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
}

// The proposal at any k and F (the wide layout): the static one's
// arithmetic, a lane a slot in rounds of 32, with the slots' widths,
// weights, pdf and CDF and each output sample's bin in shared memory.
__device__ void wide_proposal(const MarchArgs& a, const Ray& r, const WarpPtrs& sm, int i,
                              int lane, int nsel, float uni) {
  const int k = a.k;
  const int rounds = (k + 31) / 32;
  double wsum = 0.0;
  for (int h = 0; h < rounds; ++h) {
    const int j = lane + 32 * h;
    float wv = 0.f;
    if (j < k) {
      const float ts = sm.ts[j], te = sm.te[j];
      const float dtv = __fsub_rn(te, ts);
      sm.dt[j] = dtv;
      if (j < nsel) {
        const float mid = __fmul_rn(0.5f, __fadd_rn(ts, te));
        const float ema = __ldg(a.occs + flat_index(cell_at(a, r, mid, a.R), a.R));
        const float tau = __fmul_rn(__fmul_rn(ema, dtv), a.inv_step);
        wv = __fsub_rn(1.f, expf(-tau));
      }
      sm.pdf[j] = wv;  // the weight, until the pdf takes its place
    }
    wsum += (double)wv;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) wsum += __shfl_xor_sync(kFull, wsum, o);
  const float ws = (float)wsum;
  double run = 0.0;
  for (int h = 0; h < rounds; ++h) {
    const int j = lane + 32 * h;
    const float u = j < nsel ? uni : 0.f;
    float p = u;
    if (ws > 1e-12f)
      p = __fadd_rn(__fdiv_rn(__fmul_rn(a.one_minus_lam, j < k ? sm.pdf[j] : 0.f),
                              fmaxf(ws, 1e-12f)),
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
  // each output's bin: the CDF entries below its quantile, counted by
  // ballots. The CDF does not fall (its f64 sums are exact) and the
  // quantiles rise, so the count stops at the first round not wholly below
  // u, and the next quantile's resumes there (the rounds before it lie
  // below u too).
  int h0 = 0;
  for (int f = 0; f < a.F; ++f) {
    const float u = __fmul_rn(__fadd_rn((float)f, 0.5f), a.inv_F);
    int below_u = 32 * h0;
    for (int h = h0; h < rounds; ++h) {
      const int j = lane + 32 * h;
      const uint32_t bal = __ballot_sync(kFull, j < k && u > sm.cdf[j]);
      below_u += __popc(bal);
      if (bal != kFull) {
        h0 = h;
        break;
      }
    }
    if (lane == 0) sm.idx[f] = min(below_u, k - 1);
  }
  __syncwarp();
  const bool valid = nsel > 0;
  const long orow = (long)i * a.F;
  for (int f = lane; f < a.F; f += 32) {
    const int id = sm.idx[f];
    const float u = __fmul_rn(__fadd_rn((float)f, 0.5f), a.inv_F);
    const float t0 = sm.ts[id], dt = sm.dt[id], p = sm.pdf[id];
    const float prev = id > 0 ? sm.cdf[id - 1] : 0.f;
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

// Ray i's march by one warp, with its scratch sm (a WarpSmem, or WarpPtrs
// where Wide); Long: hierarchical with segments wider than a warp.
template <bool Wide, bool Long, typename Sm>
__device__ __forceinline__ void march_ray(const MarchArgs& a, Sm& sm, int i, int lane) {
  const Ray r = setup_ray(a, i);
  const uint32_t below = (1u << lane) - 1u;
  const Div cf = make_div(a.cf);

  // phase 1: the mc + 1 segment boundaries against the supergrid. t grows
  // with the index (step > 0), so a round whose first boundary follows one
  // at or past t_hi holds no kept segment's boundary: it is not looked up.
  int nseg = 0, stride_c = 1;
  if (a.hier) {
    const int nb = a.mc + 1;
    const int r1 = (nb + 31) / 32;
    bool past = false;  // a boundary of an earlier round lies at or past t_hi
    for (int rd = 0; rd < r1; ++rd) {
      const int s = rd * 32 + lane;
      const float tc = s < nb ? ts_at(a, r, s * a.cf) : INFINITY;
      const uint32_t lw = __ballot_sync(kFull, tc < r.t_hi);
      uint8_t v = 0;
      if (!past && s < nb) v = __ldg(a.sup + flat_index(cell_at(a, r, tc, a.S), a.S));
      const uint32_t occ = __ballot_sync(kFull, v != 0);
      if (lane == 0) {
        sm.occ[rd] = occ;
        sm.lt[rd] = lw;
      }
      past = past || (a.step > 0.f && !(lw >> 31));
    }
    if (lane == 0) sm.occ[r1] = 0u;
    __syncwarp();
    // segment s = rd * 32 + b (s < mc) is kept where boundary s or s + 1 is
    // occupied and boundary s lies before t_hi
    const int rs = (a.mc + 31) / 32;
    auto keep_word = [&](int rd) {
      const int left = a.mc - rd * 32;
      const uint32_t valid = left >= 32 ? kFull : (1u << left) - 1u;
      const uint32_t occ = sm.occ[rd];
      return (occ | (occ >> 1) | (sm.occ[rd + 1] << 31)) & sm.lt[rd] & valid;
    };
    int count = 0;
    for (int rd = 0; rd < rs; ++rd) count += __popc(keep_word(rd));
    stride_c = max(1, (count + a.k1 - 1) / a.k1);
    const Div sc = make_div(stride_c);
    int base = 0;
    for (int rd = 0; rd < rs; ++rd) {
      const uint32_t bal = keep_word(rd);
      const int slot = base + __popc(bal & below);
      if (((bal >> lane) & 1u) && sc.mod(slot) == 0) sm.segidx[sc.div(slot)] = rd * 32 + lane;
      base += __popc(bal);
    }
    nseg = (count + stride_c - 1) / stride_c;
    __syncwarp();
  }

  // the fine candidates: phase 2's (whole segments a round, or end to end
  // where a segment is wider than a warp; the rounds that hold kept
  // segments) or the flat ones
  const int per_round = a.hier && !Long ? (32 / a.cf) * a.cf : 32;
  const int used = !a.hier ? (a.mc + 31) / 32
                   : Long ? (nseg * a.cf + 31) / 32 : (nseg + 32 / a.cf - 1) / (32 / a.cf);
  int count = 0;
  for (int rd = 0; rd < used; ++rd) {
    const Cand cd = cand_at(a, r, sm, cf, rd, lane, per_round, nseg, stride_c);
    const Cell cl = cell_at(a, r, cd.mid, a.R);
    bool ends = true;
    if (a.packed) {
      const int sup = super_index(a, cl, cf);
      int s0, s1;
      if constexpr (Long) {
        // the round's 32 candidates lie in at most two segments (cf > 32):
        // lanes 0-3 take the first and last midpoint of each, as cand_at
        // computes them
        const int jlo = cf.div(rd * 32);
        const int q = jlo + (lane >> 1);
        int v = 0;
        if (lane < 4 && q < nseg) {
          const int fi = sm.segidx[q] * a.cf + ((lane & 1) ? a.cf - 1 : 0);
          const float t0 = ts_at(a, r, fi), t1 = ts_at(a, r, fi + 1);
          v = super_index(a, cell_at(a, r, __fmul_rn(0.5f, __fadd_rn(t0, t1)), a.R), cf);
        }
        const int src = 2 * (cf.div(rd * 32 + lane) - jlo);
        s0 = __shfl_sync(kFull, v, src);
        s1 = __shfl_sync(kFull, v, src + 1);
      } else {
        const int first = lane - cf.mod(lane);
        s0 = __shfl_sync(kFull, sup, first);
        s1 = __shfl_sync(kFull, sup, first + a.cf - 1);
      }
      ends = sup == s0 || sup == s1;
    }
    // a segment's inner midpoint in a third supercell reads as occupied
    // under the packed rule
    bool kept = false;
    if (cd.on && cd.mid < r.t_hi) kept = !ends || __ldg(a.bin + flat_index(cl, a.R)) != 0;
    const uint32_t bal = __ballot_sync(kFull, kept);
    if (lane == 0) sm.ballots[rd] = bal;
    count += __popc(bal);
  }
  __syncwarp();

  // stride compaction into k slots (shared memory), then the rows
  const bool proposal = a.F > 0;
  const int k = a.k;
  const int stride = max(1, (count + k - 1) / k);
  const int nsel = (count + stride - 1) / stride;
  const Div sd = make_div(stride);
  int base = 0;
  for (int rd = 0; rd < used; ++rd) {
    const uint32_t bal = sm.ballots[rd];
    const int slot = base + __popc(bal & below);
    if (((bal >> lane) & 1u) && sd.mod(slot) == 0) {
      const Cand cd = cand_at(a, r, sm, cf, rd, lane, per_round, nseg, stride_c);
      const int j = sd.div(slot);
      sm.ts[j] = cd.t0;
      sm.te[j] = __fadd_rn(cd.t0, __fmul_rn(cd.dts, (float)stride));
    }
    base += __popc(bal);
  }
  for (int j = nsel + lane; j < k; j += 32) sm.ts[j] = sm.te[j] = 0.f;
  __syncwarp();
  if (!proposal) {
    const long row = (long)i * k;
    for (int j = lane; j < k; j += 32) {
      a.t_starts[row + j] = sm.ts[j];
      a.t_ends[row + j] = sm.te[j];
      a.mask[row + j] = j < nsel;
    }
    return;
  }

  // proposal: inverse-CDF relocation of the k slots to F samples
  const float uni = nsel > 0 ? __fdiv_rn(1.f, (float)nsel) : 0.f;
  if constexpr (Wide) wide_proposal(a, r, sm, i, lane, nsel, uni);
  else static_proposal(a, r, sm, i, lane, nsel, uni);
}

template <bool Long>
__global__ void __launch_bounds__(kWarps * 32) march_kernel(const MarchArgs a) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + w;
  if (i >= a.n) return;  // warp-uniform
  march_ray<false, Long>(a, smem[w], i, lane);
}

// The wide layout: a warp's arrays in dynamic shared memory, or (Global) in
// ray i's wide_words of the global workspace.
template <bool Long, bool Global>
__global__ void __launch_bounds__(kWarps * 32) march_wide_kernel(const MarchArgs a) {
  extern __shared__ uint32_t dyn[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + w;
  if (i >= a.n) return;  // warp-uniform
  const int words = wide_words(a, nullptr, nullptr);
  WarpPtrs sm;
  wide_words(a, Global ? a.scratch + (long)i * words : dyn + w * words, &sm);
  march_ray<true, Long>(a, sm, i, lane);
}

template <typename Kernel>
int launch(Kernel kernel, const MarchArgs& a, int bytes, cudaStream_t stream) {
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(a.n + kWarps - 1) / kWarps, kWarps * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The layout (MarchArgs.wide) and whether segments are wider than a warp
// pick the kernel, once a launch.
extern "C" int march_ts(const MarchArgs* args, cudaStream_t stream) {
  const MarchArgs a = *args;
  const bool lng = a.hier && a.cf > 32;
  if (!a.wide) return launch(lng ? march_kernel<true> : march_kernel<false>, a, 0, stream);
  if (a.wide == 2)
    return launch(lng ? march_wide_kernel<true, true> : march_wide_kernel<false, true>, a, 0,
                  stream);
  return launch(lng ? march_wide_kernel<true, false> : march_wide_kernel<false, false>, a,
                kWarps * 4 * wide_words(a, nullptr, nullptr), stream);
}
