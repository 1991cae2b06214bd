// The camera rays of a train step for Hopper (sm_90a): forward (K8a) and
// backward (K8b).
//
// K8a rays_fwd makes every ray of a step's bundles (the RGB rays, under
// deblur 4 a pixel, and the prev and next event rays) in one launch,
// straight into the concatenated bundle: each ray's pose from its bundle's
// source (the continuous-time spline, the event spline through the
// RGB-to-event extrinsic dM, a camera's SO3xR3 or SE3 delta on its fixed
// pose, or the fixed pose alone), then generate_rays' origin, normalised
// direction and pixel_area, the camera index (or, for the event rays, the
// nearest RGB time's), the time and the appearance id. K8b rays_bwd is its
// backward: each ray's vector-Jacobian product from the cotangents of
// origins, directions and pixel_area back to its pose source's leaves (the
// two knots' tangents and the scale of the spline, a camera's delta row),
// summed into each leaf's gradient.
// Their plain version is the composition of torch ops it replaces
// (lsenerf_tpu_torch/ops/bundles.py: part_plain): cameras/pose_opt.py's
// spline and deltas, ops/interp.py's slerp and searchsorted, ops/lie.py's
// exponential and quaternion maps, cameras/cameras.py::generate_rays and
// apply_correction_to_bundle, interp.find_closest_idxs and the
// concatenation: some 330 small kernels forward and 410 backward.
//
// What bounds them on the card: nothing but the launch. A step has ~3,500
// rays; a ray reads ~100 bytes (its index row, two knots or a delta row,
// its camera's time) and writes 40, and does a few hundred f32 operations
// (two exp maps, a slerp, three normalised directions).
//
// Design:
// - A thread a ray, 128 a block, one grid for all bundles of the step; a
//   ray finds its bundle among at most MAX_PARTS by its index. The
//   arguments are one struct passed by value (__grid_constant__), which a
//   CUDA graph captures with the launch.
// - K8b recomputes each ray's forward from the same inputs (nothing is
//   saved between the two), then the adjoint chain written out below.
// - No atomics: K8b is two launches. The first writes each ray's gated
//   terms and its key (the spline segment or the camera); the second has a
//   block a row of each leaf's gradient, whose threads walk the rays of
//   the parts that add into the leaf in a fixed stride and sum them in a
//   fixed tree, writing every row (no zero-fill). So the gradients are the
//   same bits at every call, as the plain version's sort-based index
//   backward was (a replayed graph equals its eager steps where only the
//   cameras train); only the order of the f32 sums into a knot or a
//   camera differs from the plain version's.
// - The delayed-activation gate is a float, or a 0-dim device tensor read
//   through its pointer (a replayed graph's gate): the forward uses the
//   plain version's gate * p + (1 - gate) * p for the spline and p * gate
//   for the deltas; the gradients are scaled by the gate.
// - The deblur exposure times are the plain version's f32 operations with
//   no FMA contraction (__fsub_rn, __fadd_rn, __fmul_rn), so the segment a
//   time falls in is the plain version's.
// - The C entries launch on the caller's stream, allocate nothing and
//   return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

extern "C" {

// lsenerf_tpu_torch/ops/bundles.py (_Part, _RaysArgs) mirrors these layouts.
struct Part {
  const long long* idx;   // rows: (pixels, 3) [camera, y, x]; else (pixels,) cameras
  const float* coords;    // rows == 0: (pixels, 2) [y, x]
  const float* dist;      // (6,) k1 k2 k3 k4 p1 p2, or null
  const float* c2w;       // FIXED and deltas: (cameras, 3, 4); PER_RAY: a pose a ray
  const float* times;     // (cameras,) or null
  const float* gate_ptr;  // 0-dim gate, or null (then gate)
  const float* table;     // deltas: (cameras, 6); splines: the (m, 6) knot tangents
  float* table_grad;      // K8b: non-null where table's gradient is wanted
  const long long* app;   // (pixels,) appearance ids, or null
  float fx, fy, cx, cy;
  float gate;
  int n;                  // rays
  int offset;             // the first ray's row in the outputs
  int rep;                // rays a pixel (4 under deblur)
  int pose;               // FIXED, PER_RAY, SPLINE, SPLINE_EVS, SO3XR3, SE3
  int cam_offset;         // added to the pixel's camera index
  int rows;               // idx holds (camera, y, x) rows
  int c2w_stride;         // PER_RAY: floats from one ray's pose to the next
  int app_deblur;         // appearance id + (ray in pixel) - 2, clamped
  int snap;               // camera index <- the nearest RGB time's
};

#define MAX_PARTS 4

// a leaf's gradient that K8b writes whole: the delta table or the knots'
// tangents the parts in `parts` (a bit a part) add into
struct Target {
  float* grad;            // (rows, 6)
  int rows;
  int parts;
  int first;              // its first block in K8b's second pass
  int pad;
};

struct RaysArgs {
  Part parts[MAX_PARTS];
  Target targets[MAX_PARTS];
  const float* ctrl_ts;   // (m,) knot times
  const float* dM;        // (4, 4) RGB -> event extrinsic
  const float* scale;     // (1,) dM's baseline factor
  float* scale_grad;      // K8b: its gradient (written whole), or null
  const float* rgb_ts;    // (n_rgb,) sorted RGB times (snap)
  float* origins;         // (n, 3)
  float* dirs;            // (n, 3)
  float* area;            // (n, 1)
  int* cam_out;           // (n, 1)
  float* times_out;       // (n, 1), or null
  long long* app_out;     // (n,), or null
  const float* g_origins; // K8b: cotangents, each null for zeros
  const float* g_dirs;
  const float* g_area;
  float* terms;           // K8b: (n, 12) each ray's gated terms
  float* sterms;          // (n,) each ray's scale term
  int* keys;              // (n,) each ray's segment or camera, -1 for none
  float exp_half;         // the exposure's half, f32
  float exp_delta;        // the exposure's step between a pixel's rays, f32
  int m;
  int n_rgb;
  int num_embd;
  int num_parts;
  int n;
  int num_targets;
  int sum_blocks;         // K8b's second pass: the targets' rows, + 1 for the scale
};

}  // extern "C"

namespace {

enum { FIXED = 0, PER_RAY = 1, SPLINE = 2, SPLINE_EVS = 3, SO3XR3 = 4, SE3 = 5 };

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
// the slerp's clamp of its dot product, (-1 + EPS, 1 - EPS) as f32
constexpr float kDotLo = (float)(-1.0 + 1e-6);
constexpr float kDotHi = (float)(1.0 - 1e-6);

__device__ __forceinline__ float gate_of(const Part& p) {
  return p.gate_ptr ? *p.gate_ptr : p.gate;
}

// gate * x + (1 - gate) * x, as pose_opt._gate_params computes its value
__device__ __forceinline__ float gated(float x, float g) {
  return __fadd_rn(__fmul_rn(g, x), __fmul_rn(__fsub_rn(1.f, g), x));
}

__device__ __forceinline__ int part_of(const RaysArgs& a, int r) {
  int k = 0;
  for (int j = 1; j < a.num_parts; ++j)
    if (r >= a.parts[j].offset) k = j;
  return k;
}

// the ray's pixel and place in it, its camera and pixel coordinates
struct RayIn {
  int pix, sub, cam;
  float x, y;
};

__device__ __forceinline__ RayIn ray_in(const Part& p, int i) {
  RayIn q;
  q.pix = i / p.rep;
  q.sub = i - q.pix * p.rep;
  if (p.rows) {
    const long long* row = p.idx + 3 * (long long)q.pix;
    q.cam = (int)row[0];
    q.y = (float)row[1];
    q.x = (float)row[2];
  } else {
    q.cam = (int)p.idx[q.pix];
    q.y = p.coords[2 * q.pix];
    q.x = p.coords[2 * q.pix + 1];
  }
  q.cam += p.cam_offset;
  return q;
}

// -- the spline -----------------------------------------------------------------

// a knot: its gated translation and log-rotation, the rotation's angle and
// quaternion [w, x, y, z] (lie.exp_map_to_quat: the identity at angle 0)
struct Knot {
  float t[3], v[3], th, q[4];
};

__device__ void knot_fwd(const float* tan, float g, Knot& k) {
  for (int c = 0; c < 3; ++c) {
    k.t[c] = gated(tan[c], g);
    k.v[c] = gated(tan[3 + c], g);
  }
  k.th = sqrtf(k.v[0] * k.v[0] + k.v[1] * k.v[1] + k.v[2] * k.v[2]);
  const bool valid = k.th > 0.f;
  const float safe = valid ? k.th : 1.f;
  const float h = k.th * 0.5f;
  k.q[0] = cosf(h);
  const float sh = sinf(h);
  for (int c = 0; c < 3; ++c) k.q[1 + c] = valid ? (k.v[c] / safe) * sh : 0.f;
}

// d quaternion -> d log-rotation; zero at angle 0 (the norm's gradient there)
__device__ void knot_bwd(const Knot& k, const float gq[4], float gv[3]) {
  if (!(k.th > 0.f)) {
    gv[0] = gv[1] = gv[2] = 0.f;
    return;
  }
  const float inv = 1.f / k.th, h = 0.5f * k.th, sh = sinf(h), ch = cosf(h);
  float gn[3], gsh = 0.f, gnv = 0.f;
  for (int c = 0; c < 3; ++c) {
    gn[c] = gq[1 + c] * sh;
    gsh += gq[1 + c] * (k.v[c] * inv);
    gnv += gn[c] * k.v[c];
  }
  // w = cos(th / 2), sh = sin(th / 2), and th as the divisor of n = v / th
  const float gth = -0.5f * gq[0] * sh + 0.5f * gsh * ch - gnv * inv * inv;
  for (int c = 0; c < 3; ++c) gv[c] = gn[c] * inv + gth * k.v[c] * inv;
}

// interp.slerp of two knots' quaternions at fraction s
struct Slerp {
  float v0n[4], v1p[4], v1n[4], n0, n1, draw, dot, th0, sin0raw, sin0, s0, s1;
  bool neg, near;
};

__device__ void slerp_fwd(const float q0[4], const float q1[4], float s, Slerp& st,
                          float rot[4]) {
  st.n0 = sqrtf(q0[0] * q0[0] + q0[1] * q0[1] + q0[2] * q0[2] + q0[3] * q0[3]);
  st.n1 = sqrtf(q1[0] * q1[0] + q1[1] * q1[1] + q1[2] * q1[2] + q1[3] * q1[3]);
  st.draw = 0.f;
  for (int c = 0; c < 4; ++c) {
    st.v0n[c] = q0[c] / st.n0;
    st.v1p[c] = q1[c] / st.n1;
    st.draw += st.v0n[c] * st.v1p[c];
  }
  float dot = isnan(st.draw) ? st.draw : fminf(fmaxf(st.draw, kDotLo), kDotHi);
  st.neg = dot < 0.f;
  for (int c = 0; c < 4; ++c) st.v1n[c] = st.neg ? -st.v1p[c] : st.v1p[c];
  st.dot = dot = st.neg ? -dot : dot;
  st.near = isnan(dot) || fabsf(dot) > 0.9995f;
  if (st.near) {
    for (int c = 0; c < 4; ++c) rot[c] = (1.f - s) * st.v0n[c] + s * st.v1n[c];
    return;
  }
  st.th0 = acosf(dot);
  const float tht = st.th0 * s;
  st.sin0raw = sinf(st.th0);
  st.sin0 = st.sin0raw == 0.f ? 1.f : st.sin0raw;
  st.s0 = sinf(st.th0 - tht) / st.sin0;
  st.s1 = sinf(tht) / st.sin0;
  for (int c = 0; c < 4; ++c) rot[c] = st.s0 * st.v0n[c] + st.s1 * st.v1n[c];
}

__device__ void slerp_bwd(const Slerp& st, float s, const float grot[4], float gq0[4],
                          float gq1[4]) {
  float g0[4], g1[4], gdot = 0.f;
  if (st.near) {
    for (int c = 0; c < 4; ++c) {
      g0[c] = (1.f - s) * grot[c];
      g1[c] = s * grot[c];
    }
  } else {
    float gs0 = 0.f, gs1 = 0.f;
    for (int c = 0; c < 4; ++c) {
      gs0 += grot[c] * st.v0n[c];
      gs1 += grot[c] * st.v1n[c];
      g0[c] = st.s0 * grot[c];
      g1[c] = st.s1 * grot[c];
    }
    const float tht = st.th0 * s, a = st.th0 - tht;
    const float ga = gs0 * cosf(a) / st.sin0;
    const float gtht = gs1 * cosf(tht) / st.sin0 - ga;
    const float gsin0 = st.sin0raw == 0.f ? 0.f : -(gs0 * st.s0 + gs1 * st.s1) / st.sin0;
    const float gth0 = ga + gtht * s + gsin0 * cosf(st.th0);
    gdot = -gth0 / sqrtf(1.f - st.dot * st.dot);
  }
  // the sign flip of the shorter path, then the clamp (passes inside its bounds)
  if (st.neg) {
    gdot = -gdot;
    for (int c = 0; c < 4; ++c) g1[c] = -g1[c];
  }
  const float gdraw = (st.draw >= kDotLo && st.draw <= kDotHi) ? gdot : 0.f;
  float d0 = 0.f, d1 = 0.f;
  for (int c = 0; c < 4; ++c) {
    g0[c] += gdraw * st.v1p[c];
    g1[c] += gdraw * st.v0n[c];
    d0 += st.v0n[c] * g0[c];
    d1 += st.v1p[c] * g1[c];
  }
  for (int c = 0; c < 4; ++c) {
    gq0[c] = (g0[c] - st.v0n[c] * d0) / st.n0;
    gq1[c] = (g1[c] - st.v1p[c] * d1) / st.n1;
  }
}

// lie.quat_to_rot_mat, row-major, without renormalising
__device__ void quat_to_rot(const float q[4], float R[9]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.f - 2.f * (y * y + z * z);
  R[1] = 2.f * (x * y - w * z);
  R[2] = 2.f * (x * z + w * y);
  R[3] = 2.f * (x * y + w * z);
  R[4] = 1.f - 2.f * (x * x + z * z);
  R[5] = 2.f * (y * z - w * x);
  R[6] = 2.f * (x * z - w * y);
  R[7] = 2.f * (y * z + w * x);
  R[8] = 1.f - 2.f * (x * x + y * y);
}

__device__ void quat_to_rot_bwd(const float q[4], const float g[9], float gq[4]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  gq[0] = 2.f * (-z * g[1] + y * g[2] + z * g[3] - x * g[5] - y * g[6] + x * g[7]);
  gq[1] = 2.f * (y * g[1] + z * g[2] + y * g[3] - 2.f * x * g[4] - w * g[5] + z * g[6] +
                 w * g[7] - 2.f * x * g[8]);
  gq[2] = 2.f * (-2.f * y * g[0] + x * g[1] + w * g[2] + x * g[3] + z * g[5] - w * g[6] +
                 z * g[7] - 2.f * y * g[8]);
  gq[3] = 2.f * (-2.f * z * g[0] - w * g[1] + x * g[2] + w * g[3] - 2.f * z * g[4] +
                 y * g[5] + x * g[6] + y * g[7]);
}

// the spline's pose at query time tq (interp.interpolate_c2w: the time
// clamped to the knots, the segment as searchsorted(right) clamped to
// [1, m - 1] minus 1, lerp of the translations, slerp of the rotations)
struct SplinePose {
  int seg;
  float s;
  Knot k0, k1;
  Slerp sl;
  float rot[4], R[9], T[3];
};

__device__ void spline_fwd(const RaysArgs& a, const float* tan, float g, float tq,
                           SplinePose& sp) {
  const float* ts = a.ctrl_ts;
  const int m = a.m;
  tq = fminf(fmaxf(tq, ts[0]), ts[m - 1]);
  int lo = 0, hi = m;  // the number of knot times <= tq
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ts[mid] <= tq) lo = mid + 1;
    else hi = mid;
  }
  sp.seg = min(max(lo, 1), m - 1) - 1;
  const float t0 = ts[sp.seg], t1 = ts[sp.seg + 1];
  sp.s = __fsub_rn(tq, t0) / __fsub_rn(t1, t0);
  knot_fwd(tan + 6 * sp.seg, g, sp.k0);
  knot_fwd(tan + 6 * (sp.seg + 1), g, sp.k1);
  for (int c = 0; c < 3; ++c) sp.T[c] = (1.f - sp.s) * sp.k0.t[c] + sp.s * sp.k1.t[c];
  slerp_fwd(sp.k0.q, sp.k1.q, sp.s, sp.sl, sp.rot);
  quat_to_rot(sp.rot, sp.R);
}

// d pose (R, T) -> d the two knots' tangents (ungated)
__device__ void spline_bwd(const SplinePose& sp, const float gR[9], const float gT[3],
                           float gk0[6], float gk1[6]) {
  float grot[4], gq0[4], gq1[4];
  quat_to_rot_bwd(sp.rot, gR, grot);
  slerp_bwd(sp.sl, sp.s, grot, gq0, gq1);
  knot_bwd(sp.k0, gq0, gk0 + 3);
  knot_bwd(sp.k1, gq1, gk1 + 3);
  for (int c = 0; c < 3; ++c) {
    gk0[c] = (1.f - sp.s) * gT[c];
    gk1[c] = sp.s * gT[c];
  }
}

// the event pose: the RGB pose @ dM with dM's baseline times the scale
__device__ void evs_pose(const RaysArgs& a, float scale, const float R[9], const float T[3],
                         float Re[9], float Te[3]) {
  const float* d = a.dM;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      Re[3 * i + j] = R[3 * i] * d[j] + R[3 * i + 1] * d[4 + j] + R[3 * i + 2] * d[8 + j] +
                      T[i] * d[12 + j];
    Te[i] = R[3 * i] * (d[3] * scale) + R[3 * i + 1] * (d[7] * scale) +
            R[3 * i + 2] * (d[11] * scale) + T[i] * d[15];
  }
}

// d event pose -> d RGB pose and d scale
__device__ float evs_pose_bwd(const RaysArgs& a, float scale, const float R[9],
                              const float gRe[9], const float gTe[3], float gR[9],
                              float gT[3]) {
  const float* d = a.dM;
  float gscale = 0.f;
  for (int i = 0; i < 3; ++i) {
    for (int l = 0; l < 3; ++l)
      gR[3 * i + l] = gRe[3 * i] * d[4 * l] + gRe[3 * i + 1] * d[4 * l + 1] +
                      gRe[3 * i + 2] * d[4 * l + 2] + gTe[i] * (d[4 * l + 3] * scale);
    gT[i] = gRe[3 * i] * d[12] + gRe[3 * i + 1] * d[13] + gRe[3 * i + 2] * d[14] +
            gTe[i] * d[15];
    for (int l = 0; l < 3; ++l) gscale += R[3 * i + l] * gTe[i] * d[4 * l + 3];
  }
  return gscale;
}

// -- the deltas -----------------------------------------------------------------

__device__ __forceinline__ void skew(const float w[3], float S[9]) {
  S[0] = 0.f;   S[1] = -w[2]; S[2] = w[1];
  S[3] = w[2];  S[4] = 0.f;   S[5] = -w[0];
  S[6] = -w[1]; S[7] = w[0];  S[8] = 0.f;
}

__device__ __forceinline__ void skew_bwd(const float gS[9], float gw[3]) {
  gw[0] = gS[7] - gS[5];
  gw[1] = gS[2] - gS[6];
  gw[2] = gS[3] - gS[1];
}

__device__ __forceinline__ void matmul3(const float A[9], const float B[9], float C[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// gS += gS2 S^T + S^T gS2: the gradient of S2 = S S
__device__ __forceinline__ void square_bwd(const float S[9], const float gS2[9], float gS[9]) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float v = 0.f;
      for (int l = 0; l < 3; ++l) v += gS2[3 * i + l] * S[3 * j + l] + S[3 * l + i] * gS2[3 * l + j];
      gS[3 * i + j] += v;
    }
}

// lie.exp_map_SO3xR3 (mode SO3XR3) or lie.exp_map_SE3 of a gated delta
struct Delta {
  float d[6], w[3], S[9], S2[9], nrms, th, fac1, fac2, fac3, V[9];
  bool small;
};

__device__ void delta_fwd(const float* row, float g, int pose, Delta& e, float Rc[9],
                          float tc[3]) {
  for (int c = 0; c < 6; ++c) e.d[c] = row[c] * g;
  for (int c = 0; c < 3; ++c) e.w[c] = e.d[3 + c];
  e.nrms = e.w[0] * e.w[0] + e.w[1] * e.w[1] + e.w[2] * e.w[2];
  skew(e.w, e.S);
  matmul3(e.S, e.S, e.S2);
  if (pose == SO3XR3) {
    e.th = sqrtf(fmaxf(e.nrms, 1e-4f));
    const float inv = 1.f / e.th;
    e.fac1 = inv * sinf(e.th);
    e.fac2 = inv * inv * (1.f - cosf(e.th));
    for (int c = 0; c < 3; ++c) tc[c] = e.d[c];
  } else {
    e.th = sqrtf(fmaxf(e.nrms, 1e-10f));
    const float sn = sinf(e.th), cs = cosf(e.th);
    e.small = e.nrms < 1e-8f;
    e.fac1 = e.small ? 1.f - e.nrms / 6.f : sn / e.th;
    e.fac2 = e.small ? 0.5f - e.nrms / 24.f : (1.f - cs) / (e.th * e.th);
    e.fac3 = e.small ? 1.f / 6.f - e.nrms / 120.f : (e.th - sn) / (e.th * e.th * e.th);
    for (int c = 0; c < 9; ++c)
      e.V[c] = (c % 4 == 0 ? 1.f : 0.f) + e.fac2 * e.S[c] + e.fac3 * e.S2[c];
    for (int i = 0; i < 3; ++i)
      tc[i] = e.V[3 * i] * e.d[0] + e.V[3 * i + 1] * e.d[1] + e.V[3 * i + 2] * e.d[2];
  }
  for (int c = 0; c < 9; ++c)
    Rc[c] = e.fac1 * e.S[c] + e.fac2 * e.S2[c] + (c % 4 == 0 ? 1.f : 0.f);
}

// d correction (Rc, tc) -> d delta (ungated)
__device__ void delta_bwd(const Delta& e, int pose, const float gRc[9], const float gtc[3],
                          float gd[6]) {
  float gS[9], gS2[9], gf1 = 0.f, gf2 = 0.f, gf3 = 0.f, gV[9];
  for (int c = 0; c < 9; ++c) {
    gf1 += gRc[c] * e.S[c];
    gf2 += gRc[c] * e.S2[c];
    gS[c] = e.fac1 * gRc[c];
    gS2[c] = e.fac2 * gRc[c];
  }
  if (pose == SO3XR3) {
    for (int c = 0; c < 3; ++c) gd[c] = gtc[c];
  } else {
    for (int i = 0; i < 3; ++i) {
      gd[i] = e.V[i] * gtc[0] + e.V[3 + i] * gtc[1] + e.V[6 + i] * gtc[2];
      for (int j = 0; j < 3; ++j) gV[3 * i + j] = gtc[i] * e.d[j];
    }
    for (int c = 0; c < 9; ++c) {
      gf2 += gV[c] * e.S[c];
      gf3 += gV[c] * e.S2[c];
      gS[c] += e.fac2 * gV[c];
      gS2[c] += e.fac3 * gV[c];
    }
  }
  square_bwd(e.S, gS2, gS);
  float gw[3];
  skew_bwd(gS, gw);
  const float th = e.th, sn = sinf(th), cs = cosf(th);
  float gn = 0.f;  // d nrms
  if (pose == SO3XR3) {
    const float inv = 1.f / th;
    const float ginv = gf1 * sn + gf2 * 2.f * inv * (1.f - cs);
    const float gth = gf1 * inv * cs + gf2 * inv * inv * sn - ginv * inv * inv;
    gn = e.nrms >= 1e-4f ? gth * 0.5f / th : 0.f;
  } else if (e.small) {
    gn = -gf1 / 6.f - gf2 / 24.f - gf3 / 120.f;
  } else {
    const float t2 = th * th, t3 = t2 * th;
    const float gth = gf1 * (cs / th - sn / t2) + gf2 * (sn / t2 - 2.f * (1.f - cs) / t3) +
                      gf3 * ((1.f - cs) / t3 - 3.f * (th - sn) / (t3 * th));
    gn = e.nrms >= 1e-10f ? gth * 0.5f / th : 0.f;
  }
  for (int c = 0; c < 3; ++c) gd[3 + c] = gw[c] + 2.f * e.w[c] * gn;
}

// -- the rays -------------------------------------------------------------------

// cameras.radial_and_tangential_undistort: 10 Newton steps, a step skipped
// where |det J| <= 1e-3
__device__ void undistort(const float* p, float& x, float& y) {
  const float xd = x, yd = y;
  const float k1 = p[0], k2 = p[1], k3 = p[2], k4 = p[3], p1 = p[4], p2 = p[5];
  for (int it = 0; it < 10; ++it) {
    const float r = x * x + y * y;
    const float d = 1.f + r * (k1 + r * (k2 + r * (k3 + r * k4)));
    const float fx = d * x + 2.f * p1 * x * y + p2 * (r + 2.f * x * x) - xd;
    const float fy = d * y + 2.f * p2 * x * y + p1 * (r + 2.f * y * y) - yd;
    const float d_r = k1 + r * (2.f * k2 + r * (3.f * k3 + r * 4.f * k4));
    const float d_x = 2.f * x * d_r, d_y = 2.f * y * d_r;
    const float fx_x = d + d_x * x + 2.f * p1 * y + 6.f * p2 * x;
    const float fx_y = d_y * x + 2.f * p1 * x + 2.f * p2 * y;
    const float fy_x = d_x * y + 2.f * p2 * y + 2.f * p1 * x;
    const float fy_y = d + d_y * y + 2.f * p2 * x + 6.f * p1 * y;
    const float den = fy_x * fx_y - fx_x * fy_y;
    if (fabsf(den) > 1e-3f) {
      const float nx = x + (fx * fy_y - fy * fx_y) / den;
      const float ny = y + (fy * fx_x - fx * fy_x) / den;
      x = nx;
      y = ny;
    }
  }
}

// generate_rays' three camera directions (the pixel and its +x and +y
// neighbours), rotated and normalised, and pixel_area
struct Geo {
  float d[3][3], w[3][3], nw[3], n[3][3], e1[3], e2[3], dx, dy;
};

__device__ void geo_fwd(const Part& p, float x, float y, const float R[9], Geo& g) {
  const float xc = x - p.cx, yc = y - p.cy;
  float u[3] = {xc / p.fx, (xc + 1.f) / p.fx, xc / p.fx};
  float v[3] = {-yc / p.fy, -yc / p.fy, -(yc + 1.f) / p.fy};
  for (int k = 0; k < 3; ++k) {
    if (p.dist) undistort(p.dist, u[k], v[k]);
    g.d[k][0] = u[k];
    g.d[k][1] = v[k];
    g.d[k][2] = -1.f;
    for (int i = 0; i < 3; ++i)
      g.w[k][i] = R[3 * i] * u[k] + R[3 * i + 1] * v[k] - R[3 * i + 2];
    g.nw[k] = sqrtf(g.w[k][0] * g.w[k][0] + g.w[k][1] * g.w[k][1] + g.w[k][2] * g.w[k][2]);
    for (int i = 0; i < 3; ++i) g.n[k][i] = g.w[k][i] / g.nw[k];
  }
  float s1 = 0.f, s2 = 0.f;
  for (int i = 0; i < 3; ++i) {
    g.e1[i] = g.n[0][i] - g.n[1][i];
    g.e2[i] = g.n[0][i] - g.n[2][i];
    s1 += g.e1[i] * g.e1[i];
    s2 += g.e2[i] * g.e2[i];
  }
  g.dx = sqrtf(s1);
  g.dy = sqrtf(s2);
}

// d direction, d pixel_area -> d R (added to gR)
__device__ void geo_bwd(const Geo& g, const float gdir[3], float garea, float gR[9]) {
  const float a1 = garea * g.dy / g.dx, a2 = garea * g.dx / g.dy;
  float gn[3][3];
  for (int i = 0; i < 3; ++i) {
    const float t1 = garea != 0.f ? a1 * g.e1[i] : 0.f;
    const float t2 = garea != 0.f ? a2 * g.e2[i] : 0.f;
    gn[0][i] = gdir[i] + t1 + t2;
    gn[1][i] = -t1;
    gn[2][i] = -t2;
  }
  for (int k = 0; k < 3; ++k) {
    const float dn = g.n[k][0] * gn[k][0] + g.n[k][1] * gn[k][1] + g.n[k][2] * gn[k][2];
    for (int i = 0; i < 3; ++i) {
      const float gw = (gn[k][i] - g.n[k][i] * dn) / g.nw[k];
      for (int j = 0; j < 3; ++j) gR[3 * i + j] += gw * g.d[k][j];
    }
  }
}

// interp.find_closest_idxs: searchsorted (left), clamped, against the one before
__device__ int closest(const float* ref, int n, float q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ref[mid] < q) lo = mid + 1;
    else hi = mid;
  }
  const int ins = min(lo, n - 1), prev = max(ins - 1, 0);
  return fabsf(ref[prev] - q) < fabsf(ref[ins] - q) ? prev : ins;
}

// the spline's query time of a ray: its camera's time, or under deblur the
// exposure's rep evenly spread times (pose_opt.spline_deblur_c2w's f32 ops)
__device__ __forceinline__ float query_time(const RaysArgs& a, const Part& p, const RayIn& q) {
  const float tc = p.times[q.cam];
  if (p.rep == 1) return tc;
  return __fadd_rn(__fsub_rn(tc, a.exp_half), __fmul_rn(a.exp_delta, (float)q.sub));
}

// everything a ray's outputs and their backward need
struct Ray {
  SplinePose sp;
  Delta e;
  Geo geo;
  float R[9], T[3], Rc[9], tc[3], scale;
};

__device__ void ray_fwd(const RaysArgs& a, const Part& p, const RayIn& q, float g, Ray& ry) {
  if (p.pose == SPLINE || p.pose == SPLINE_EVS) {
    spline_fwd(a, p.table, g, query_time(a, p, q), ry.sp);
    if (p.pose == SPLINE) {
      for (int c = 0; c < 9; ++c) ry.R[c] = ry.sp.R[c];
      for (int c = 0; c < 3; ++c) ry.T[c] = ry.sp.T[c];
    } else {
      ry.scale = gated(a.scale[0], g);
      evs_pose(a, ry.scale, ry.sp.R, ry.sp.T, ry.R, ry.T);
    }
  } else {
    const float* m = p.pose == PER_RAY ? p.c2w + (long long)p.c2w_stride * (q.pix * p.rep + q.sub)
                                       : p.c2w + 12 * (long long)q.cam;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) ry.R[3 * i + j] = m[4 * i + j];
      ry.T[i] = m[4 * i + 3];
    }
  }
  geo_fwd(p, q.x, q.y, ry.R, ry.geo);
  if (p.pose == SO3XR3 || p.pose == SE3)
    delta_fwd(p.table + 6 * (long long)q.cam, g, p.pose, ry.e, ry.Rc, ry.tc);
}

__global__ void __launch_bounds__(kThreads) rays_fwd_kernel(const __grid_constant__ RaysArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  const Part& p = a.parts[part_of(a, r)];
  const RayIn q = ray_in(p, r - p.offset);
  Ray ry;
  ray_fwd(a, p, q, gate_of(p), ry);
  const float* n0 = ry.geo.n[0];
  float o[3], d[3];
  for (int i = 0; i < 3; ++i) {
    o[i] = ry.T[i];
    d[i] = n0[i];
  }
  if (p.pose == SO3XR3 || p.pose == SE3) {
    for (int i = 0; i < 3; ++i) {
      o[i] = ry.T[i] + ry.tc[i];
      d[i] = ry.Rc[3 * i] * n0[0] + ry.Rc[3 * i + 1] * n0[1] + ry.Rc[3 * i + 2] * n0[2];
    }
  }
  for (int i = 0; i < 3; ++i) {
    a.origins[3 * (long long)r + i] = o[i];
    a.dirs[3 * (long long)r + i] = d[i];
  }
  a.area[r] = ry.geo.dx * ry.geo.dy;
  const float t = p.times ? p.times[q.cam] : 0.f;
  if (a.times_out) a.times_out[r] = t;
  a.cam_out[r] = p.snap ? closest(a.rgb_ts, a.n_rgb, t) : q.cam;
  if (a.app_out) {
    long long app = p.app[q.pix];
    if (p.app_deblur) app = min(max(app + q.sub - 2, 0ll), (long long)a.num_embd - 1);
    a.app_out[r] = app;
  }
}

// K8b's first pass: each ray's terms, gated: [knot seg (6), knot seg + 1
// (6)] of a spline or [its camera's row (6)] of deltas, its key (seg or
// camera) and its scale term; nothing is summed here
__global__ void __launch_bounds__(kThreads) rays_bwd_kernel(const __grid_constant__ RaysArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.n) return;
  const Part& p = a.parts[part_of(a, r)];
  const bool spline = p.pose == SPLINE || p.pose == SPLINE_EVS;
  const bool scaled = p.pose == SPLINE_EVS && a.scale_grad;
  if (!((p.table_grad && p.pose >= SPLINE) || scaled)) return;
  const RayIn q = ray_in(p, r - p.offset);
  const float g = gate_of(p);
  Ray ry;
  ray_fwd(a, p, q, g, ry);
  float go[3] = {0.f, 0.f, 0.f}, gd[3] = {0.f, 0.f, 0.f};
  const float ga = a.g_area ? a.g_area[r] : 0.f;
  for (int i = 0; i < 3; ++i) {
    if (a.g_origins) go[i] = a.g_origins[3 * (long long)r + i];
    if (a.g_dirs) gd[i] = a.g_dirs[3 * (long long)r + i];
  }
  float v[12];
  for (int c = 0; c < 12; ++c) v[c] = 0.f;
  int key = -1;
  if (spline) {
    float gR[9], gT[3];
    for (int c = 0; c < 9; ++c) gR[c] = 0.f;
    geo_bwd(ry.geo, gd, ga, gR);
    for (int c = 0; c < 3; ++c) gT[c] = go[c];
    if (p.pose == SPLINE_EVS) {
      float gRr[9], gTr[3];
      const float gs = evs_pose_bwd(a, ry.scale, ry.sp.R, gR, gT, gRr, gTr) * g;
      if (scaled) a.sterms[r] = gs;
      for (int c = 0; c < 9; ++c) gR[c] = gRr[c];
      for (int c = 0; c < 3; ++c) gT[c] = gTr[c];
    }
    if (p.table_grad) {
      spline_bwd(ry.sp, gR, gT, v, v + 6);
      key = ry.sp.seg;
    }
  } else {
    // origin + tc, Rc @ direction: the pose itself is fixed
    const float* n0 = ry.geo.n[0];
    float gRc[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) gRc[3 * i + j] = gd[i] * n0[j];
    delta_bwd(ry.e, p.pose, gRc, go, v);
    key = q.cam;
  }
  a.keys[r] = key;
  float* t = a.terms + 12 * (long long)r;
  for (int c = 0; c < 12; ++c) t[c] = v[c] * g;
}

// K8b's second pass: a block a row of a leaf's gradient (the last block, the
// scale), every row written. Its threads walk the rays of the parts that add
// into the leaf, each a fixed stride of them in ray order, then the block
// sums its threads' in a fixed tree: the same bits at every call.
__global__ void __launch_bounds__(kThreads) rays_sum_kernel(const __grid_constant__ RaysArgs a) {
  __shared__ float part_sums[kThreads / 32][6];
  const int b = blockIdx.x;
  float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const bool scale = a.scale_grad && b == a.sum_blocks - 1;
  int t = 0;
  if (!scale) {
    for (int j = 1; j < a.num_targets; ++j)
      if (b >= a.targets[j].first) t = j;
  }
  const Target& tg = a.targets[t];
  const int row = b - tg.first;
  for (int k = 0; k < a.num_parts; ++k) {
    const Part& p = a.parts[k];
    if (scale ? p.pose != SPLINE_EVS : !((tg.parts >> k) & 1)) continue;
    const bool spline = p.pose == SPLINE || p.pose == SPLINE_EVS;
    for (int r = p.offset + threadIdx.x; r < p.offset + p.n; r += kThreads) {
      if (scale) {
        s[0] += a.sterms[r];
        continue;
      }
      const int key = a.keys[r];
      const float* v = a.terms + 12 * (long long)r;
      if (key == row)
        for (int c = 0; c < 6; ++c) s[c] += v[c];
      if (spline && key == row - 1)
        for (int c = 0; c < 6; ++c) s[c] += v[6 + c];
    }
  }
  for (int off = 16; off; off >>= 1)
    for (int c = 0; c < 6; ++c) s[c] += __shfl_xor_sync(kFull, s[c], off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int c = 0; c < 6; ++c) part_sums[warp][c] = s[c];
  __syncthreads();
  if (threadIdx.x < (scale ? 1 : 6)) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += part_sums[w][threadIdx.x];
    if (scale) *a.scale_grad = sum;
    else tg.grad[6 * (long long)row + threadIdx.x] = sum;
  }
}

int launch(bool fwd, const RaysArgs& a, cudaStream_t stream) {
  if (a.n == 0) return 0;
  const int blocks = (a.n + kThreads - 1) / kThreads;
  if (fwd) {
    rays_fwd_kernel<<<blocks, kThreads, 0, stream>>>(a);
  } else {
    rays_bwd_kernel<<<blocks, kThreads, 0, stream>>>(a);
    if (a.sum_blocks > 0) rays_sum_kernel<<<a.sum_blocks, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rays_fwd(const RaysArgs* args, cudaStream_t stream) {
  return launch(true, *args, stream);
}

extern "C" int rays_bwd(const RaysArgs* args, cudaStream_t stream) {
  return launch(false, *args, stream);
}
