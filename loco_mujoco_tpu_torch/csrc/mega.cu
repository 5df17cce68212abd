// The mega path: a whole forward (FK, collision, smooth stage, constraint
// rows, Newton solve) as one kernel, and a whole control step (n substeps
// of RK4 or Euler) as one kernel. One warp owns one env.
//
// mega_forward_kernel replaces the Pallas program of
// loco_mujoco_tpu/ops/pallas_constraint.py: _mega_batched (:2335, its
// pallas_call) with its body _make_fused_kernel(mega=True) ->
// _forward_env_block (:1183), which inlines pallas_fk.fk_env_block,
// pallas_fk.collide_env_block (plane-box _box_slots, plane-cylinder
// _cyl_slots and plane-mesh _mesh_group_slots with top-K),
// _smooth_preamble, the CRB mass matrix and qacc_smooth by Cholesky, the
// JOINT-equality / friction-loss / limit / pyramidal contact rows,
// solve_core and, for Euler models, the implicit-damping dv (euler_dv,
// :1893-1906).
// A plan with the extended collision (mega_ell: NXGRP > 0) runs
// collide_ext instead, the counterpart of pallas_fk.collide_env_block_ext
// (:1714-2039): every classic analytic pair kind, self pairs included, and
// a plane-mesh group (mesh_group, the plane-only collision's, then the
// selected hulls' geoms, bodies and invweight, _mesh_group_slots :663 and
// its gmap :1752-1768) into generic contact slots (frame, both geoms and
// bodies, the group's statics); then, with elliptic cones, dim elliptic
// rows per slot and the Newton solve's cone zones in double, or, with
// pyramidal cones (G1), the four blocked facet rows of each slot
// (_mega_ell_finish :2594-2600) and the float solve: three instances
// (plane-only, extended elliptic, extended pyramidal; LMT_INSTANCE).
// A plan with muscles (flag MUSCLE) adds the tendon and muscle stage
// (muscle_block; pallas_fk.muscle_env_block :1140-1350, inlined at
// pallas_constraint.py:1245-1264) after the smooth stage: qfrc_smooth gains
// the muscles' joint forces and the kernel writes act_dot (E, na) in act
// slot order.
// A plan with per-env joint damping (flag DAMP_ROWS, the reference's
// sm_dyn_damping, pallas_constraint.py:529-537) reads each env's damping
// from the (E, nv) operand `damp` (the rows _forward_env_block appends to
// its packed vec, :1237-1240) in the smooth stage's passive force; such a
// plan has no euler_dv (:314-329), so Euler with it is no megastep path
// and the one-forward kernel serves its substeps.
// megastep_kernel replaces _megastep_batched (:2800, its pallas_call) with
// its body _make_megastep_kernel (:2638): the same forward looped over n
// substeps, carrying qpos, qvel and the warm start. RK4 runs the four
// stages of each substep (stage 1 warm-starts from the carried value; its
// qacc warm-starts stages 2-4 and the next substep,
// pallas_constraint.py:2731-2755); Euler (:2761-2787) runs one forward,
// qvel += dt dv with dv = euler_dv (or qacc when EULERDAMP is disabled),
// qpos += dt qvel, act += dt act_dot clamped to each act slot's range (the
// clamped value feeds the next forward), and carries that qacc as the warm
// start. RK4 with activations is no megastep path (the wrapper refuses it,
// as the reference does).
//
// The arithmetic follows the port's staged path, which is these kernels'
// plain version (ops/hopper_mega.py): kinematics.py and collision.py with
// the plane-mesh select and top-K of plane_mesh.cu, then the fused
// constraint stage: the smooth stage, rows (contact facets blocked, as in
// fused.cu and the reference) and Euler damping of forward_core.cuh, and
// the Newton solve of newton_core.cuh (its row quantities and cone zones,
// `Rows`, are this file's too). Differences from the Pallas kernel, none of
// which changes a result beyond summation order: each env decides its own
// conservative skip of the plane-mesh vertex walk (the TPU block decided
// for 1,024 envs at once), computes the neighbour manifold only for the
// pairs the top-K selects, and skips its own inactive constraint rows in
// every solve pass, so the reference's fast/full branch pair (mega_fast)
// has no counterpart here.
//
// Bound: operations, not bytes. Per forward an env reads ~0.5 KB of state
// and writes ~0.4 KB, but does ~10^5 float operations, 67-93% of them in
// the Newton solve (tools/megastep_phases.py: Newton, then the smooth stage
// and the collision); the rest is the mesh height maps of near pairs, the
// CRB and its factor and the row builders.
//
// The reference's answer to spreading that work over its hardware is a
// choice of layout per model (RowPlan.pick_s / use_grouped,
// pallas_constraint.py:710-742): the lanes layout, an env per lane, keeps
// the row-space work (J x, the Hessian, the line search) dense, and the
// grouped (S, 128) layout keeps each env's scalar chains (the Cholesky,
// the cone zones, the line-search scalars) dense. A thread per env, this
// kernel's first version, gives E / 32 warps (128 at 4096 envs for 132
// SMs: one warp per SM, nothing to hide its latency) with its state in
// local memory. Here a warp owns an env, and the env's state lives in
// shared memory, laid out from the model's census (ops/plan.py MegaLaunch,
// table I_SHM; 24-54 KB per env on the committed models, so 4-8 envs are
// resident per SM):
//
// - row-space work goes lane per active row (over lists of the active
//   rows, the rows with a force and the rows with a Hessian term, built by
//   warp ballots): J x - aref, the row forces, weights and cone zones,
//   J dx, the line search's phi' and the costs, summed by warp shuffles in
//   a fixed order; the gradient goes lane per dof and H = M + J' diag(w) J
//   (with the cone zones' rank-1 and curvature terms) lane per Hessian
//   entry, each over the rows in row order;
// - the scalar chains go lane per row of the factor: each Cholesky
//   factorisation one column at a time, with the forward substitution's
//   step for that column, then the backward substitution one unknown at a
//   time, broadcast by shuffle;
// - FK's tree walk runs on lane 0 (0.5% of the one-thread kernel's time);
//   per body, per joint and per dof work (frames, cinert, cdof, the CRB
//   entries, cvel, the RNE, the projections) goes lane per item, the
//   subtree sums lane per component;
// - collision goes lane per pair (the support depth and vertex walk of
//   each plane-mesh pair, each extended pair's key and narrowphase), with
//   the top-K by rank (each pair counting the keys before it, first index
//   on ties) or, past a warp of pairs, k rounds of a warp argmin, and the
//   manifold of each selected pair on its own lane;
// - the muscle block goes lane per muscle, then lane per body for the
//   wrenches and lane per dof for their projection.
//
// Every sum has one fixed order (no atomics on floats), so the kernels are
// bit-deterministic from run to run, and they record the same discrete
// decisions as newton_core.cuh's solve (the iteration count, the taken
// steps, the line search's signs and each step's Hessian decision of every
// row), so their plain versions can replay them.
//
// Layout: the inputs and outputs are env-major (E, k) as the Data fields
// hold them, so no relayout kernel runs around these kernels, and the rows
// (J as (nrows, nv | 1), odd so that a warp's lanes read its rows without
// bank conflicts) stay in shared memory where the env's whole state leaves
// at least 4 envs resident per SM (ops/plan.py RESIDENT_FLOOR). Past the
// first nv width (the library built with LMT_NVM=32) a census that would
// leave fewer keeps J in a per-env global scratch (the launchers' jrows,
// (E, nrows, nv | 1), env-major, so a lane per dof reads a row coalesced;
// G1 with its arms: 312 rows at nv 29), while the shared region J shrinks
// to the scratch that aliases it before the rows (the smooth stage's, the
// collision's); any other launch that does not fit is refused.
//
// Two nv widths are compiled: the libraries without LMT_NVM hold nv <= 24
// and every instance; the wide library (LMT_NVM=32, nv 25-32) holds every
// instance but the extended elliptic one (no elliptic plan passes nv 24,
// ops/plan.py), and refuses that one (LMT_INSTANCE).
//
// Rounding: the collision functions (geom_pose, box_slots, cyl_slots,
// collide and the extended collision's) write each product and each sum
// with __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never fuses into a
// multiply-add, so they round as the plain
// versions' separate operations do and the active contact sets match. The
// rest of the file is compiled with contraction on, as newton.cu is.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "forward_core.cuh"

namespace {

using namespace lmt;

constexpr float kBig = 1e10f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
constexpr int kMaxEnvsPerBlock = 4;  // ops/plan.py ENVS_PER_BLOCK_MAX
// Hessian entries a lane owns: nv (nv + 1) / 2 over a warp, nv <= NVM
// (10 at 24, 17 at 32)
constexpr int kEnt = (NVM * (NVM + 1) / 2 + kWarp - 1) / kWarp;

// ---- per-phase clocks (a compile-time variant) ------------------------------
// Built with -DLMT_PHASES only by tools/megastep_phases.py, never for the
// main path: lane 0 reads clock64() at the phase boundaries of forward_env
// and each phase's cycles are summed per env into g_phase (E, kPhases + 1),
// the last column holding the previous reading. Three more columns split
// the Newton solve's cycles: the gradient and Hessian, the factor and the
// substitutions, and the line search with the new cost (the rest of it
// is the row passes).
constexpr int kPhases = 9;
enum Phase {
  PH_FK, PH_COLLISION, PH_SMOOTH, PH_ROWS, PH_NEWTON, PH_STEP,
  PH_N_HESSIAN, PH_N_FACTOR, PH_N_LINE
};
#ifdef LMT_PHASES
__device__ long long* g_phase;
__device__ __forceinline__ void phase_start(int e, int lane) {
  if (lane == 0) g_phase[(size_t)e * (kPhases + 1) + kPhases] = clock64();
}
__device__ __forceinline__ void phase_tick(int e, int lane, int p) {
  if (lane) return;
  long long* g = g_phase + (size_t)e * (kPhases + 1);
  const long long t = clock64();
  g[p] += t - g[kPhases];
  g[kPhases] = t;
}
__device__ __forceinline__ long long phase_now() { return clock64(); }
// a Newton part's cycles since t0 (the main phases' reading unchanged)
__device__ __forceinline__ long long phase_part(int e, int lane, int p,
                                                long long t0) {
  const long long t = clock64();
  if (lane == 0) g_phase[(size_t)e * (kPhases + 1) + p] += t - t0;
  return t;
}
#else
__device__ __forceinline__ void phase_start(int, int) {}
__device__ __forceinline__ void phase_tick(int, int, int) {}
__device__ __forceinline__ long long phase_now() { return 0; }
__device__ __forceinline__ long long phase_part(int, int, int, long long) {
  return 0;
}
#endif


// ---- quaternion helpers (the port's ops/math.py formulas) ---------------
__device__ void quat_rotate(const float* q, const float* v, float* o) {
  float c[3], uc[3];
  cross(q + 1, v, c);
  cross(q + 1, c, uc);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.f * (q[0] * c[i] + uc[i]);
}

__device__ void quat_mul(const float* a, const float* b, float* o) {
  const float w1 = a[0], x1 = a[1], y1 = a[2], z1 = a[3];
  const float w2 = b[0], x2 = b[1], y2 = b[2], z2 = b[3];
  o[0] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  o[1] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[2] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[3] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
}

__device__ void quat_to_mat(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  m[0] = 1 - 2 * (yy + zz);
  m[1] = 2 * (xy - wz);
  m[2] = 2 * (xz + wy);
  m[3] = 2 * (xy + wz);
  m[4] = 1 - 2 * (xx + zz);
  m[5] = 2 * (yz - wx);
  m[6] = 2 * (xz - wy);
  m[7] = 2 * (yz + wx);
  m[8] = 1 - 2 * (xx + yy);
}

__device__ void mat_mul3(const float* a, const float* b, float* o) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      o[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] +
                     a[3 * i + 2] * b[6 + j];
}


// ---- one env's state in shared memory -------------------------------------
// ops/plan.py MegaLaunch writes the per-env offsets (floats) into the table
// I_SHM, in this order (its SHM), then the strides.
enum Shm {
  SH_TOTAL, SH_VEC, SH_CDOF, SH_JNT, SH_BODY, SH_M, SH_L, SH_J, SH_ROW, SH_R,
  SH_FL, SH_MU, SH_SLOT, SH_MESH, SH_MUS, SH_MISC, SH_NVJ, SH_RS, SH_SLOTW,
  SH_PMAX, SH_KMAX
};
// nv-long vectors of SH_VEC (ops/plan.py NVEC)
enum Vec {
  V_QPOS, V_QVEL, V_WS, V_X, V_ASM, V_QFS, V_G, V_DX, V_MDX0, V_MDX, V_TMP,
  V_QS, V_VS, V_AQ, V_AV, V_OUT, NVEC
};
// per-body fields of SH_BODY, BW floats per body (ops/plan.py BODY_W)
enum BodyF {
  B_XPOS = 0, B_XQUAT = 3, B_XMAT = 7, B_XIPOS = 16, B_XIMAT = 19,
  B_CINERT = 28, B_CRB = 38, B_CVEL = 48, B_CFRC = 54, BW = 60
};
// per-row arrays of SH_ROW, rs floats each (ops/plan.py ROW_ARRAYS; the
// last four only for elliptic plans): aref, D, act, jar, jv (also the
// Hessian weight w between the row pass and the Hessian), the force f;
// in two arrays' room, three row lists (16-bit row indices, in row
// order): the active rows (an elliptic contact by its first row), the
// rows with a force and the rows with a Hessian term, which the solve's
// passes walk instead of every row; the
// row's class (int: -1 a scalar row, 8 ci + dim on an elliptic contact's
// first row, -2 on its other rows); in two arrays' room (R_FD, R_FD2)
// the rows' forces in double, for the gradient of the double solve; an
// elliptic contact's zone on its first row (1 middle, -1
// sticking, 0 neither)
enum RowA {
  R_AREF, R_D, R_ACT, R_JAR, R_JV, R_F, R_LISTS, R_CLS = R_LISTS + 2, R_FD,
  R_FD2, R_ZONE
};
enum RowList { L_ACT, L_F, L_H };
// per-slot fields of SH_SLOT (ops/plan.py SLOT_W, SLOT_W_EXT); ints as
// float bits
enum SlotF {
  S_POS = 0, S_DIST = 3, S_BODY = 4, S_GID = 5, S_GID1 = 6, S_BODY1 = 7,
  S_GRP = 8, S_IW = 9, S_FRAME = 10
};
// SH_MISC: the subtree com (3), then the row-decision words of one step,
// then (elliptic plans) the vectors of one middle-zone cone in double:
// J'g and its curvature pairs' v_kl, 1 + (dim - 1)(dim - 2) / 2 <= 11 of
// nv (ops/plan.py CONE_VECS), and its zone's terms (4 kDimMax + 2
// doubles, CONE_SCR)
constexpr int kMiscCom = 0, kMiscBits = 8, kConeVecs = 11;

struct Env {
  // J: the rows' Jacobian; scr, the shared region J, holds scratch before
  // the rows (J is that region, or the env's rows of the global scratch,
  // `place_rows`)
  float *v, *cdof, *jnt, *bd, *M, *L, *J, *scr, *row, *R, *fl, *mu, *sl,
      *mesh, *mus, *misc;
  int nv, nvj, rs, sw, pmax, kmax, nb, nrows, ncon, e, lane;
  __device__ float* vec(int k) const { return v + k * nv; }
  __device__ float* body(int b) const { return bd + b * BW; }
  __device__ float* ra(int k) const { return row + k * rs; }
  __device__ int* cls() const { return (int*)(row + R_CLS * rs); }
  __device__ unsigned short* list(int k) const {
    return (unsigned short*)(row + R_LISTS * rs) + k * rs;
  }
  __device__ float* jrow(int r) const { return J + r * nvj; }
  __device__ float* slot(int c) const { return sl + c * sw; }
  __device__ unsigned* bits() const { return (unsigned*)(misc + kMiscBits); }
  template <class P>
  __device__ P* cone_vecs() const {
    return (P*)(misc + kMiscBits + (((nrows + 31) / 32 + 1) & ~1));
  }
};

// The double Newton solve's x, dx, M (x - asm) and M dx (nv each), in the
// L region after its H (nv x nv) and gradient (nv) (ops/plan.py: L holds
// nv (nv + 5) doubles for elliptic plans).
__device__ __forceinline__ double* solve_vecs(const Env& s) {
  return (double*)s.L + s.nv * s.nv + s.nv;
}

__device__ Env env_of(const Tab& T, float* base, int e) {
  const int* sh = T.i(I_SHM);
  Env s;
  s.v = base + sh[SH_VEC];
  s.cdof = base + sh[SH_CDOF];
  s.jnt = base + sh[SH_JNT];
  s.bd = base + sh[SH_BODY];
  s.M = base + sh[SH_M];
  s.L = base + sh[SH_L];
  s.J = s.scr = base + sh[SH_J];
  s.row = base + sh[SH_ROW];
  s.R = base + sh[SH_R];
  s.fl = base + sh[SH_FL];
  s.mu = base + sh[SH_MU];
  s.sl = base + sh[SH_SLOT];
  s.mesh = base + sh[SH_MESH];
  s.mus = base + sh[SH_MUS];
  s.misc = base + sh[SH_MISC];
  s.nv = T.h(NV);
  s.nvj = sh[SH_NVJ];
  s.rs = sh[SH_RS];
  s.sw = sh[SH_SLOTW];
  s.pmax = sh[SH_PMAX];
  s.kmax = sh[SH_KMAX];
  s.nb = T.h(NBODY);
  s.nrows = T.h(NROWS);
  s.ncon = T.h(NCON);
  s.e = e;
  s.lane = threadIdx.x & (kWarp - 1);
  return s;
}

// ---- warp helpers ------------------------------------------------------------
// The warp's sum of v, in one fixed order; every lane gets the same value
// (a butterfly: each pair of lanes adds the same two numbers).
__device__ __forceinline__ float wsum(float v) {
  for (int m = kWarp / 2; m; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}
__device__ __forceinline__ double wsum(double v) {
  for (int m = kWarp / 2; m; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// The warp's smallest (key, idx), the smallest idx among equal keys: the
// first-index argmin of a sequential scan; every lane gets it.
__device__ __forceinline__ void wargmin(float& key, int& idx) {
  for (int m = kWarp / 2; m; m >>= 1) {
    const float k2 = __shfl_xor_sync(kFull, key, m);
    const int i2 = __shfl_xor_sync(kFull, idx, m);
    if (k2 < key || (k2 == key && i2 < idx)) {
      key = k2;
      idx = i2;
    }
  }
}

__device__ __forceinline__ float fbits(int i) { return __int_as_float(i); }
__device__ __forceinline__ int ibits(float f) { return __float_as_int(f); }

// The top-k of the P finite keys key[p] (shared), in order: sel[r] the
// pair of rank r by (key, index) and mk[r] its key -- the sequential
// kernels' k rounds of a first-index argmin, each round marking its pair
// taken (kBig, above every finite key). Up to a warp of pairs, lane per
// pair, each counting the pairs before it (one pass of P comparisons);
// more pairs (the plane-mesh group's 75), k rounds of a warp argmin over
// the keys, which take fewer instructions there. sel holds pair indices
// even where a key is NaN (a diverged env).
__device__ void wtopk(const Env& s, float* key, int P, int k, int* sel,
                      float* mk) {
  if (P > kWarp) {
    for (int r = 0; r < k; ++r) {
      float m = INFINITY;
      int best = 0x7fffffff;
      for (int p = s.lane; p < P; p += kWarp)
        if (best == 0x7fffffff || key[p] < m) {
          m = key[p];
          best = p;
        }
      wargmin(m, best);
      __syncwarp();
      if (s.lane == 0) {
        sel[r] = best < P ? best : 0;
        mk[r] = m;
        key[sel[r]] = kBig;
      }
      __syncwarp();
    }
    return;
  }
  for (int r = s.lane; r < k; r += kWarp) {
    sel[r] = r;
    mk[r] = key[r];
  }
  __syncwarp();
  if (s.lane < P) {
    const int p = s.lane;
    const float kp = key[p];
    int rank = 0;
    for (int q = 0; q < P; ++q) {
      const float kq = key[q];
      rank += kq < kp || (kq == kp && q < p);
    }
    if (rank < k) {
      sel[rank] = p;
      mk[rank] = kp;
    }
  }
  __syncwarp();
}

__device__ __forceinline__ float wsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double wsqrt(double x) { return sqrt(x); }

// x = A^-1 (neg ? -b : b) for SPD A (row stride n) by its Cholesky
// factor L, which overwrites A's lower triangle (only that is read);
// pivots floored at 1e-30. Lane i owns row i and unknown i (n <= 32):
// column j of L goes with step j of the forward substitution (L y = b),
// then the backward one (L' x = y) an unknown at a time; each entry of L is
// the sequential factorisation's dot in its order (INV: the Newton
// solve's multiply by the pivot's inverse, else a division, as
// linalg.cholesky). T: float, or double for the elliptic plans' Newton
// solve; x in its own type (X); b and x in shared memory (may be the
// same).
template <bool INV, class T, class X>
__device__ void wfactor_solve(const Env& s, T* A, const T* b, X* x, int n,
                              bool neg) {
  const int i = s.lane;
  T y = i < n ? (neg ? -b[i] : b[i]) : T(0);
  for (int j = 0; j < n; ++j) {
    T v = 0;
    if (i >= j && i < n) {
      v = A[i * n + j];
      for (int k = 0; k < j; ++k) v -= A[i * n + k] * A[j * n + k];
    }
    const T d = __shfl_sync(kFull, v, j);
    const T dj = wsqrt(d > T(1e-30) ? d : T(1e-30));
    T lij = 0;
    if (i == j) {
      A[j * n + j] = dj;
    } else if (i > j && i < n) {
      if (INV) {
        const T inv = T(1) / dj;
        lij = v * inv;
      } else {
        lij = v / dj;
      }
      A[i * n + j] = lij;
    }
    const T yj = __shfl_sync(kFull, y, j) / dj;
    if (i == j)
      y = yj;
    else if (i > j && i < n)
      y -= lij * yj;
    __syncwarp();
  }
  for (int k = n - 1; k >= 0; --k) {
    const T xk = __shfl_sync(kFull, y, k) / A[k * n + k];
    if (i == k)
      y = xk;
    else if (i < k)
      y -= A[k * n + i] * xk;
  }
  __syncwarp();
  if (i < n) x[i] = (X)y;
  __syncwarp();
}

// out = A v (A n x n, row stride n), lane per row, in v's type
template <class V>
__device__ void wmat_vec(const Env& s, const float* A, const V* v, V* out,
                         int n) {
  for (int a = s.lane; a < n; a += kWarp) {
    V t = 0;
    for (int b = 0; b < n; ++b) t += A[a * n + b] * v[b];
    out[a] = t;
  }
  __syncwarp();
}

// Writes, in increasing order, the rows r < n with pred(r) into list and
// returns their count (the same on every lane).
template <class P>
__device__ int compact(const Env& s, int n, unsigned short* list, P&& pred) {
  int cnt = 0;
  for (int r0 = 0; r0 < n; r0 += kWarp) {
    const int r = r0 + s.lane;
    const bool p = r < n && pred(r);
    const unsigned b = __ballot_sync(kFull, p);
    if (p) list[cnt + __popc(b & ((1u << s.lane) - 1u))] = r;
    cnt += __popc(b);
  }
  __syncwarp();
  return cnt;
}

// J row . v, in v's type
template <class V>
__device__ __forceinline__ V jdot(const float* j, const V* v, int nv) {
  V t = 0;
  for (int k = 0; k < nv; ++k) t += j[k] * v[k];
  return t;
}

// J row . x - aref accumulated in double, returned in x's type (rounded
// once for a float x: newton_core.cuh's jar_exact)
template <class X>
__device__ __forceinline__ X jar_wide(const float* j, const X* x, int nv,
                                      float aref) {
  double t = 0.0;
  for (int k = 0; k < nv; ++k) t += (double)j[k] * (double)x[k];
  return (X)(t - (double)aref);
}

// newton_core.cuh's Cone in precision T.
template <class T>
struct ConeT {
  T f[kDimMax], w[kDimMax], g[kDimMax], q[kDimMax], sc[kDimMax];
  T c, wg, c2;
  bool mid, bottom;
};

__device__ __forceinline__ float wmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double wmax(double a, double b) {
  return fmax(a, b);
}

// newton_core.cuh's Rows::cone with its loops unrolled over kDimMax, so
// that a lane keeps the cone's arrays in registers; in float the same
// arithmetic, in double (the elliptic plans' Newton solve) the same
// steps on the float inputs widened; s holds the contact's dim jar values
// (zero past dim).
template <class T>
__device__ __forceinline__ void cone_zone(const Rows& rows, int r, int d,
                                          int ci, const T* s, ConeT<T>& z) {
  T Dk[kDimMax], sc[kDimMax], u[kDimMax];
  const T dn = rows.D[rows.at(r)];
  const T minv = T(1e-15);  // kMinVal
  T t2 = 0;
#pragma unroll
  for (int k = 0; k < kDimMax; ++k) {
    Dk[k] = sc[k] = u[k] = 0;
    if (k < d) {
      Dk[k] = rows.D[rows.at(r + k)];
      sc[k] = wsqrt(Dk[k] / wmax(dn, minv));
      u[k] = s[k] * sc[k];
      if (k) t2 += u[k] * u[k];
    }
  }
  const T m = rows.mu[(size_t)ci * rows.E + rows.e];
  const T n = u[0], t = wsqrt(t2), ts = wmax(t, minv);
  const bool top = n >= m * t;
  const bool bottom = m * n + t <= T(0);
  z.mid = !(top || bottom);
  z.bottom = bottom;
  z.c = z.wg = z.c2 = 0;
#pragma unroll
  for (int k = 0; k < kDimMax; ++k) {
    z.f[k] = z.w[k] = z.g[k] = z.q[k] = 0;
    z.sc[k] = sc[k];
  }
  if (bottom) {
#pragma unroll
    for (int k = 0; k < kDimMax; ++k)
      if (k < d) {
        z.f[k] = -Dk[k] * s[k];
        z.w[k] = Dk[k];
        z.c += Dk[k] * s[k] * s[k];
      }
    z.c *= T(0.5);
  } else if (z.mid) {
    const T dm = dn / (T(1) + m * m);
    const T nmt = n - m * t;
    const T c2 = dm * m * (m * t - n) / ts;
    z.c = T(0.5) * dm * nmt * nmt;
    z.wg = dm;
    z.c2 = c2;
    z.g[0] = sc[0];
    T q2 = 0;
#pragma unroll
    for (int k = 1; k < kDimMax; ++k)
      if (k < d) {
        z.g[k] = -m * u[k] / ts * sc[k];
        z.q[k] = u[k] / ts;
        q2 += z.q[k] * z.q[k];
      }
    const T rest = c2 * (T(1) - q2);
#pragma unroll
    for (int k = 1; k < kDimMax; ++k)
      if (k < d) z.w[k] = rest * sc[k] * sc[k];
#pragma unroll
    for (int k = 0; k < kDimMax; ++k)
      if (k < d) z.f[k] = -dm * nmt * z.g[k];
  }
}

// cone_zone's Hessian terms of an elliptic contact (the same arithmetic),
// written to z as they are formed: its weights w, g, q and sc (kDimMax
// each), then wg (0 outside the middle zone) and c2; s: the contact's jar
// values (dim of them).
template <class T>
__device__ void cone_terms(const Rows& rows, int r, int d, int ci,
                           const float* s, T* z) {
  T* w = z;
  T* g = z + kDimMax;
  T* q = z + 2 * kDimMax;
  T* sc = z + 3 * kDimMax;
  const T dn = rows.D[rows.at(r)];
  const T minv = T(1e-15);  // kMinVal
  T t2 = 0;
  for (int k = 0; k < kDimMax; ++k) {
    w[k] = g[k] = q[k] = sc[k] = 0;
    if (k < d) {
      const T Dk = rows.D[rows.at(r + k)];
      sc[k] = wsqrt(Dk / wmax(dn, minv));
      const T u = s[k] * sc[k];
      q[k] = u;  // u until the zone is known
      if (k) t2 += u * u;
    }
  }
  const T m = rows.mu[(size_t)ci * rows.E + rows.e];
  const T n = q[0], t = wsqrt(t2), ts = wmax(t, minv);
  const bool top = n >= m * t;
  const bool bottom = m * n + t <= T(0);
  const bool mid = !(top || bottom);
  T wg = 0, c2 = 0;
  if (bottom) {
    for (int k = 0; k < d; ++k) w[k] = rows.D[rows.at(r + k)];
  } else if (mid) {
    const T dm = dn / (T(1) + m * m);
    wg = dm;
    c2 = dm * m * (m * t - n) / ts;
    g[0] = sc[0];
    T q2 = 0;
    for (int k = 1; k < d; ++k) {
      const T u = q[k];
      g[k] = -m * u / ts * sc[k];
      q[k] = u / ts;
      q2 += q[k] * q[k];
    }
    const T rest = c2 * (T(1) - q2);
    for (int k = 1; k < d; ++k) w[k] = rest * sc[k] * sc[k];
  }
  q[0] = 0;
  if (!mid)
    for (int k = 1; k < d; ++k) q[k] = 0;
  z[4 * kDimMax] = wg;
  z[4 * kDimMax + 1] = c2;
}

// newton_core.cuh's Rows::fwc in double: the force, Hessian weight and
// cost of active scalar row r at jar value s (the elliptic plans' Newton
// solve).
__device__ void fwc_double(const Rows& rows, int r, double s, double& f,
                           double& w, double& c) {
  const size_t o = rows.at(r);
  const double d = rows.D[o];
  f = w = c = 0.0;
  if (r < rows.ne) {
    f = -d * s;
    w = d;
    c = 0.5 * d * s * s;
  } else if (r < rows.ne + rows.nfl) {
    const double flv = rows.fl[(size_t)(r - rows.ne) * rows.E + rows.e];
    const double rf = (double)rows.R[o] * flv;
    f = fmin(fmax(-d * s, -flv), flv);
    const bool quad = fabs(s) <= rf;
    w = quad ? d : 0.0;
    c = quad ? 0.5 * d * s * s : flv * fabs(s) - 0.5 * rf * flv;
  } else if (s < 0.0) {
    f = -d * s;
    w = d;
    c = 0.5 * d * s * s;
  }
}

// newton_core.cuh's falsi in double
__device__ __forceinline__ double falsi(double lo, double dlo, double hi,
                                        double dhi) {
  const double denom = dhi - dlo;
  const double a = denom > 1e-15 ? lo - dlo * (hi - lo) / denom
                                 : 0.5 * (lo + hi);
  return fmin(fmax(a, lo), hi);
}

__device__ __forceinline__ float wmin(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double wmin(double a, double b) {
  return fmin(a, b);
}

// Env-major per-env inputs held constant over a control step.
struct In {
  const float* ctrl;
  const float* qfrc_applied;
  const float* xfrc;
  const float* damp;  // (E, nv) per-env joint damping, read under DAMP_ROWS
  float* jrows;  // (E, nrows, nv | 1) the rows' J, or null (J in shared)
};

// The solve's options.
struct Opt {
  int E, iterations, ls_iterations;
  float scale, tol;
};

// ---- position stage ------------------------------------------------------
// One step of the tree walk (kinematics.kinematics): body b's frame from
// its parent's (pos, quat in, b's out), then its joints, whose anchors and
// axes go to jnt where given.
__device__ __forceinline__ void fk_body(const float* bf, const int* bi,
                                        const float* jf, const int* ji,
                                        const float* qpos, int b, float* pos,
                                        float* quat, float* jnt) {
  const float* B = bf + 20 * b;
  float r[3], q2[4];
  quat_rotate(quat, B, r);
  for (int k = 0; k < 3; ++k) pos[k] = pos[k] + r[k];
  quat_mul(quat, B + 3, q2);
  for (int k = 0; k < 4; ++k) quat[k] = q2[k];
  const int j0 = bi[4 * b + 1], nj = bi[4 * b + 2];
  for (int j = j0; j < j0 + nj; ++j) {
    const float* Jf = jf + 10 * j;
    const float* jp = Jf;
    const float* ja = Jf + 3;
    float anchor[3], axis[3];
    quat_rotate(quat, jp, r);
    for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + r[k];
    quat_rotate(quat, ja, axis);
    if (jnt)
      for (int k = 0; k < 3; ++k) {
        jnt[6 * j + k] = anchor[k];
        jnt[6 * j + 3 + k] = axis[k];
      }
    const float qd = qpos[ji[4 * j + 1]] - Jf[6];
    if (ji[4 * j]) {  // hinge
      const float half = qd * 0.5f;
      const float sh = sinf(half);
      const float aq[4] = {cosf(half), ja[0] * sh, ja[1] * sh, ja[2] * sh};
      float qh[4];
      quat_mul(quat, aq, qh);
      quat_rotate(qh, jp, r);
      for (int k = 0; k < 3; ++k) pos[k] = anchor[k] - r[k];
      for (int k = 0; k < 4; ++k) quat[k] = qh[k];
    } else {  // slide
      for (int k = 0; k < 3; ++k) pos[k] = pos[k] + axis[k] * qd;
    }
  }
}

// FK (kinematics.kinematics): the tree walk on lane 0, then each body's
// rotation matrices and inertial frame on its own lane.
__device__ void fk(const Tab& T, const Env& s, const float* qpos) {
  const int nb = s.nb;
  const float* bf = T.f(F_BODY);
  const int* bi = T.i(I_BODY);
  const float* jf = T.f(F_JNT);
  const int* ji = T.i(I_JNT);
  const int* topo = T.i(I_TOPO);
  if (s.lane == 0) {
    float* w = s.body(0);
    for (int k = 0; k < 3; ++k) w[B_XPOS + k] = 0.f;
    w[B_XQUAT] = 1.f;
    w[B_XQUAT + 1] = w[B_XQUAT + 2] = w[B_XQUAT + 3] = 0.f;
    for (int t = 0; t < nb - 1; ++t) {
      const int b = topo[t];
      const float* Pb = s.body(bi[4 * b]);
      float* Bd = s.body(b);
      float pos[3], quat[4];
      for (int k = 0; k < 3; ++k) pos[k] = Pb[B_XPOS + k];
      for (int k = 0; k < 4; ++k) quat[k] = Pb[B_XQUAT + k];
      fk_body(bf, bi, jf, ji, qpos, b, pos, quat, s.jnt);
      for (int k = 0; k < 3; ++k) Bd[B_XPOS + k] = pos[k];
      for (int k = 0; k < 4; ++k) Bd[B_XQUAT + k] = quat[k];
    }
  }
  __syncwarp();
  for (int b = s.lane; b < nb; b += kWarp) {
    float* Bd = s.body(b);
    const float* B = bf + 20 * b;
    float r[3], im[9];
    quat_to_mat(Bd + B_XQUAT, Bd + B_XMAT);
    quat_rotate(Bd + B_XQUAT, B + 7, r);
    for (int k = 0; k < 3; ++k) Bd[B_XIPOS + k] = Bd[B_XPOS + k] + r[k];
    quat_to_mat(B + 10, im);
    mat_mul3(Bd + B_XMAT, im, Bd + B_XIMAT);
  }
  __syncwarp();
}

// ---- collision -------------------------------------------------------------
// Unfused arithmetic (see the note at the top): every product and sum
// rounded on its own.
__device__ __forceinline__ float rmul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float radd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float rsub(float a, float b) {
  return __fsub_rn(a, b);
}
// (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float rdot3(float a0, float a1, float a2, float b0,
                                       float b1, float b2) {
  return radd(radd(rmul(a0, b0), rmul(a1, b1)), rmul(a2, b2));
}
__device__ __forceinline__ float rdot(const float* a, const float* b) {
  return rdot3(a[0], a[1], a[2], b[0], b[1], b[2]);
}
__device__ __forceinline__ void rsub3(const float* a, const float* b,
                                      float* o) {
  for (int i = 0; i < 3; ++i) o[i] = rsub(a[i], b[i]);
}
__device__ __forceinline__ void rcross(const float* a, const float* b,
                                       float* o) {
  o[0] = rsub(rmul(a[1], b[2]), rmul(a[2], b[1]));
  o[1] = rsub(rmul(a[2], b[0]), rmul(a[0], b[2]));
  o[2] = rsub(rmul(a[0], b[1]), rmul(a[1], b[0]));
}
__device__ __forceinline__ float rnorm(const float* a) {
  return sqrtf(rdot(a, a));
}

// world pose of a pair's geom: qp = xpos + xmat gpos, R2 = xmat R(gquat)
__device__ void geom_pose(const Env& s, int body, const float* G, float* qp,
                          float* R2) {
  const float* Bd = s.body(body);
  const float* xm = Bd + B_XMAT;
  for (int i = 0; i < 3; ++i)
    qp[i] = radd(Bd[B_XPOS + i],
                 rdot3(xm[3 * i], xm[3 * i + 1], xm[3 * i + 2], G[0], G[1],
                       G[2]));
  // quat_to_mat of the geom's quaternion
  const float w = G[3], x = G[4], y = G[5], z = G[6];
  const float xx = rmul(x, x), yy = rmul(y, y), zz = rmul(z, z);
  const float wx = rmul(w, x), wy = rmul(w, y), wz = rmul(w, z);
  const float xy = rmul(x, y), xz = rmul(x, z), yz = rmul(y, z);
  const float rg[9] = {1.f - 2.f * radd(yy, zz), 2.f * rsub(xy, wz),
                       2.f * radd(xz, wy),       2.f * radd(xy, wz),
                       1.f - 2.f * radd(xx, zz), 2.f * rsub(yz, wx),
                       2.f * rsub(xz, wy),       2.f * radd(yz, wx),
                       1.f - 2.f * radd(xx, yy)};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R2[3 * i + j] = rdot3(xm[3 * i], xm[3 * i + 1], xm[3 * i + 2], rg[j],
                            rg[3 + j], rg[6 + j]);
}

// one slot's position, depth and ids
__device__ __forceinline__ void put_slot(const Env& s, int o, const float* p,
                                         float dist, int body, int gid) {
  float* S = s.slot(o);
  for (int i = 0; i < 3; ++i) S[S_POS + i] = p[i];
  S[S_DIST] = dist;
  S[S_BODY] = fbits(body);
  S[S_GID] = fbits(gid);
}

// plane-box: the 4 deepest of 8 corners (collision.plane_box); the loops
// unrolled, so that a lane keeps the corners in registers
__device__ void box_slots(const Env& s, const float* n, const float* pp,
                          const float* qp, const float* R, const float* size,
                          int slot0, int body, int gid) {
  float pts[8][3], h[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float sx = c & 4 ? 1.f : -1.f, sy = c & 2 ? 1.f : -1.f,
                sz = c & 1 ? 1.f : -1.f;
    const float l[3] = {sx * size[0], sy * size[1], sz * size[2]};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      pts[c][i] = radd(qp[i], rdot3(R[3 * i], R[3 * i + 1], R[3 * i + 2],
                                    l[0], l[1], l[2]));
    h[c] = rdot3(n[0], n[1], n[2], pts[c][0] - pp[0], pts[c][1] - pp[1],
                 pts[c][2] - pp[2]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float d = h[0], p[3] = {pts[0][0], pts[0][1], pts[0][2]};
    int best = 0;
#pragma unroll
    for (int i = 1; i < 8; ++i)
      if (h[i] < d) {
        d = h[i];
        best = i;
        p[0] = pts[i][0];
        p[1] = pts[i][1];
        p[2] = pts[i][2];
      }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i == best) h[i] = kBig;
    float q[3];
    for (int i = 0; i < 3; ++i) q[i] = rsub(p[i], rmul(n[i], 0.5f * d));
    put_slot(s, slot0 + r, q, d, body, gid);
  }
}

// plane-cylinder (collision.plane_cylinder), for the plane-only and the
// extended collision alike: the near cap's deepest rim point, its +-120
// degree companions on that rim and the far cap's deepest rim point, as
// slot positions w[q] (halfway back along n) and depths h[q]. The rim
// direction is axis (axis . n) - n normalised, or the geom's local x axis
// where its norm is at most 1e-8 (the axis along n: every near-cap rim point
// lies at one depth). R: the cylinder's world rotation (its axis the third
// column); r, hl: its radius and half-length.
__device__ void cyl_slots(const float* n, const float* pp, const float* qp,
                          const float* R, float r, float hl, float (*w)[3],
                          float* h) {
  const float axis[3] = {R[2], R[5], R[8]};
  const float ca = rdot(n, axis);
  const float sg = ca >= 0.f ? -1.f : 1.f;
  float near[3], far_[3], d[3], e[3];
  for (int i = 0; i < 3; ++i) {
    near[i] = radd(qp[i], rmul(rmul(sg, hl), axis[i]));
    far_[i] = rsub(qp[i], rmul(rmul(sg, hl), axis[i]));
    d[i] = rsub(rmul(axis[i], ca), n[i]);
  }
  const float dn = rnorm(d);
  if (dn > 1e-8f) {
    const float l = fmaxf(dn, 1e-15f);
    for (int i = 0; i < 3; ++i) d[i] = d[i] / l;
  } else {
    for (int i = 0; i < 3; ++i) d[i] = R[3 * i];
  }
  rcross(axis, d, e);
  const float le = fmaxf(rnorm(e), 1e-15f);
  for (int i = 0; i < 3; ++i) e[i] = e[i] / le;
  const float c120 = -0.5f, s120 = 0.8660254037844386f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float p[3], h3[3];
    for (int i = 0; i < 3; ++i) {
      const float dir =
          q == 0 || q == 3 ? d[i]
          : q == 1 ? radd(rmul(c120, d[i]), rmul(s120, e[i]))
                   : rsub(rmul(c120, d[i]), rmul(s120, e[i]));
      p[i] = radd(q == 3 ? far_[i] : near[i], rmul(r, dir));
    }
    rsub3(p, pp, h3);
    h[q] = rdot(n, h3);
    for (int i = 0; i < 3; ++i)
      w[q][i] = rsub(p[i], rmul(n[i], rmul(0.5f, h[q])));
  }
}

// the mesh region (in the J region, free between the smooth stage and the
// rows): keys (pmax), support depths (pmax), support vertices (pmax, int),
// the selected pairs (kmax, int) and their keys (kmax)
struct MeshBuf {
  float* key;
  float* d0;
  int* i0;
  int* sel;
  float* mk;
};
__device__ __forceinline__ MeshBuf mesh_buf(const Env& s) {
  return MeshBuf{s.mesh, s.mesh + s.pmax, (int*)(s.mesh + 2 * s.pmax),
                 (int*)(s.mesh + 3 * s.pmax), s.mesh + 3 * s.pmax + s.kmax};
}

// The plane-mesh group, of the plane-only and the extended collision alike:
// per pair its support depth (or the conservative bound), the top-k by
// depth - margin, then the manifold of each selected pair into slots off + 3 r
// + f: position, depth, the hull's body and geom (an inactive rank: pair 0's
// ids and the 1e10 depth). Over the plan's F_MESH, I_MESH and F_VERT; n and pp
// the plane's normal and a point on it. The selection (sel, mk) stays in the
// mesh buffer for the caller.
__device__ void mesh_group(const Tab& T, const Env& s, const float* n,
                           const float* pp, int P, int kmesh, int offmesh) {
  const MeshBuf mb = mesh_buf(s);
  const float* mf = T.f(F_MESH);
  const int* mi = T.i(I_MESH);
  const float* vert = T.f(F_VERT);
  for (int p = s.lane; p < P; p += kWarp) {
    const float* G = mf + 16 * p;
    const int* Gi = mi + 5 * p;
    float qp[3], R[9];
    geom_pose(s, Gi[0], G, qp, R);
    // the plane in the mesh frame: height a.v + b
    float a[3];
    for (int j = 0; j < 3; ++j)
      a[j] = rdot3(R[j], R[3 + j], R[6 + j], n[0], n[1], n[2]);
    const float b = rdot3(n[0], n[1], n[2], qp[0] - pp[0], qp[1] - pp[1],
                          qp[2] - pp[2]);
    const float margin = G[7];
    float lb = b - 1e-6f;
    lb = lb + fminf(a[0] * G[9], a[0] * G[12]);
    lb = lb + fminf(a[1] * G[10], a[1] * G[13]);
    lb = lb + fminf(a[2] * G[11], a[2] * G[14]);
    float d0 = lb;
    int i0 = 0;
    if (lb < margin) {
      const int V = Gi[3];
      const float* tb = vert + Gi[2];
      d0 = INFINITY;
      for (int v = 0; v < V; ++v) {
        const float h =
            radd(rdot3(tb[v], tb[V + v], tb[2 * V + v], a[0], a[1], a[2]), b);
        if (h < d0) {
          d0 = h;
          i0 = v;
        }
      }
    }
    mb.d0[p] = d0;
    mb.i0[p] = i0;
    mb.key[p] = d0 - margin;
  }
  __syncwarp();
  wtopk(s, mb.key, P, kmesh, mb.sel, mb.mk);
  for (int r = s.lane; r < kmesh; r += kWarp) {
    const int best = mb.sel[r];
    const int o = offmesh + 3 * r;
    if (!(mb.mk[r] < 0.f)) {  // inactive slot: pair 0's ids, the 1e10 depth
      const float z[3] = {0.f, 0.f, 0.f};
      for (int f = 0; f < 3; ++f) put_slot(s, o + f, z, kBig, mi[0], mi[1]);
      continue;
    }
    const float* G = mf + 16 * best;
    const int* Gi = mi + 5 * best;
    float qp[3], R[9], a[3];
    geom_pose(s, Gi[0], G, qp, R);
    for (int j = 0; j < 3; ++j)
      a[j] = rdot3(R[j], R[3 + j], R[6 + j], n[0], n[1], n[2]);
    const float b = rdot3(n[0], n[1], n[2], qp[0] - pp[0], qp[1] - pp[1],
                          qp[2] - pp[2]);
    const float margin = G[7], dedupe2 = G[8];
    const int V = Gi[3], D = Gi[4], v0 = mb.i0[best];
    const float* tb = vert + Gi[2];
    const float d0 = mb.d0[best];
    // the support vertex and the first two hull-graph neighbours below the
    // margin and outside the dedupe radius (plane_mesh.cu select_kernel),
    // held in registers
    float d[3] = {d0, kBig, kBig};
    float vs[9] = {tb[v0], tb[V + v0], tb[2 * V + v0], 0.f, 0.f, 0.f,
                   0.f, 0.f, 0.f};
    const float half = 0.5f * d0;
    int cnt = 0;
    for (int c = 0; c < D && cnt < 2; ++c) {
      const float cx = tb[(3 + c) * V + v0];
      const float cy = tb[(3 + D + c) * V + v0];
      const float cz = tb[(3 + 2 * D + c) * V + v0];
      if (cx == vs[0] && cy == vs[1] && cz == vs[2]) continue;  // unused
      const float hc = radd(rdot3(cx, cy, cz, a[0], a[1], a[2]), b);
      const float ex = radd(cx - vs[0], rmul(half, a[0]));
      const float ey = radd(cy - vs[1], rmul(half, a[1]));
      const float ez = radd(cz - vs[2], rmul(half, a[2]));
      if (hc < margin && rdot3(ex, ey, ez, ex, ey, ez) >= dedupe2) {
        if (cnt == 0) {
          d[1] = hc;
          vs[3] = cx;
          vs[4] = cy;
          vs[5] = cz;
        } else {
          d[2] = hc;
          vs[6] = cx;
          vs[7] = cy;
          vs[8] = cz;
        }
        ++cnt;
      }
    }
    // world slot positions w = qp + R v - n d / 2 (plane_mesh.cu topk)
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      const float hf = 0.5f * d[f];
      float p[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float w =
            radd(radd(radd(qp[i], rmul(R[3 * i], vs[3 * f])),
                      rmul(R[3 * i + 1], vs[3 * f + 1])),
                 rmul(R[3 * i + 2], vs[3 * f + 2]));
        p[i] = rsub(w, rmul(n[i], hf));
      }
      put_slot(s, o + f, p, d[f], Gi[0], Gi[1]);
    }
  }
  __syncwarp();
}

__device__ void collide(const Tab& T, const Env& s) {
  const float* con = T.f(F_CON);
  const float* n = con;
  const float* pp = con + 3;
  const MeshBuf mb = mesh_buf(s);
  // the plane-box and the plane-cylinder group, in that order, through one
  // loop: k == P takes the pairs in order, else the top-k by the exact
  // support distance minus the margin (collision.midphase_key); each pair
  // row holds the geom's pose, its size and the margin (B[10])
#pragma unroll 1
  for (int cyl = 0; cyl < 2; ++cyl) {
    const int P = T.h(cyl ? NCYL : NBOX), k = T.h(cyl ? KCYL : KBOX);
    if (!P) continue;
    const int off = T.h(cyl ? OFFCYL : OFFBOX);
    const float* gf = T.f(cyl ? F_CYL : F_BOX);
    const int* gi = T.i(cyl ? I_CYL : I_BOX);
    if (k < P) {
      for (int q = s.lane; q < P; q += kWarp) {
        const float* B = gf + 12 * q;
        float qp[3], R[9];
        geom_pose(s, gi[2 * q], B, qp, R);
        const float h = rdot3(n[0], n[1], n[2], qp[0] - pp[0], qp[1] - pp[1],
                              qp[2] - pp[2]);
        float supp = 0.f;
        if (cyl) {
          const float ca = fabsf(rdot3(n[0], n[1], n[2], R[2], R[5], R[8]));
          supp = radd(rmul(B[8], ca),
                      rmul(B[7], sqrtf(fmaxf(rsub(1.f, rmul(ca, ca)), 0.f))));
        } else {
          for (int j = 0; j < 3; ++j)
            supp = radd(supp, rmul(fabsf(rdot3(n[0], n[1], n[2], R[j],
                                               R[3 + j], R[6 + j])),
                                   B[7 + j]));
        }
        mb.key[q] = rsub(rsub(h, supp), B[10]);
      }
      __syncwarp();
      wtopk(s, mb.key, P, k, mb.sel, mb.mk);
    }
    for (int r = s.lane; r < k; r += kWarp) {
      const int p = k < P ? mb.sel[r] : r;
      const float* B = gf + 12 * p;
      float qp[3], R[9];
      geom_pose(s, gi[2 * p], B, qp, R);
      if (cyl) {
        float w[4][3], h[4];
        cyl_slots(n, pp, qp, R, B[7], B[8], w, h);
        for (int q = 0; q < 4; ++q)
          put_slot(s, off + 4 * r + q, w[q], h[q], gi[2 * p], gi[2 * p + 1]);
      } else {
        box_slots(s, n, pp, qp, R, B + 7, off + 4 * r, gi[2 * p],
                  gi[2 * p + 1]);
      }
    }
    __syncwarp();
  }
  // the plane-mesh group
  if (T.h(NMESH))
    mesh_group(T, s, n, pp, T.h(NMESH), T.h(KMESH), T.h(OFFMESH));
}

// ---- extended collision (mega_ell) ------------------------------------------
// The counterpart of pallas_fk.collide_env_block_ext (:1714-2039) over the
// plan's ColPlanExt tables: per group (I_XGRP [kind k slots P offset first
// condim -], F_XGRP [margin includemargin solref(2) solimp(5) friction(5)])
// its pairs (I_XPAIR [gid1 body1 gid2 body2], F_XPAIR: both sides' [gpos(3)
// gquat(4) size(3) rbound] and the slot's invweight), ranked when k < P by
// the midphase key of collision.midphase_key (first index on ties), then
// the narrowphase of the selected pairs, the arithmetic of the port's
// collision.py (its plain version) written unfused. Every slot gets the
// generic contact fields: pos, frame, dist, both geoms and bodies, its
// group (statics) and invweight.

__device__ __forceinline__ float clip(float x, float lim) {
  return fminf(fmaxf(x, -lim), lim);
}

// make_frame: rows n, t1, t2 (mju_makeFrame)
__device__ void make_frame(const float* n, float* fr) {
  const float ax[3] = {0.f, fabsf(n[1]) < 0.5f ? 1.f : 0.f,
                       fabsf(n[1]) < 0.5f ? 0.f : 1.f};
  const float nd = rdot(n, ax);
  float t1[3];
  for (int i = 0; i < 3; ++i) t1[i] = rsub(ax[i], rmul(n[i], nd));
  const float ln = fmaxf(rnorm(t1), 1e-15f);
  for (int i = 0; i < 3; ++i) t1[i] = t1[i] / ln;
  for (int i = 0; i < 3; ++i) {
    fr[i] = n[i];
    fr[3 + i] = t1[i];
  }
  rcross(n, t1, fr + 6);
}

// collision._frame_with_axis: first tangent = axis projected into the
// contact plane, make_frame where axis || n
__device__ void frame_with_axis(const float* n, const float* axis,
                                float* fr) {
  const float na = rdot(n, axis);
  float t1[3];
  for (int i = 0; i < 3; ++i) t1[i] = rsub(axis[i], rmul(n[i], na));
  const float ln = rnorm(t1);
  if (!(ln > 1e-8f)) {
    make_frame(n, fr);
    return;
  }
  const float l = fmaxf(ln, 1e-15f);
  for (int i = 0; i < 3; ++i) {
    fr[i] = n[i];
    fr[3 + i] = t1[i] / l;
  }
  rcross(n, fr + 3, fr + 6);
}

// collision._sphere_sphere_core: pos, dist, frame
__device__ void sphere_core(const float* c1, float r1, const float* c2,
                            float r2, float* pos, float& dist, float* fr) {
  float d[3], n[3];
  rsub3(c2, c1, d);
  const float ln = rnorm(d), l = fmaxf(ln, 1e-15f);
  for (int i = 0; i < 3; ++i) n[i] = d[i] / l;
  dist = rsub(rsub(ln, r1), r2);
  for (int i = 0; i < 3; ++i)
    pos[i] = rmul(0.5f, rsub(radd(radd(c1[i], rmul(n[i], r1)), c2[i]),
                             rmul(n[i], r2)));
  make_frame(n, fr);
}

// collision._seg_seg_closest: closest points of p +- l d
__device__ void seg_seg(const float* p1, const float* d1, float l1,
                        const float* p2, const float* d2, float l2, float* c1,
                        float* c2) {
  float r[3];
  rsub3(p1, p2, r);
  const float a = rdot(d1, d1), e = rdot(d2, d2), f = rdot(d2, r);
  const float c = rdot(d1, r), b = rdot(d1, d2);
  const float denom = rsub(rmul(a, e), rmul(b, b));
  float sp = fabsf(denom) > 1e-12f
                 ? rsub(rmul(b, f), rmul(c, e)) / fmaxf(denom, 1e-15f)
                 : 0.f;
  sp = clip(sp, l1);
  const float t = clip(radd(rmul(b, sp), f) / fmaxf(e, 1e-15f), l2);
  sp = clip(rsub(rmul(b, t), c) / fmaxf(a, 1e-15f), l1);
  for (int i = 0; i < 3; ++i) {
    c1[i] = radd(p1[i], rmul(sp, d1[i]));
    c2[i] = radd(p2[i], rmul(t, d2[i]));
  }
}

enum ExtKind {
  PLANE_SPHERE, PLANE_CAPSULE, PLANE_CYLINDER, PLANE_BOX, SPHERE_SPHERE,
  SPHERE_CAPSULE, SPHERE_BOX, CAPSULE_CAPSULE, PLANE_MESH
};

// midphase key of one pair (collision.midphase_key), minus the margin
__device__ float ext_key(int kind, const float* p1, const float* R1,
                         const float* p2, const float* R2, const float* sz1,
                         const float* sz2, float rb1, float rb2,
                         float margin) {
  float mid;
  if (kind <= PLANE_BOX) {
    const float n[3] = {R1[2], R1[5], R1[8]};
    float d[3];
    rsub3(p2, p1, d);
    const float h = rdot(n, d);
    float supp;
    if (kind == PLANE_SPHERE) {
      supp = sz2[0];
    } else if (kind == PLANE_BOX) {
      supp = 0.f;
      for (int j = 0; j < 3; ++j)
        supp = radd(supp, rmul(fabsf(rdot3(n[0], n[1], n[2], R2[j], R2[3 + j],
                                           R2[6 + j])),
                               sz2[j]));
    } else {
      const float ca =
          fabsf(rdot3(n[0], n[1], n[2], R2[2], R2[5], R2[8]));
      supp = kind == PLANE_CAPSULE
                 ? radd(rmul(sz2[1], ca), sz2[0])
                 : radd(rmul(sz2[1], ca),
                        rmul(sz2[0], sqrtf(fmaxf(rsub(1.f, rmul(ca, ca)),
                                                 0.f))));
    }
    mid = rsub(h, supp);
  } else {
    float d[3];
    rsub3(p2, p1, d);
    mid = rsub(rsub(rnorm(d), rb1), rb2);
  }
  return rsub(mid, margin);
}

// one generic slot's position, depth and frame
__device__ __forceinline__ void put_gen(const Env& s, int o, const float* p,
                                        float dist, const float* fr) {
  float* S = s.slot(o);
  for (int i = 0; i < 3; ++i) S[S_POS + i] = p[i];
  S[S_DIST] = dist;
  for (int i = 0; i < 9; ++i) S[S_FRAME + i] = fr[i];
}

// The slots of one selected pair, from slot o on.
__device__ void ext_slots(const Env& s, int kind, const float* pp,
                          const float* R1, const float* qp, const float* R2,
                          const float* s1, const float* s2, int o) {
  if (kind <= PLANE_BOX) {
    const float n[3] = {R1[2], R1[5], R1[8]};
    const float axis[3] = {R2[2], R2[5], R2[8]};
    float fr[9];
    if (kind == PLANE_CAPSULE)
      frame_with_axis(n, axis, fr);
    else
      make_frame(n, fr);
    if (kind == PLANE_SPHERE || kind == PLANE_CAPSULE) {
      const int nsl = kind == PLANE_SPHERE ? 1 : 2;
      for (int q = 0; q < nsl; ++q) {
        float c[3], d[3], p[3];
        const float off = kind == PLANE_SPHERE ? 0.f
                                               : rmul(q ? -1.f : 1.f, s2[1]);
        for (int i = 0; i < 3; ++i)
          c[i] = kind == PLANE_SPHERE ? qp[i] : radd(qp[i], rmul(off, axis[i]));
        rsub3(c, pp, d);
        const float dist = rsub(rdot(n, d), s2[0]);
        const float depth = radd(s2[0], rmul(0.5f, dist));
        for (int i = 0; i < 3; ++i) p[i] = rsub(c[i], rmul(n[i], depth));
        put_gen(s, o + q, p, dist, fr);
      }
      return;
    }
    if (kind == PLANE_CYLINDER) {
      float w[4][3], h[4];
      cyl_slots(n, pp, qp, R2, s2[0], s2[1], w, h);
      for (int q = 0; q < 4; ++q) put_gen(s, o + q, w[q], h[q], fr);
      return;
    }
    // plane-box: the four deepest corners (collision.plane_box)
    box_slots(s, n, pp, qp, R2, s2, o, 0, 0);
    for (int q = 0; q < 4; ++q)
      for (int i = 0; i < 9; ++i) s.slot(o + q)[S_FRAME + i] = fr[i];
    return;
  }
  float pos[3], dist, fr[9];
  if (kind == SPHERE_SPHERE) {
    sphere_core(pp, s1[0], qp, s2[0], pos, dist, fr);
  } else if (kind == SPHERE_CAPSULE) {
    const float axis[3] = {R2[2], R2[5], R2[8]};
    float d[3], c2[3];
    rsub3(pp, qp, d);
    const float t = fminf(fmaxf(rdot(d, axis), -s2[1]), s2[1]);
    for (int i = 0; i < 3; ++i) c2[i] = radd(qp[i], rmul(t, axis[i]));
    sphere_core(pp, s1[0], c2, s2[0], pos, dist, fr);
  } else if (kind == SPHERE_BOX) {
    // collision.sphere_box: the closest surface point, or with the centre
    // inside the nearest face (first axis on ties)
    const float r = s1[0];
    float d[3], loc[3], cl[3], cw[3];
    rsub3(pp, qp, d);
    for (int i = 0; i < 3; ++i)
      loc[i] = rdot3(R2[i], R2[3 + i], R2[6 + i], d[0], d[1], d[2]);
    bool inside = true;
    int ax = 0;
    float gmin = 0.f;
    for (int i = 0; i < 3; ++i) {
      inside = inside && fabsf(loc[i]) < s2[i];
      const float gap = rsub(s2[i], fabsf(loc[i]));
      if (i == 0 || gap < gmin) {
        gmin = gap;
        ax = i;
      }
    }
    for (int i = 0; i < 3; ++i) {
      const float sgn = loc[i] > 0.f ? 1.f : (loc[i] < 0.f ? -1.f : 0.f);
      cl[i] = inside ? (i == ax ? rmul(sgn, s2[i]) : loc[i])
                     : fminf(fmaxf(loc[i], -s2[i]), s2[i]);
    }
    for (int i = 0; i < 3; ++i)
      cw[i] = radd(qp[i], rdot3(R2[3 * i], R2[3 * i + 1], R2[3 * i + 2],
                                cl[0], cl[1], cl[2]));
    float dd[3], n[3];
    rsub3(cw, pp, dd);
    const float ln = rnorm(dd), l = fmaxf(ln, 1e-15f);
    for (int i = 0; i < 3; ++i) n[i] = inside ? -(dd[i] / l) : dd[i] / l;
    dist = inside ? -radd(ln, r) : rsub(ln, r);
    for (int i = 0; i < 3; ++i)
      pos[i] = rmul(0.5f, radd(radd(pp[i], rmul(n[i], r)), cw[i]));
    make_frame(n, fr);
  } else {  // capsule-capsule: one contact, the second slot inactive
    const float a1[3] = {R1[2], R1[5], R1[8]};
    const float a2[3] = {R2[2], R2[5], R2[8]};
    float c1[3], c2[3];
    seg_seg(pp, a1, s1[1], qp, a2, s2[1], c1, c2);
    sphere_core(c1, s1[0], c2, s2[0], pos, dist, fr);
    const float z[3] = {0.f, 0.f, 0.f};
    put_gen(s, o + 1, z, kBig, fr);
  }
  put_gen(s, o, pos, dist, fr);
}

// The generic fields of a plane-mesh group's slots after mesh_group: the
// plane's frame, both geoms and bodies, the group and the hull's invweight
// of each selected pair (its row of I_XPAIR / F_XPAIR, in the mesh tables'
// pair order); an inactive rank keeps the plain version's convention (pair
// 0's ids, the canonical frame).
__device__ void mesh_generic(const Env& s, const int* pi, const float* pf,
                             const float* n, int g, int k, int off) {
  const MeshBuf mb = mesh_buf(s);
  for (int r = s.lane; r < k; r += kWarp) {
    const bool on = mb.mk[r] < 0.f;
    const int p = on ? mb.sel[r] : 0;
    const int* I = pi + 4 * p;
    float fr[9] = {0.f, 0.f, 1.f, 0.f, 1.f, 0.f, -1.f, 0.f, 0.f};
    if (on) make_frame(n, fr);
    for (int f = 0; f < 3; ++f) {
      float* S = s.slot(off + 3 * r + f);
      for (int i = 0; i < 9; ++i) S[S_FRAME + i] = fr[i];
      S[S_GID1] = fbits(I[0]);
      S[S_BODY1] = fbits(I[1]);
      S[S_GID] = fbits(I[2]);
      S[S_BODY] = fbits(I[3]);
      S[S_GRP] = fbits(g);
      S[S_IW] = pf[24 * p + 22];
    }
  }
  __syncwarp();
}

// The extended collision (see above): per group, lane per pair for the
// keys (k < P) and lane per selected pair for the narrowphase; the
// plane-mesh group through mesh_group (the plan's hull tables, its pairs in
// their order), against the plane of its first pair.
__device__ void collide_ext(const Tab& T, const Env& s) {
  const int ng = T.h(NXGRP);
  const int* gi = T.i(I_XGRP);
  const int* pi = T.i(I_XPAIR);
  const float* pf = T.f(F_XPAIR);
  const float* gf = T.f(F_XGRP);
  const MeshBuf mb = mesh_buf(s);
  for (int g = 0; g < ng; ++g) {
    const int* G = gi + 8 * g;
    const int kind = G[0], k = G[1], slots = G[2], P = G[3], off = G[4],
              first = G[5];
    const float margin = gf[16 * g];
    if (kind == PLANE_MESH) {
      float pp[3], R1[9];
      geom_pose(s, pi[4 * first + 1], pf + 24 * first, pp, R1);
      const float n[3] = {R1[2], R1[5], R1[8]};
      mesh_group(T, s, n, pp, P, k, off);
      mesh_generic(s, pi + 4 * first, pf + 24 * first, n, g, k, off);
      continue;
    }
    if (k < P) {
      for (int q = s.lane; q < P; q += kWarp) {
        const float* F = pf + 24 * (first + q);
        const int* I = pi + 4 * (first + q);
        float p1[3], R1[9], p2[3], R2[9];
        geom_pose(s, I[1], F, p1, R1);
        geom_pose(s, I[3], F + 11, p2, R2);
        mb.key[q] = ext_key(kind, p1, R1, p2, R2, F + 7, F + 18, F[10],
                            F[21], margin);
      }
      __syncwarp();
      wtopk(s, mb.key, P, k, mb.sel, mb.mk);
    }
    for (int rk = s.lane; rk < k; rk += kWarp) {
      const int p = k < P ? mb.sel[rk] : rk;  // k == P: pairs in order
      const int* I = pi + 4 * (first + p);
      const float* F = pf + 24 * (first + p);
      float p1[3], R1[9], p2[3], R2[9];
      geom_pose(s, I[1], F, p1, R1);
      geom_pose(s, I[3], F + 11, p2, R2);
      const int o = off + slots * rk;
      ext_slots(s, kind, p1, R1, p2, R2, F + 7, F + 18, o);
      for (int q = 0; q < slots; ++q) {
        float* S = s.slot(o + q);
        S[S_GID1] = fbits(I[0]);
        S[S_BODY1] = fbits(I[1]);
        S[S_GID] = fbits(I[2]);
        S[S_BODY] = fbits(I[3]);
        S[S_GRP] = fbits(g);
        S[S_IW] = F[22];
      }
    }
    __syncwarp();
  }
}


// ---- the smooth stage --------------------------------------------------------
// com of the tree, cinert, cdof (kinematics.com_pos): the com on lane 0,
// then lane per body and per joint.
__device__ void com_pos(const Tab& T, const Env& s) {
  const int nb = s.nb, njnt = T.h(NJNT);
  const float* bf = T.f(F_BODY);
  const int* ji = T.i(I_JNT);
  float* com = s.misc + kMiscCom;
  if (s.lane == 0) {
    float wsum3[3] = {0.f, 0.f, 0.f}, msum = 0.f;
    for (int b = 1; b < nb; ++b) {
      const float m = bf[20 * b + 14];
      for (int k = 0; k < 3; ++k) wsum3[k] += m * s.body(b)[B_XIPOS + k];
      msum += m;
    }
    for (int k = 0; k < 3; ++k) com[k] = wsum3[k] / fmaxf(msum, 1e-12f);
  }
  __syncwarp();
  for (int b = s.lane; b < nb; b += kWarp) {
    float* ci = s.body(b) + B_CINERT;
    if (b == 0) {  // the world: no mass
      for (int k = 0; k < 10; ++k) ci[k] = 0.f;
      continue;
    }
    const float* B = bf + 20 * b;
    const float m = B[14];
    const float* Id = B + 15;
    const float* R = s.body(b) + B_XIMAT;
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = s.body(b)[B_XIPOS + k] - com[k];
    const float c2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    auto iw = [&](int i, int k) {
      const float v = R[3 * i] * Id[0] * R[3 * k] +
                      R[3 * i + 1] * Id[1] * R[3 * k + 1] +
                      R[3 * i + 2] * Id[2] * R[3 * k + 2];
      return v + m * ((i == k ? c2 : 0.f) - c[i] * c[k]);
    };
    ci[0] = iw(0, 0);
    ci[1] = iw(1, 1);
    ci[2] = iw(2, 2);
    ci[3] = iw(0, 1);
    ci[4] = iw(0, 2);
    ci[5] = iw(1, 2);
    for (int k = 0; k < 3; ++k) ci[6 + k] = m * c[k];
    ci[9] = m;
  }
  for (int j = s.lane; j < njnt; j += kWarp) {
    const int d = ji[4 * j + 2];
    const float* ax = s.jnt + 6 * j + 3;
    float* cd = s.cdof + 6 * d;
    if (ji[4 * j]) {
      float off[3], lin[3];
      for (int k = 0; k < 3; ++k) off[k] = com[k] - s.jnt[6 * j + k];
      cross(ax, off, lin);
      for (int k = 0; k < 3; ++k) {
        cd[k] = ax[k];
        cd[3 + k] = lin[k];
      }
    } else {
      for (int k = 0; k < 3; ++k) {
        cd[k] = 0.f;
        cd[3 + k] = ax[k];
      }
    }
  }
  __syncwarp();
}

// The CRB mass matrix with armature (inertia.crb): the subtree sums lane
// per component, each entry on its own lane.
__device__ void crb(const Tab& T, const Env& s) {
  const int nb = s.nb, nv = s.nv;
  const int* topo = T.i(I_TOPO);
  const int* bi = T.i(I_BODY);
  const int* dof_body = T.i(I_DOF);
  const int* anc = T.i(I_ANC);
  const float* df = T.f(F_DOF);
  for (int b = s.lane; b < nb; b += kWarp)
    for (int k = 0; k < 10; ++k)
      s.body(b)[B_CRB + k] = s.body(b)[B_CINERT + k];
  __syncwarp();
  if (s.lane < 10)  // children into parents
    for (int t = nb - 2; t >= 0; --t) {
      const int b = topo[t], p = bi[4 * b];
      s.body(p)[B_CRB + s.lane] += s.body(b)[B_CRB + s.lane];
    }
  __syncwarp();
  float* buf = s.scr;  // crb[dof_body[a]] cdof[a] (nv x 6)
  for (int a = s.lane; a < nv; a += kWarp)
    inert_mul(s.body(dof_body[a]) + B_CRB, s.cdof + 6 * a, buf + 6 * a);
  __syncwarp();
  const int ntri = nv * (nv + 1) / 2;
  int a = 0, b = s.lane;  // entry t = a (a + 1) / 2 + b, b <= a
  while (b > a) b -= ++a;
  for (int t = s.lane; t < ntri; t += kWarp) {
    float m = 0.f;
    if (anc[a * nv + b]) {
      const float* u = buf + 6 * a;
      const float* w = s.cdof + 6 * b;
      m = u[0] * w[0];
      for (int i = 1; i < 6; ++i) m += u[i] * w[i];
    }
    if (a == b) m += df[2 * a + 1];
    s.M[a * nv + b] = m;
    s.M[b * nv + a] = m;
    b += kWarp;
    while (b > a) b -= ++a;
  }
  __syncwarp();
}

// Velocity stage, passive, motors and xfrc: qfrc_smooth into V_QFS (the
// muscles add theirs after). ctrl (nu), qfrc_applied (nv) and xfrc
// (nbody, 6) are this env's inputs (global); DAMP: damp (nv) is its joint
// damping (DAMP_ROWS), else the plan's F_DOF column serves and damp is not
// read.
template <bool DAMP>
__device__ void smooth_force(const Tab& T, const Env& s, const float* ctrl,
                             const float* qfrc_applied, const float* xfrc,
                             const float* damp, const float* qpos,
                             const float* qvel) {
  const int nb = s.nb, nv = s.nv, nmot = T.h(NMOT), njnt = T.h(NJNT);
  const int flags = T.h(FLAGS);
  const int* topo = T.i(I_TOPO);
  const int* bi = T.i(I_BODY);
  const int* dof_body = T.i(I_DOF);
  const int* anc = T.i(I_ANC);
  const int* dmask = T.i(I_DMASK);
  const float* con = T.f(F_CON);
  const float* com = s.misc + kMiscCom;
  float* cdd = s.cdof + 6 * nv;  // cdof_dot
  // com_vel: cvel of every body, cdof_dot from the strict-ancestor velocity
  float* vd = s.scr;  // cdof[d] qvel[d] (nv x 6)
  for (int d = s.lane; d < nv; d += kWarp)
    for (int i = 0; i < 6; ++i) vd[6 * d + i] = s.cdof[6 * d + i] * qvel[d];
  __syncwarp();
  for (int b = s.lane; b < nb; b += kWarp)
    for (int i = 0; i < 6; ++i) {
      float v = 0.f;
      for (int d = 0; d < nv; ++d)
        if (dmask[b * nv + d]) v += vd[6 * d + i];
      s.body(b)[B_CVEL + i] = v;
    }
  for (int d = s.lane; d < nv; d += kWarp) {
    float vb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < nv; ++k)
      if (k != d && anc[d * nv + k])
        for (int i = 0; i < 6; ++i) vb[i] += vd[6 * k + i];
    float a[3], l1[3], l2[3];
    cross(vb, s.cdof + 6 * d, a);
    cross(vb, s.cdof + 6 * d + 3, l1);
    cross(vb + 3, s.cdof + 6 * d, l2);
    for (int i = 0; i < 3; ++i) {
      cdd[6 * d + i] = a[i];
      cdd[6 * d + 3 + i] = l1[i] + l2[i];
    }
  }
  __syncwarp();
  // rne with zero acceleration: cfrc per body, subtree sums, bias
  for (int b = s.lane; b < nb; b += kWarp) {
    float* Bd = s.body(b);
    float cacc[6];
    for (int i = 0; i < 3; ++i) cacc[i] = 0.f;
    for (int i = 0; i < 3; ++i) cacc[3 + i] = -con[kConGravity + i];
    float ad[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < nv; ++d)
      if (dmask[b * nv + d])
        for (int i = 0; i < 6; ++i) ad[i] += cdd[6 * d + i] * qvel[d];
    for (int i = 0; i < 6; ++i) cacc[i] = cacc[i] + ad[i];
    float ia[6], iv[6], a1[3], a2[3], l[3];
    inert_mul(Bd + B_CINERT, cacc, ia);
    inert_mul(Bd + B_CINERT, Bd + B_CVEL, iv);
    cross(Bd + B_CVEL, iv, a1);
    cross(Bd + B_CVEL + 3, iv + 3, a2);
    cross(Bd + B_CVEL, iv + 3, l);
    for (int i = 0; i < 3; ++i) {
      Bd[B_CFRC + i] = ia[i] + (a1[i] + a2[i]);
      Bd[B_CFRC + 3 + i] = ia[3 + i] + l[i];
    }
  }
  __syncwarp();
  if (s.lane < 6)
    for (int t = nb - 2; t >= 0; --t) {
      const int b = topo[t], p = bi[4 * b];
      s.body(p)[B_CFRC + s.lane] += s.body(b)[B_CFRC + s.lane];
    }
  // passive forces (one joint per dof) and the motors' into scratch
  float* passive = s.vec(V_G);
  float* actf = s.vec(V_DX);
  for (int d = s.lane; d < nv; d += kWarp) passive[d] = actf[d] = 0.f;
  __syncwarp();
  if (flags & PASSIVE) {
    const float* jf = T.f(F_JNT);
    const int* ji = T.i(I_JNT);
    const float* dfp = T.f(F_DOF);
    for (int j = s.lane; j < njnt; j += kWarp) {
      const float* Jf = jf + 10 * j;
      const int d = ji[4 * j + 2];
      passive[d] = (passive[d] + -Jf[7] * (qpos[ji[4 * j + 1]] - Jf[8])) -
                   (DAMP ? damp[d] : dfp[2 * d]) * qvel[d];
    }
  }
  if (nmot && s.lane == 0) {  // the joint actuators: ctrl index ai[8 m + 3]
    const float* af = T.f(F_ACT);
    const int* ai = T.i(I_ACT);
    for (int m = 0; m < nmot; ++m) {
      const float* A = af + 12 * m;
      const int* B = ai + 8 * m;
      float c = ctrl[B[3]];
      if ((flags & CLAMPCTRL) && B[1]) c = fminf(fmaxf(c, A[2]), A[3]);
      float f = affine_force(A, B, c, qpos, qvel);
      if (B[2]) f = fminf(fmaxf(f, A[4]), A[5]);
      if (!(flags & ACTUATION)) f = 0.f;
      actf[B[0]] += f * A[0];
    }
  }
  __syncwarp();
  // xfrc projection (forward._xfrc_projection); zero wrenches add nothing
  float* qfs = s.vec(V_QFS);
  for (int d = s.lane; d < nv; d += kWarp) {
    float xf = 0.f;
    for (int b = 1; b < nb; ++b) {
      const float* w = xfrc + (size_t)b * 6;
      bool any = false;
      for (int i = 0; i < 6; ++i) any |= w[i] != 0.f;
      if (!any || !dmask[b * nv + d]) continue;
      float off[3], oxf[3], te[3];
      for (int k = 0; k < 3; ++k) off[k] = s.body(b)[B_XIPOS + k] - com[k];
      cross(off, w, oxf);
      for (int k = 0; k < 3; ++k) te[k] = w[3 + k] + oxf[k];
      const float* u = s.cdof + 6 * d;
      xf += u[0] * te[0] + u[1] * te[1] + u[2] * te[2] + u[3] * w[0] +
            u[4] * w[1] + u[5] * w[2];
    }
    const float* f6 = s.body(dof_body[d]) + B_CFRC;
    const float* cd = s.cdof + 6 * d;
    float bias = cd[0] * f6[0];
    for (int i = 1; i < 6; ++i) bias += cd[i] * f6[i];
    qfs[d] = passive[d] - bias + actf[d] + qfrc_applied[d] + xf;
  }
  __syncwarp();
}

// ---- tendons and muscles ---------------------------------------------------
// One segment of a tendon path: from site A (on body ba) to site B (on bb),
// the sites computed from the body frames; u the unit direction and cA, cB
// the com-referenced endpoint offsets crossed with u, so that
// u . (J_B - J_A) qvel = cB . w_B + u . v_B - (cA . w_A + u . v_A) with
// (w, v) a body's cvel (tendon.py's segment Jacobian). In the muscle
// block's scratch a segment is SEG_W floats: len, u, cA, cB, ba, bb.
struct Seg {
  float len, u[3], cA[3], cB[3];
  int ba, bb;
};
constexpr int kSegW = 12;  // ops/plan.py SEG_W

__device__ void segment(const Tab& T, const Env& s, const int* sg, Seg& g) {
  const float* sf = T.f(F_SITE);
  const int* si = T.i(I_SITE);
  const float* com = s.misc + kMiscCom;
  float p[2][3];
  const int b2[2] = {si[sg[0]], si[sg[1]]};
  for (int e = 0; e < 2; ++e) {
    const float* l = sf + 4 * sg[e];
    const float* Bd = s.body(b2[e]);
    const float* R = Bd + B_XMAT;
    for (int i = 0; i < 3; ++i)
      p[e][i] = Bd[B_XPOS + i] + (R[3 * i] * l[0] + R[3 * i + 1] * l[1] +
                                  R[3 * i + 2] * l[2]);
  }
  float d[3], offA[3], offB[3];
  for (int i = 0; i < 3; ++i) {
    d[i] = p[1][i] - p[0][i];
    offA[i] = p[0][i] - com[i];
    offB[i] = p[1][i] - com[i];
  }
  g.len = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  const float inv = 1.f / fmaxf(g.len, 1e-12f);
  for (int i = 0; i < 3; ++i) g.u[i] = d[i] * inv;
  cross(offA, g.u, g.cA);
  cross(offB, g.u, g.cB);
  g.ba = b2[0];
  g.bb = b2[1];
}


__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// MuJoCo's skewed bump (actuation._bump) with mid = 1
__device__ float bump(float x, float lmin, float lmax) {
  const float mid = 1.f;
  const float left = 0.5f * (lmin + mid), right = 0.5f * (mid + lmax);
  float t;
  if (x > lmin && x <= left) {
    t = (x - lmin) / fmaxf(left - lmin, 1e-15f);
    return 0.5f * t * t;
  }
  if (x > left && x <= mid) {
    t = (mid - x) / fmaxf(mid - left, 1e-15f);
    return 1.f - 0.5f * t * t;
  }
  if (x > mid && x <= right) {
    t = (x - mid) / fmaxf(right - mid, 1e-15f);
    return 1.f - 0.5f * t * t;
  }
  if (x > right && x < lmax) {
    t = (lmax - x) / fmaxf(lmax - right, 1e-15f);
    return 0.5f * t * t;
  }
  return 0.f;
}

// The tendon and muscle stage of one env (muscle_env_block; the
// arithmetic of the staged tendon.py + actuation.py): per muscle i (F_MUS
// row P = [tau_act tau_deact gainprm(9) biasprm(9) lr0 lr1 acc0 gear clo chi
// flo fhi], I_MUS row Q = [seg0 nseg act_slot ctrl_index climited
// flimited]), on its own lane, its tendon's length and velocity from its
// segments, the FLV force (mju_muscleGain / Bias) on act, act_dot
// (mju_muscleDynamics, tausmooth 0) into act_dot[act_slot]; then lane per
// body the gear forces through the segments' endpoint bodies into per-body
// wrenches (the segments in order), and lane per dof their projection on
// every dof of the bodies' chains (I_DMASK), added to qfrc_smooth. Needs
// cvel (smooth_force). The SH_MUS region holds act (na), act_dot (na), the
// gear forces (nmus) and the wrenches (nbody x 6).
__device__ void muscle_block(const Tab& T, const Env& s, const float* ctrl) {
  const int nmus = T.h(NMUS), na = T.h(NA), nv = s.nv, nb = s.nb;
  const int flags = T.h(FLAGS);
  const float* mf = T.f(F_MUS);
  const int* mi = T.i(I_MUS);
  const int* sg = T.i(I_SEG);
  const int* dmask = T.i(I_DMASK);
  const float* act = s.mus;
  float* act_dot = s.mus + na;
  float* gf = s.mus + 2 * na;  // gear * force of each muscle
  float* W = gf + nmus;
  float* seg = s.scr;  // kSegW floats per segment
  for (int a = s.lane; a < na; a += kWarp) act_dot[a] = 0.f;
  __syncwarp();
  for (int i = s.lane; i < nmus; i += kWarp) {
    const float* P = mf + 28 * i;
    const int* Q = mi + 6 * i;
    float len = 0.f, vel = 0.f;
    for (int k = Q[0]; k < Q[0] + Q[1]; ++k) {
      Seg g;
      segment(T, s, sg + 2 * k, g);
      const float* vb = s.body(g.bb) + B_CVEL;
      const float* va = s.body(g.ba) + B_CVEL;
      len += g.len;
      vel += (dot3(g.cB, vb) + dot3(g.u, vb + 3)) -
             (dot3(g.cA, va) + dot3(g.u, va + 3));
      float* o = seg + kSegW * k;
      o[0] = g.len;
      for (int j = 0; j < 3; ++j) {
        o[1 + j] = g.u[j];
        o[4 + j] = g.cA[j];
        o[7 + j] = g.cB[j];
      }
      o[10] = fbits(g.ba);
      o[11] = fbits(g.bb);
    }
    const float gear = P[23], length = len * gear, velocity = vel * gear;
    float c = ctrl[Q[3]];
    if ((flags & CLAMPCTRL) && Q[4]) c = fminf(fmaxf(c, P[24]), P[25]);
    const float a = act[Q[2]];
    // activation dynamics: tau compares the clamped ctrl with the raw act
    const float cc = clampf(c, 0.f, 1.f), ac = clampf(a, 0.f, 1.f);
    const float tau = cc > a ? P[0] * (0.5f + 1.5f * ac)
                             : P[1] / (0.5f + 1.5f * ac);
    float adot = (cc - a) / fmaxf(tau, 1e-15f);
    // gain: -F FL(L) FV(V)
    const float lr0 = P[20], lr1 = P[21], acc0 = fmaxf(P[22], 1e-15f);
    const float fg = P[4] < 0.f ? P[5] / acc0 : P[4];
    const float l0g = (lr1 - lr0) / fmaxf(P[3] - P[2], 1e-15f);
    const float lng = P[2] + (length - lr0) / fmaxf(l0g, 1e-15f);
    const float v = velocity / fmaxf(l0g * P[8], 1e-15f);
    const float fvmax = P[10], y = fvmax - 1.f;
    const float fv = v <= -1.f ? 0.f
                     : v <= 0.f ? (v + 1.f) * (v + 1.f)
                     : v <= y   ? fvmax - (y - v) * (y - v) / fmaxf(y, 1e-15f)
                                : fvmax;
    const float gain = -fg * bump(lng, P[6], P[7]) * fv;
    // bias: -F FP(L)
    const float fb = P[13] < 0.f ? P[14] / acc0 : P[13];
    const float l0b = (lr1 - lr0) / fmaxf(P[12] - P[11], 1e-15f);
    const float lnb = P[11] + (length - lr0) / fmaxf(l0b, 1e-15f);
    const float bmid = 0.5f * (1.f + P[16]), den = fmaxf(bmid - 1.f, 1e-15f);
    const float xm = (lnb - 1.f) / den, xh = (lnb - bmid) / den;
    const float fp = lnb <= 1.f ? 0.f
                     : lnb <= bmid ? 0.5f * P[18] * xm * xm
                                   : P[18] * (0.5f + xh);
    float force = gain * a - fb * fp;
    if (Q[5]) force = fminf(fmaxf(force, P[26]), P[27]);
    if (!(flags & ACTUATION)) force = adot = 0.f;
    act_dot[Q[2]] = adot;
    gf[i] = force * gear;
  }
  __syncwarp();
  for (int b = s.lane; b < nb; b += kWarp) {
    float w[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = 0; i < nmus; ++i) {
      const int* Q = mi + 6 * i;
      for (int k = Q[0]; k < Q[0] + Q[1]; ++k) {
        const float* o = seg + kSegW * k;
        if (ibits(o[11]) == b)
          for (int j = 0; j < 3; ++j) {
            w[j] += gf[i] * o[7 + j];
            w[3 + j] += gf[i] * o[1 + j];
          }
        if (ibits(o[10]) == b)
          for (int j = 0; j < 3; ++j) {
            w[j] -= gf[i] * o[4 + j];
            w[3 + j] -= gf[i] * o[1 + j];
          }
      }
    }
    for (int k = 0; k < 6; ++k) W[6 * b + k] = w[k];
  }
  __syncwarp();
  float* qfs = s.vec(V_QFS);
  for (int v = s.lane; v < nv; v += kWarp) {
    const float* cd = s.cdof + 6 * v;
    float q = 0.f;
    for (int b = 1; b < nb; ++b)
      if (dmask[b * nv + v])
        q += dot3(cd, W + 6 * b) + dot3(cd + 3, W + 6 * b + 3);
    qfs[v] += q;
  }
  __syncwarp();
}


// ---- constraint rows ------------------------------------------------------
// Each row goes to the env's shared arrays (forward_core.cuh RowWriter's
// formulas): its act flag and, when active, J, aref, D (and R for the
// equality and friction-loss rows, the only ones the solve reads it of).
__device__ __forceinline__ void row_off(const Env& s, int r) {
  s.ra(R_ACT)[r] = 0.f;
}
__device__ __forceinline__ void row_set(const Env& s, int nR, int r,
                                        float aref, float R) {
  s.ra(R_AREF)[r] = aref;
  if (r < nR) s.R[r] = R;
  s.ra(R_D)[r] = 1.f / R;
  s.ra(R_ACT)[r] = 1.f;
}
__device__ __forceinline__ void row_finish(const Env& s, int nR, int r,
                                           float k, float b, float imp,
                                           float pos, float vel, float iw) {
  row_set(s, nR, r, -b * vel - k * imp * pos, r_of(imp, iw));
}

// The JOINT-equality, friction-loss, limit and inert pad rows (rows 0 ..
// base - 1), lane per row.
__device__ void joint_rows(const Tab& T, const Env& s, const float* qpos,
                           const float* qvel) {
  const int nv = s.nv, ne = T.h(NE), nfl = T.h(NFL), nl = T.h(NL);
  const int base = ne + nfl + nl + T.h(NPAD), nR = ne + nfl;
  const bool refsafe = T.h(FLAGS) & REFSAFE;
  const float dt = T.f(F_CON)[kConDt];
  const float* ef = T.f(F_EQ);
  const int* ei = T.i(I_EQ);
  const float* ff = T.f(F_FL);
  const int* fi = T.i(I_FL);
  const float* lf = T.f(F_LIM);
  const int* li = T.i(I_LIM);
  for (int r = s.lane; r < base; r += kWarp) {
    float* J = s.jrow(r);
    float kk, bb, imp;
    if (r < ne) {
      const float* A = ef + 16 * r;
      const int* B = ei + 4 * r;
      const float m2 = A[12];
      const float dif = m2 * (qpos[B[2]] - A[15]);
      const float poly = A[0] + A[1] * dif + A[2] * (dif * dif) +
                         A[3] * (dif * dif * dif) +
                         A[4] * (dif * dif * dif * dif);
      const float dpoly = A[1] + 2.f * A[2] * dif +
                          3.f * A[3] * (dif * dif) +
                          4.f * A[4] * (dif * dif * dif);
      const float pos = qpos[B[0]] - A[14] - poly;
      for (int k = 0; k < nv; ++k)
        J[k] = (k == B[1] ? 1.f : 0.f) - (k == B[3] ? dpoly * m2 : 0.f);
      float vel = 0.f;
      for (int k = 0; k < nv; ++k) vel += J[k] * qvel[k];
      kbi(A + 5, A + 7, pos, dt, refsafe, kk, bb, imp);
      row_finish(s, nR, r, kk, bb, imp, pos, vel, A[13]);
    } else if (r < ne + nfl) {
      const int q = r - ne;
      const float* A = ff + 10 * q;
      for (int k = 0; k < nv; ++k) J[k] = k == fi[q] ? 1.f : 0.f;
      kbi(A, A + 2, 0.f, dt, refsafe, kk, bb, imp);
      row_finish(s, nR, r, kk, bb, imp, 0.f, qvel[fi[q]], A[8]);
      s.fl[q] = A[7];
    } else if (r < ne + nfl + nl) {
      const int q = r - ne - nfl;
      const float* A = lf + 12 * q;
      const float x = qpos[li[2 * q]];
      const float dlo = x - A[0], dhi = A[1] - x;
      const bool use_lo = dlo <= dhi;
      const float dist = use_lo ? dlo : dhi;
      const float sign = use_lo ? 1.f : -1.f;
      if (!(dist < A[2])) {
        row_off(s, r);
        continue;
      }
      const int v = li[2 * q + 1];
      for (int k = 0; k < nv; ++k) J[k] = k == v ? sign : 0.f;
      const float pos = dist - A[2];
      kbi(A + 3, A + 5, pos, dt, refsafe, kk, bb, imp);
      row_finish(s, nR, r, kk, bb, imp, pos, sign * qvel[v], A[10]);
    } else {
      row_off(s, r);
    }
  }
}

// The frame rows times the point Jacobian at dof v of a contact at
// com-offset `off` between bodies b1 and b2 (its chain mask is b2's minus
// b1's; b < 0: none): ax[t] for t = 0..2, and with `rot` the frame rows
// times the rotational Jacobian as ax[3 + t] (forward_core.cuh
// contact_axes, one dof).
__device__ __forceinline__ void contact_axis(const Env& s, const int* dmask,
                                             const float* off,
                                             const float* frame, int b1,
                                             int b2, int v, bool rot,
                                             float* ax) {
  const int nv = s.nv;
  const float m = (b2 >= 0 ? (float)dmask[b2 * nv + v] : 0.f) -
                  (b1 >= 0 ? (float)dmask[b1 * nv + v] : 0.f);
  float jp[3] = {0.f, 0.f, 0.f}, jr[3] = {0.f, 0.f, 0.f};
  if (m != 0.f) {
    const float* u = s.cdof + 6 * v;
    jp[0] = m * ((u[1] * off[2] - u[2] * off[1]) + u[3]);
    jp[1] = m * ((u[2] * off[0] - u[0] * off[2]) + u[4]);
    jp[2] = m * ((u[0] * off[1] - u[1] * off[0]) + u[5]);
    for (int i = 0; i < 3; ++i) jr[i] = m * u[i];
  }
  for (int t = 0; t < 3; ++t) {
    const float* fr = frame + 3 * t;
    ax[t] = fr[0] * jp[0] + fr[1] * jp[1] + fr[2] * jp[2];
    if (rot) ax[3 + t] = fr[0] * jr[0] + fr[1] * jr[1] + fr[2] * jr[2];
  }
}

// The four pyramidal facets of active slot c (J = Jn +- mu_t Jt, facet f =
// 0..3 for +mu1 t1, -mu1 t1, +mu2 t2, -mu2 t2) at rows s0 + f ncon + c,
// the blocked layout (forward_core.cuh contact_rows).
__device__ void contact_rows(const Tab& T, const Env& s, int nR, int s0,
                             int c, const float* cpos, const float* frame,
                             int b1, int b2, float pos, const float* sr,
                             const float* si, float iw, float mu1, float mu2,
                             const float* qvel) {
  const int nv = s.nv, ncon = s.ncon;
  const int* dmask = T.i(I_DMASK);
  const bool refsafe = T.h(FLAGS) & REFSAFE;
  const float dt = T.f(F_CON)[kConDt];
  const float* com = s.misc + kMiscCom;
  float off[3];
  for (int i = 0; i < 3; ++i) off[i] = cpos[i] - com[i];
  float kk, bb, imp;
  kbi(sr, si, pos, dt, refsafe, kk, bb, imp);
  const float iwp = iw * 2.f * mu1 * mu1 * (1.f + mu1 * mu1);
  float vel[4] = {0.f, 0.f, 0.f, 0.f};
  for (int v = 0; v < nv; ++v) {
    float ax[6];
    contact_axis(s, dmask, off, frame, b1, b2, v, false, ax);
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int t = 1 + f / 2;
      const float sm = (f & 1 ? -1.f : 1.f) * (t == 1 ? mu1 : mu2);
      const float jv = ax[0] + sm * ax[t];
      s.jrow(s0 + f * ncon + c)[v] = jv;
      vel[f] += jv * qvel[v];
    }
  }
#pragma unroll
  for (int f = 0; f < 4; ++f)
    row_finish(s, nR, s0 + f * ncon + c, kk, bb, imp, pos, vel[f], iwp);
}

// The dim rows of active elliptic slot c from row r0, slot-major
// (forward_core.cuh ell_contact_rows); *mu_out, where given, gets the cone
// coefficient.
__device__ void ell_contact_rows(const Tab& T, const Env& s, int nR, int r0,
                                 int dim, const float* cpos,
                                 const float* frame, int b1, int b2,
                                 float pos, const float* sr, const float* si,
                                 float iw, const float* fric,
                                 const float* qvel, float* mu_out) {
  const int nv = s.nv;
  const int* dmask = T.i(I_DMASK);
  const bool refsafe = T.h(FLAGS) & REFSAFE;
  const float* con = T.f(F_CON);
  const float dt = con[kConDt], impratio = con[kConImpratio];
  const float* com = s.misc + kMiscCom;
  float off[3];
  for (int i = 0; i < 3; ++i) off[i] = cpos[i] - com[i];
  float kk, bb, imp;
  kbi(sr, si, pos, dt, refsafe, kk, bb, imp);
  const float rn = r_of(imp, iw);
  const float mu = fric[0];
  float vel[kDimMax] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int v = 0; v < nv; ++v) {
    float ax[6];
    contact_axis(s, dmask, off, frame, b1, b2, v, dim > 3, ax);
#pragma unroll
    for (int t = 0; t < kDimMax; ++t)
      if (t < dim) {
        s.jrow(r0 + t)[v] = ax[t];
        vel[t] += ax[t] * qvel[v];
      }
  }
#pragma unroll
  for (int t = 0; t < kDimMax; ++t)
    if (t < dim) {
      const float aref = t == 0 ? -bb * vel[t] - kk * imp * pos : -bb * vel[t];
      const float R = t == 0 ? rn
                             : fmaxf(rn * (mu * mu) /
                                         (fric[t - 1] * fric[t - 1]) /
                                         impratio,
                                     kMinVal);
      row_set(s, nR, r0 + t, aref, R);
    }
  if (mu_out) *mu_out = mu / sqrtf(impratio);
}

// The contact rows after the joint and pad rows: lane per slot, the
// pyramidal facets of the plane-only collision's slots (the plan's uniform
// statics), or, from the extended collision's generic slots (their frame,
// bodies and invweight, their group's statics), (ELL) the elliptic rows,
// each elliptic contact's cone coefficient at its index among the slots of
// dim >= 3, or the pyramidal facets.
template <bool EXT, bool ELL>
__device__ void contact_rows_all(const Tab& T, const Env& s,
                                 const float* qvel) {
  const int ncon = s.ncon;
  const int nR = T.h(NE) + T.h(NFL);
  const int base = T.h(NE) + T.h(NFL) + T.h(NL) + T.h(NPAD);
  const float* con = T.f(F_CON);
  const float* bf = T.f(F_BODY);
  if constexpr (EXT && !ELL) {
    const float* gf = T.f(F_XGRP);
    for (int c = s.lane; c < ncon; c += kWarp) {
      const float* S = s.slot(c);
      const float* G = gf + 16 * ibits(S[S_GRP]);
      if (!(S[S_DIST] < G[1])) {
        for (int f = 0; f < 4; ++f) row_off(s, base + f * ncon + c);
        continue;
      }
      contact_rows(T, s, nR, base, c, S + S_POS, S + S_FRAME,
                   ibits(S[S_BODY1]), ibits(S[S_BODY]), S[S_DIST] - G[1],
                   G + 2, G + 4, S[S_IW], G[9], G[10], qvel);
    }
  } else if constexpr (EXT) {
    const int* cinfo = T.i(I_CON);  // per slot: dim, first row
    const float* gf = T.f(F_XGRP);
    int cbase = 0;  // elliptic contacts before this round's slots
    for (int c0 = 0; c0 < ncon; c0 += kWarp) {
      const int c = c0 + s.lane;
      const int dim = c < ncon ? cinfo[2 * c] : 0;
      const unsigned ell = __ballot_sync(kFull, dim >= 3);
      const int ci = cbase + __popc(ell & ((1u << s.lane) - 1u));
      cbase += __popc(ell);
      if (c >= ncon) continue;
      const int r0 = cinfo[2 * c + 1];
      const float* S = s.slot(c);
      const float* G = gf + 16 * ibits(S[S_GRP]);
      if (!(S[S_DIST] < G[1])) {
        for (int t = 0; t < dim; ++t) row_off(s, r0 + t);
        continue;
      }
      ell_contact_rows(T, s, nR, r0, dim, S + S_POS, S + S_FRAME,
                       ibits(S[S_BODY1]), ibits(S[S_BODY]),
                       S[S_DIST] - G[1], G + 2, G + 4, S[S_IW], G + 9, qvel,
                       dim >= 3 ? s.mu + ci : nullptr);
    }
  } else {
    for (int c = s.lane; c < ncon; c += kWarp) {
      const float* S = s.slot(c);
      const float dist = S[S_DIST];
      if (!(dist < con[kConMargin])) {
        for (int f = 0; f < 4; ++f) row_off(s, base + f * ncon + c);
        continue;
      }
      const int cb = ibits(S[S_BODY]);
      contact_rows(T, s, nR, base, c, S + S_POS, con + kConFrame, -1, cb,
                   dist - con[kConMargin], con + kConSolref,
                   con + kConSolimp, bf[20 * cb + 18], con[kConFric],
                   con[kConFric + 1], qvel);
    }
  }
  __syncwarp();
}

// The static class of every row (R_CLS): -1 a scalar row, 8 ci + dim on
// the first row of elliptic contact ci (the plan's runs), -2 on its other
// rows.
__device__ void row_classes(const Tab& T, const Env& s) {
  int* cls = s.cls();
  for (int r = s.lane; r < s.nrows; r += kWarp) cls[r] = -1;
  __syncwarp();
  const int nruns = T.h(NELL);
  const int* runs = T.i(I_ELL);
  int c0 = 0;
  for (int q = 0; q < nruns; ++q) {
    const int s0 = runs[3 * q], cnt = runs[3 * q + 1], d = runs[3 * q + 2];
    for (int i = s.lane; i < cnt; i += kWarp) {
      const int r = s0 + i * d;
      cls[r] = 8 * (c0 + i) + d;
      for (int k = 1; k < d; ++k) cls[r + k] = -2;
    }
    c0 += cnt;
  }
  __syncwarp();
}


// ---- the Newton solve -------------------------------------------------------
// newton_core.cuh's newton_solve with a warp per env: the same cost-based warm
// start, Newton steps, Hessian, Cholesky, safeguarded-secant line search and
// termination. For elliptic plans (P double) the solve runs in double on the
// widened float inputs: x, the direction and its products, the rows' forces,
// weights and cone zones for the direction, the gradient, the Hessian and its
// factor, the line search's sums and step; jar and J dx are kept in float
// (rounded once from their double sums) in the row arrays, the line search
// takes each row's force and cost at a trial point in float, and x is rounded
// once into V_X (against the plain version's float64 solve within rel 1.1e-4 on
// A1's 4096 seeded states, tools/a1_forward_check.py, an NVIDIA H100 80GB HBM3
// at 700 W). At impratio 100 the Hessian of an elliptic contact spans many
// orders of magnitude, and a solve cut at its Newton budget carries every
// rounding forward: a float32 solve replaying the same decisions ends more than
// rel 5e-4 from the same solve in float64 (tests/test_torch_replay.py), so two
// float32 versions could not be held to rel 5e-4 of each other; the plain
// version solves in float64 (hopper_fused.fused_constraint_plain's solve64).
// The solve records the same decisions (iters, taken, the line search's bits;
// where row_out is given each step's Hessian decision of every row,
// (iterations, (nrows + 31) / 32) words). The row quantities and cone zones are
// newton_core.cuh's `Rows` over the env's shared arrays (E = 1, e = 0). Row
// passes go lane per active row (an elliptic contact on one lane) over the list
// of active rows, and sum by warp shuffles; the gradient goes lane per dof over
// the rows with a force and the Hessian lane per entry over the rows with a
// Hessian term, each list in row order; the factor and the substitutions a
// column and an unknown at a time.
template <class P>
struct Solve {
  const Env& s;
  const Rows& rows;
  bool ell;  // elliptic rows (R_CLS, R_ZONE)
  int nv, nrows;
  int nA;  // active rows (an elliptic contact by its first row): L_ACT
  static constexpr bool kWide = sizeof(P) == sizeof(double);

  __device__ int cls(int r) const { return ell ? s.cls()[r] : -1; }
  // every row's force in P at the Newton step's x (kWide)
  __device__ double* forces() const { return (double*)s.ra(R_FD); }

  // J_r v - aref_r in float: a float sum, or (kWide) a double one rounded
  // once
  template <class V>
  __device__ float jar_at(int r, const V* v) const {
    if constexpr (kWide)
      return (float)jar_wide(s.jrow(r), v, nv, s.ra(R_AREF)[r]);
    else
      return jdot(s.jrow(r), v, nv) - s.ra(R_AREF)[r];
  }

  // force, Hessian weight and cost of active scalar row r at jar value v
  __device__ void fwc(int r, P v, P& f, P& w, P& c) const {
    if constexpr (kWide)
      fwc_double(rows, r, v, f, w, c);
    else
      rows.fwc(r, v, f, w, c);
  }

  // sum over the active rows of scalar(r), and over the active elliptic
  // contacts (first row r, dim d, index ci) of cone(r, d, ci)
  template <class S, class C>
  __device__ P sum_rows(S&& scalar, C&& cone) const {
    const unsigned short* la = s.list(L_ACT);
    P t = 0;
    for (int i = s.lane; i < nA; i += kWarp) {
      const int r = la[i], c = cls(r);
      t += c == -1 ? scalar(r) : cone(r, c & 7, c >> 3);
    }
    return wsum(t);
  }

  // the rows' cost (fn false) or force . jv (fn true) at jar + a jv, or
  // (jv null) at jar_of(r): each row's force and cost in float (at a
  // float trial point), summed in P
  template <class J>
  __device__ P rows_at(J&& jar_of, const float* jv, float a,
                       bool fn) const {
    return sum_rows(
        [&](int r) -> P {
          float f, w, c;
          rows.fwc(r, jv ? jar_of(r) + a * jv[r] : jar_of(r), f, w, c);
          return fn ? (P)f * jv[r] : (P)c;
        },
        [&](int r, int d, int ci) -> P {
          float sv[kDimMax];
#pragma unroll
          for (int k = 0; k < kDimMax; ++k)
            sv[k] = k < d ? (jv ? jar_of(r + k) + a * jv[r + k]
                                : jar_of(r + k))
                          : 0.f;
          ConeT<float> z;
          cone_zone(rows, r, d, ci, sv, z);
          if (!fn) return z.c;
          P t = 0;
#pragma unroll
          for (int k = 0; k < kDimMax; ++k)
            if (k < d) t += (P)z.f[k] * jv[r + k];
          return t;
        });
  }

  // total cost at v: constraint rows plus 0.5 (v - asm)' M (v - asm)
  __device__ P total_cost(const float* v) const {
    const float* asm_ = s.vec(V_ASM);
    const P c = rows_at([&](int r) { return jar_at(r, v); }, nullptr, 0.f,
                        false);
    P gauss = 0;
    for (int a = s.lane; a < nv; a += kWarp) {
      P mt = 0;
      for (int b = 0; b < nv; ++b) mt += s.M[a * nv + b] * (v[b] - asm_[b]);
      gauss += (v[a] - asm_[a]) * mt;
    }
    return c + P(0.5) * wsum(gauss);
  }

  // the rows' force . jv and cost at jar + a jv (R_JAR, R_JV)
  __device__ P force_jv(P a) const {
    const float* jar = s.ra(R_JAR);
    return rows_at([&](int r) { return jar[r]; }, s.ra(R_JV), (float)a,
                   true);
  }
  __device__ P cost_at(P a) const {
    const float* jar = s.ra(R_JAR);
    return rows_at([&](int r) { return jar[r]; }, s.ra(R_JV), (float)a,
                   false);
  }

  // One pass over the active rows at x: jar, each row's force (R_F, and
  // with kWide in double, forces()), a scalar row's Hessian weight (in
  // R_JV), an elliptic contact's zone (R_ZONE); then the lists of the rows
  // with a force (returned in nF) and with a Hessian term (nH), and the
  // rows' Hessian decisions into the misc words (when `rec`).
  __device__ void row_pass(const P* x, bool rec, int& nF, int& nH) const {
    const float* act = s.ra(R_ACT);
    float* jar = s.ra(R_JAR);
    float* F = s.ra(R_F);
    float* W = s.ra(R_JV);
    const unsigned short* la = s.list(L_ACT);
    for (int i = s.lane; i < nA; i += kWarp) {
      const int r = la[i], c = cls(r);
      if (c == -1) {
        const float v = jar_at(r, x);
        jar[r] = v;
        P f, w, cc;
        fwc(r, v, f, w, cc);
        if constexpr (kWide) forces()[r] = f;
        F[r] = (float)f;
        W[r] = (float)w;
        continue;
      }
      const int d = c & 7;
      P sv[kDimMax];
#pragma unroll
      for (int k = 0; k < kDimMax; ++k) {
        sv[k] = 0;
        if (k < d) {
          const float v = jar_at(r + k, x);
          jar[r + k] = v;
          sv[k] = v;
        }
      }
      ConeT<P> z;
      cone_zone(rows, r, d, c >> 3, sv, z);
#pragma unroll
      for (int k = 0; k < kDimMax; ++k)
        if (k < d) {
          if constexpr (kWide) forces()[r + k] = z.f[k];
          F[r + k] = (float)z.f[k];
        }
      s.ra(R_ZONE)[r] = z.mid ? 1.f : (z.bottom ? -1.f : 0.f);
    }
    __syncwarp();
    // the lists, and the scalar rows' Hessian decisions a word at a time
    unsigned short* lf = s.list(L_F);
    unsigned short* lh = s.list(L_H);
    unsigned* bits = s.bits();
    const unsigned lt = (1u << s.lane) - 1u;
    nF = nH = 0;
    for (int r0 = 0; r0 < nrows; r0 += kWarp) {
      const int r = r0 + s.lane;
      const int c = r < nrows ? cls(r) : -2;
      const bool on = r < nrows && act[r] != 0.f;
      const bool sc = on && c == -1 && W[r] != 0.f;
      const bool h = sc || (on && c >= 0);
      const bool f = on && F[r] != 0.f;
      const unsigned bh = __ballot_sync(kFull, h);
      const unsigned bf = __ballot_sync(kFull, f);
      if (rec) {
        const unsigned bs = __ballot_sync(kFull, sc);
        if (s.lane == 0) bits[r0 >> 5] = bs;
      }
      if (h) lh[nH + __popc(bh & lt)] = r;
      if (f) lf[nF + __popc(bf & lt)] = r;
      nH += __popc(bh);
      nF += __popc(bf);
    }
    __syncwarp();
    if (rec && ell) {  // the cone zones' bits: middle on the first row,
                       // sticking on the second
      const float* Z = s.ra(R_ZONE);
      for (int i = s.lane; i < nA; i += kWarp) {
        const int r = la[i];
        if (cls(r) < 0) continue;
        const int b = Z[r] > 0.f ? r : (Z[r] < 0.f ? r + 1 : -1);
        if (b >= 0) atomicOr(bits + (b >> 5), 1u << (b & 31));
      }
      __syncwarp();
    }
  }

  // g = M (x - asm) - J'f in P (lane per dof over the rows with a force;
  // mdx0 holds M (x - asm))
  __device__ void gradient(P* g, const P* mdx0, int nF) const {
    const float* F = s.ra(R_F);
    const unsigned short* lf = s.list(L_F);
    for (int a = s.lane; a < nv; a += kWarp) {
      P t = mdx0[a];
      for (int i = 0; i < nF; ++i) {
        const int r = lf[i];
        if constexpr (kWide)
          t -= s.jrow(r)[a] * forces()[r];
        else
          t -= s.jrow(r)[a] * F[r];
      }
      g[a] = t;
    }
  }

  // H = M + 1e-12 I + J' diag(w) J + the middle zones' rank-1 and
  // curvature terms in P, lower triangle into H (row stride nv): lane per
  // entry, each over the rows with a Hessian term in row order
  // (newton_core.cuh's add_row). An elliptic contact's zone is formed
  // again from jar on lane 0 and shared through the misc scratch.
  __device__ void hessian(P* H, int nH) const {
    const float* W = s.ra(R_JV);
    const float* jar = s.ra(R_JAR);
    const unsigned short* lh = s.list(L_H);
    const int ntri = nv * (nv + 1) / 2;
    P h[kEnt];
    int ea[kEnt], eb[kEnt];
    int a = 0, b = s.lane;
    while (b > a) b -= ++a;
#pragma unroll
    for (int i = 0; i < kEnt; ++i) {
      const bool ok = i * kWarp + s.lane < ntri;
      ea[i] = ok ? a : 0;
      eb[i] = ok ? b : 0;
      h[i] = ok ? s.M[a * nv + b] : 0.f;
      if (ok && a == b) h[i] += P(1e-12);
      b += kWarp;
      while (b > a) b -= ++a;
    }
    const int mine = (ntri - s.lane + kWarp - 1) / kWarp;  // my entries
    auto add = [&](const float* j, P w) {
#pragma unroll
      for (int i = 0; i < kEnt; ++i) {
        if (i >= mine) break;
        const P wa = w * j[ea[i]];
        if (wa != P(0)) h[i] += wa * j[eb[i]];
      }
    };
    P* cv = s.cone_vecs<P>();
    // the zone's weights w, g, q and sc (kDimMax each), then wg and c2
    // (wg 0 outside the middle zone)
    P* cz = cv + kConeVecs * nv;
    for (int t = 0; t < nH; ++t) {
      const int r = lh[t], c = cls(r);
      if (c == -1) {
        add(s.jrow(r), W[r]);
        continue;
      }
      const int d = c & 7;
      if (s.lane == 0) cone_terms(rows, r, d, c >> 3, jar + r, cz);
      __syncwarp();
      for (int k = 0; k < d; ++k)
        if (cz[k] != P(0)) add(s.jrow(r + k), cz[k]);
      const P wg = cz[4 * kDimMax], c2 = cz[4 * kDimMax + 1];
      if (wg > P(0)) {
        // the middle zone: wg Jg Jg' + c2 sum_{k<l} v_kl v_kl', with Jg
        // and the v_kl formed once per contact, lane per dof
        const P* zg = cz + kDimMax;
        const P* zq = cz + 2 * kDimMax;
        const P* zs = cz + 3 * kDimMax;
        const int nvec = 1 + (d - 1) * (d - 2) / 2;
        for (int a = s.lane; a < nv; a += kWarp) {
          P jg = 0;
          for (int k = 0; k < d; ++k) jg += zg[k] * s.jrow(r + k)[a];
          cv[a] = jg;
          int q = 1;
          for (int k = 1; k < d; ++k)
            for (int l = k + 1; l < d; ++l, ++q) {
              const P ak = zq[l] * zs[k];
              const P al = zq[k] * zs[l];
              cv[q * nv + a] =
                  ak * s.jrow(r + k)[a] - al * s.jrow(r + l)[a];
            }
        }
        __syncwarp();
#pragma unroll
        for (int i = 0; i < kEnt; ++i) {
          if (i >= mine) break;
          const P wa = wg * cv[ea[i]];
          if (wa != P(0)) h[i] += wa * cv[eb[i]];
          for (int q = 1; q < nvec; ++q) {
            const P wv = c2 * cv[q * nv + ea[i]];
            if (wv != P(0)) h[i] += wv * cv[q * nv + eb[i]];
          }
        }
      }
      __syncwarp();
    }
#pragma unroll
    for (int i = 0; i < kEnt; ++i)
      if (i < mine) H[ea[i] * nv + eb[i]] = h[i];
    __syncwarp();
  }
};

// Solve for the env's rows: qacc into V_X from asm (V_ASM) and the warm
// start ws; the decisions out (identical on every lane; lane 0 writes the
// line search's words to ls_out). P: the solve's precision; in double its
// x, direction and products live in the L region after H and the gradient
// (`solve_vecs`), and x is rounded into V_X at the end.
template <class P>
__device__ void newton(const Env& s, const Rows& rows, bool ell,
                       const float* ws, int iterations, int ls_iterations,
                       float scale, float tol, int& iters, unsigned& taken,
                       unsigned* ls_out, unsigned* row_out) {
  constexpr bool kWide = Solve<P>::kWide;
  const int nv = s.nv, nrows = s.nrows;
  unsigned ls_bits[kLsWords];
  const float* act = s.ra(R_ACT);
  const int* clsa = s.cls();
  // the active rows, an elliptic contact by its first row
  const int nA = compact(s, nrows, s.list(L_ACT), [&](int r) {
    return act[r] != 0.f && (!ell || clsa[r] != -2);
  });
  const Solve<P> sv{s, rows, ell, nv, nrows, nA};
  const float* asm_ = s.vec(V_ASM);
  // the Newton direction in P, in the L region (the factor of M is not
  // needed during the solve): H (nv x nv), then the gradient
  P* H = (P*)s.L;
  P* g = H + nv * nv;
  P *x, *dx, *mdx0, *mdx;
  if constexpr (kWide) {
    x = solve_vecs(s);
    dx = x + nv;
    mdx0 = dx + nv;
    mdx = mdx0 + nv;
  } else {
    x = s.vec(V_X);
    dx = s.vec(V_DX);
    mdx0 = s.vec(V_MDX0);
    mdx = s.vec(V_MDX);
  }
  float* jv = s.ra(R_JV);
  const float* F = s.ra(R_F);
  const unsigned short* la = s.list(L_ACT);
  const int nrw = (nrows + 31) >> 5;
  const bool rec = row_out != nullptr;

  const P c_ws = sv.total_cost(ws);
  const P c_sm = sv.total_cost(asm_);
  const bool use_ws = c_ws < c_sm;
  for (int k = s.lane; k < nv; k += kWarp) x[k] = use_ws ? ws[k] : asm_[k];
  P cost = wmin(c_ws, c_sm);
  if (rec)
    for (int w = s.lane; w < iterations * nrw; w += kWarp) row_out[w] = 0u;
  taken = use_ws ? 1u << 31 : 0u;
#pragma unroll
  for (int w = 0; w < kLsWords; ++w) ls_bits[w] = 0u;
  __syncwarp();
  int it = 0;
  for (; it < iterations; ++it) {
    // M (x - asm), the gradient start
    for (int k = s.lane; k < nv; k += kWarp) dx[k] = x[k] - asm_[k];
    __syncwarp();
    wmat_vec(s, s.M, dx, mdx0, nv);
    // one pass over the rows, then the gradient and the Hessian
    int nF, nH;
    sv.row_pass(x, rec, nF, nH);
    if (rec)
      for (int w = s.lane; w < nrw; w += kWarp)
        row_out[it * nrw + w] = s.bits()[w];
    long long t0 = phase_now();
    sv.gradient(g, mdx0, nF);
    sv.hessian(H, nH);  // ends in a warp barrier
    t0 = phase_part(s.e, s.lane, PH_N_HESSIAN, t0);
    wfactor_solve<true>(s, H, (const P*)g, dx, nv, true);
    phase_part(s.e, s.lane, PH_N_FACTOR, t0);
    // jv = J dx (stored in float), and phi'(0) = dx' M (x - asm) - f' jv
    P fjv = 0;
    for (int i = s.lane; i < nA; i += kWarp) {
      const int r = la[i], c = sv.cls(r);
      const int d = c == -1 ? 1 : c & 7;
#pragma unroll
      for (int k = 0; k < kDimMax; ++k)
        if (k < d) {
          const float v = (float)jdot(s.jrow(r + k), dx, nv);
          jv[r + k] = v;
          if constexpr (kWide)
            fjv += sv.forces()[r + k] * v;
          else
            fjv += F[r + k] * v;
        }
    }
    fjv = wsum(fjv);
    wmat_vec(s, s.M, dx, mdx, nv);  // ends in a warp barrier
    P g0 = 0, h0 = 0;
    for (int k = s.lane; k < nv; k += kWarp) {
      g0 += dx[k] * mdx0[k];
      h0 += dx[k] * mdx[k];
    }
    g0 = wsum(g0);
    h0 = wsum(h0);
    // safeguarded secant on phi'(a) = g0 + a h0 - f(jar + a jv)' jv
    t0 = phase_now();
    P lo = 0, dlo = g0 - fjv, hi = 0, dhi = 1, a = 1;
    bool has_hi = false;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      const P d = g0 + a * h0 - sv.force_jv(a);
      if (d < P(0)) {
        lo = a;
        dlo = d;
        const int bit = it * ls_iterations + ls;
#pragma unroll
        for (int w = 0; w < kLsWords; ++w)
          if (w == bit >> 5) ls_bits[w] |= 1u << (bit & 31);
      } else {
        hi = a;
        dhi = d;
        has_hi = true;
      }
      a = has_hi ? falsi(lo, dlo, hi, dhi) : a * P(2);
    }
    const P alpha = has_hi ? falsi(lo, dlo, hi, dhi) : lo;
    // the new cost from this iteration's products; termination test
    P cost_new = sv.cost_at(alpha);
    P gauss = 0, gn = 0;
    for (int k = s.lane; k < nv; k += kWarp) {
      gauss += (x[k] + alpha * dx[k] - asm_[k]) * (mdx0[k] + alpha * mdx[k]);
      gn += g[k] * g[k];
    }
    cost_new += P(0.5) * wsum(gauss);
    gn = wsum(gn);
    phase_part(s.e, s.lane, PH_N_LINE, t0);
    const bool done =
        (cost - cost_new) / scale < tol || wsqrt(gn) / scale < tol;
    if (cost_new < cost) {
      taken |= 1u << it;
      for (int k = s.lane; k < nv; k += kWarp) x[k] += alpha * dx[k];
      cost = cost_new;
    }
    __syncwarp();
    if (done) {
      ++it;
      break;
    }
  }
  iters = it;
  if constexpr (kWide) {
    for (int k = s.lane; k < nv; k += kWarp) s.vec(V_X)[k] = (float)x[k];
    __syncwarp();
  }
  if (ls_out && s.lane == 0)
#pragma unroll
    for (int w = 0; w < kLsWords; ++w) ls_out[w] = ls_bits[w];
}

// Every row's force at the solution x (R_F; 0 for an inactive row), J x -
// aref taken in double: rounded once for a float x (newton_core.cuh
// row_forces), kept in double with the forces for the double solve's x.
template <class X>
__device__ void row_forces(const Env& s, const Rows& rows, bool ell,
                           const X* x) {
  const int nv = s.nv, nrows = s.nrows;
  const float* aref = s.ra(R_AREF);
  const float* act = s.ra(R_ACT);
  const int* cls = s.cls();
  float* F = s.ra(R_F);
  for (int r = s.lane; r < nrows; r += kWarp) {
    const int c = ell ? cls[r] : -1;
    if (c == -1) {
      float f = 0.f;
      if (act[r] != 0.f) {
        const X v = jar_wide(s.jrow(r), x, nv, aref[r]);
        if constexpr (sizeof(X) == sizeof(double)) {
          double fd, w, cc;
          fwc_double(rows, r, v, fd, w, cc);
          f = (float)fd;
        } else {
          f = rows.force(r, v);
        }
      }
      F[r] = f;
    } else if (c >= 0) {
      const int d = c & 7;
      if (act[r] == 0.f) {
        for (int k = 0; k < d; ++k) F[r + k] = 0.f;
        continue;
      }
      X sv[kDimMax];
#pragma unroll
      for (int k = 0; k < kDimMax; ++k)
        sv[k] = k < d ? jar_wide(s.jrow(r + k), x, nv, aref[r + k]) : X(0);
      ConeT<X> z;
      cone_zone(rows, r, d, c >> 3, sv, z);
#pragma unroll
      for (int k = 0; k < kDimMax; ++k)
        if (k < d) F[r + k] = (float)z.f[k];
    }
  }
  __syncwarp();
}

// Euler's implicit damping (pallas_constraint.py:1893-1906):
// dv = (M + h diag(damping))^-1 (M qacc), with M of this forward; the
// L region is overwritten by the factor of M + h diag(damping).
__device__ void euler_dv(const Tab& T, const Env& s, const float* qacc,
                         float* dv) {
  const int nv = s.nv;
  const float h = T.f(F_CON)[kConDt];
  const float* df = T.f(F_DOF);
  float* mq = s.vec(V_TMP);
  for (int a = s.lane; a < nv; a += kWarp) {
    float v = 0.f;
    for (int b = 0; b < nv; ++b) v += s.M[a * nv + b] * qacc[b];
    mq[a] = v;
    for (int b = 0; b < a; ++b) s.L[a * nv + b] = s.M[a * nv + b];
    s.L[a * nv + a] = s.M[a * nv + a] + h * df[2 * a];
  }
  __syncwarp();
  wfactor_solve<false>(s, s.L, (const float*)mq, dv, nv, false);
}


// ---- one forward, and the kernels ---------------------------------------------
// Outputs of one forward that the one-forward kernel writes (env-major);
// the megastep passes none.
struct Out {
  float *qacc_smooth, *qfrc, *cdist, *cforce, *dv;
  int *cgid, *cgid1;
  float* cpos;  // the slots' points (E, ncon, 3), or null
};

// The row quantities of the solve over the env's shared arrays.
__device__ Rows rows_of(const Tab& T, const Env& s) {
  return Rows{s.ra(R_AREF), s.ra(R_D), s.R,      s.fl,
              s.ra(R_ACT),  1,         0,        T.h(NE),
              T.h(NFL),     T.i(I_ELL), T.h(NELL), s.mu};
}

// One forward of the warp's env at (qpos, qvel, act in SH_MUS) from the
// warm start in V_WS: qacc into V_X, act_dot (with muscles) into SH_MUS,
// the decisions out (ls_out: the line search's words, row_out: each
// step's row words; either may be null). EXT: the extended collision of a
// mega_ell plan; ELL (with EXT): its elliptic rows and the double solve,
// else its pyramidal facets and the float solve (separate instances, so
// that the plane-only kernels carry none of the extended code and the
// elliptic ones none of the pyramidal). DAMP: the plan's per-env damping
// rows (DAMP_ROWS), read from in.damp; an instance of its own, so that the
// kernels without them are unchanged.
template <bool EXT, bool ELL, bool DAMP>
__device__ void forward_env(const Tab& T, const Opt& o, const In& in,
                            const Env& s, const float* qpos,
                            const float* qvel, int& iters, unsigned& taken,
                            unsigned* ls_out, unsigned* row_out) {
  const int e = s.e, nv = s.nv;
  const float* ctrl = in.ctrl + (size_t)e * T.h(NU);
  fk(T, s, qpos);
  phase_tick(e, s.lane, PH_FK);
  com_pos(T, s);
  crb(T, s);
  smooth_force<DAMP>(T, s, ctrl, in.qfrc_applied + (size_t)e * nv,
                     in.xfrc + (size_t)e * s.nb * 6,
                     DAMP ? in.damp + (size_t)e * nv : nullptr, qpos, qvel);
  if (T.h(FLAGS) & MUSCLE) muscle_block(T, s, ctrl);
  // qacc_smooth = M^-1 qfrc_smooth (inertia.factor_m, linalg.cho_solve)
  for (int a = s.lane; a < nv; a += kWarp)
    for (int b = 0; b <= a; ++b) s.L[a * nv + b] = s.M[a * nv + b];
  __syncwarp();
  wfactor_solve<false>(s, s.L, (const float*)s.vec(V_QFS), s.vec(V_ASM), nv,
                       false);
  phase_tick(e, s.lane, PH_SMOOTH);
  if constexpr (EXT)
    collide_ext(T, s);
  else
    collide(T, s);
  phase_tick(e, s.lane, PH_COLLISION);
  joint_rows(T, s, qpos, qvel);
  contact_rows_all<EXT, ELL>(T, s, qvel);
  phase_tick(e, s.lane, PH_ROWS);
  const Rows rows = rows_of(T, s);
  // the elliptic plans' Newton solve in double (see Solve)
  newton<typename std::conditional<ELL, double, float>::type>(
      s, rows, ELL, s.vec(V_WS), o.iterations, o.ls_iterations, o.scale,
      o.tol, iters, taken, ls_out, row_out);
  phase_tick(e, s.lane, PH_NEWTON);
}

// The one-forward kernel's outputs of the warp's env: qacc, qacc_smooth,
// qfrc = J'f with the row forces at the solution, the contact rows'
// forces, the slots' depths and geom ids (and points, where asked),
// euler_dv, act_dot.
template <bool EXT, bool ELL>
__device__ void forward_out(const Tab& T, const Out& out, const Env& s,
                            float* act_dot_out) {
  const int e = s.e, nv = s.nv, nrows = s.nrows, ncon = s.ncon;
  const float* x = s.vec(V_X);
  if constexpr (ELL)  // at the double solve's x
    row_forces(s, rows_of(T, s), ELL, (const double*)solve_vecs(s));
  else
    row_forces(s, rows_of(T, s), ELL, x);
  const float* F = s.ra(R_F);
  unsigned short* lf = s.list(L_F);
  const int nF = compact(s, nrows, lf, [&](int r) { return F[r] != 0.f; });
  for (int a = s.lane; a < nv; a += kWarp) {
    float q = 0.f;
    for (int i = 0; i < nF; ++i) q += s.jrow(lf[i])[a] * F[lf[i]];
    out.qfrc[(size_t)e * nv + a] = q;
    out.qacc_smooth[(size_t)e * nv + a] = s.vec(V_ASM)[a];
  }
  const int base = T.h(NE) + T.h(NFL) + T.h(NL) + T.h(NPAD);
  const int crows = nrows - base;
  for (int r = s.lane; r < crows; r += kWarp)
    out.cforce[(size_t)e * crows + r] = F[base + r];
  for (int c = s.lane; c < ncon; c += kWarp) {
    const float* S = s.slot(c);
    out.cdist[(size_t)e * ncon + c] = S[S_DIST];
    out.cgid[(size_t)e * ncon + c] = ibits(S[S_GID]);
    if constexpr (EXT) out.cgid1[(size_t)e * ncon + c] = ibits(S[S_GID1]);
    if (out.cpos)
      for (int k = 0; k < 3; ++k)
        out.cpos[((size_t)e * ncon + c) * 3 + k] = S[S_POS + k];
  }
  if (T.h(FLAGS) & MUSCLE) {
    const int na = T.h(NA);
    for (int a = s.lane; a < na; a += kWarp)
      act_dot_out[(size_t)e * na + a] = s.mus[na + a];
  }
  if (out.dv) {
    float* dv = s.vec(V_OUT);
    euler_dv(T, s, x, dv);
    for (int k = s.lane; k < nv; k += kWarp)
      out.dv[(size_t)e * nv + k] = dv[k];
  }
}

// The env's rows in the global scratch in.jrows where the launch keeps J
// there (ops/plan.py MegaLaunch.j_global); only the wide library has it.
__device__ __forceinline__ void place_rows(Env& s, const In& in) {
#if LMT_NVM > 24
  if (in.jrows) s.J = in.jrows + (size_t)s.e * s.nrows * s.nvj;
#endif
}

// The warp's env and its inputs in shared memory: qpos, qvel, ws (E, nv)
// and act (E, na) env-major; the row classes of an elliptic plan (ELL).
template <bool ELL>
__device__ Env load_env(const Tab& T, const In& in, float* smem,
                        int env_floats, int e, const float* qpos_in,
                        const float* qvel_in, const float* act_in,
                        const float* ws_in) {
  Env s = env_of(T, smem + (size_t)(threadIdx.x / kWarp) * env_floats, e);
  place_rows(s, in);
  const int nv = s.nv, na = T.h(NA);
  for (int k = s.lane; k < nv; k += kWarp) {
    s.vec(V_QPOS)[k] = qpos_in[(size_t)e * nv + k];
    s.vec(V_QVEL)[k] = qvel_in[(size_t)e * nv + k];
    s.vec(V_WS)[k] = ws_in[(size_t)e * nv + k];
  }
  if (T.h(FLAGS) & MUSCLE)
    for (int a = s.lane; a < na; a += kWarp)
      s.mus[a] = act_in[(size_t)e * na + a];
  if (ELL) row_classes(T, s);  // ends in a warp barrier
  __syncwarp();
  return s;
}

// One warp per env, kMaxEnvsPerBlock envs at most per block (blockDim.x /
// 32 of them), env_floats of dynamic shared memory each.
template <bool EXT, bool ELL, bool DAMP>
__global__ void __launch_bounds__(kWarp* kMaxEnvsPerBlock, 1)
    mega_forward_kernel(Tab T, Opt o, In in, Out out,
                        const float* __restrict__ qpos_in,
                        const float* __restrict__ qvel_in,
                        const float* __restrict__ act_in,
                        const float* __restrict__ ws_in,
                        float* __restrict__ qacc_out,
                        float* __restrict__ act_dot_out,
                        int* __restrict__ iters_out,
                        int* __restrict__ taken_out, int* __restrict__ ls_out,
                        int* __restrict__ rows_out, int env_floats) {
  extern __shared__ float smem[];
  const int e = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (e >= o.E) return;  // the whole warp
  const Env s = load_env<ELL>(T, in, smem, env_floats, e, qpos_in,
                              qvel_in, act_in, ws_in);
  phase_start(e, s.lane);
  const int nrw = (s.nrows + 31) >> 5;
  int it;
  unsigned taken;
  forward_env<EXT, ELL, DAMP>(
      T, o, in, s, s.vec(V_QPOS), s.vec(V_QVEL), it, taken,
      (unsigned*)ls_out + (size_t)e * kLsWords,
      (unsigned*)rows_out + (size_t)e * o.iterations * nrw);
  forward_out<EXT, ELL>(T, out, s, act_dot_out);
  const int nv = s.nv;
  for (int k = s.lane; k < nv; k += kWarp)
    qacc_out[(size_t)e * nv + k] = s.vec(V_X)[k];
  if (s.lane == 0) {
    iters_out[e] = it;
    taken_out[e] = (int)taken;
  }
  phase_tick(e, s.lane, PH_STEP);
}

// n substeps of RK4 (mj_RungeKutta's tableau; forward.py _rk4) or Euler
// (forward.py _euler; use_dv: qvel moves by euler_dv, else by qacc),
// carrying qpos, qvel, the activations (Euler) and the warm start.
// decisions (E, F n, dw), F = 4 for RK4 and 1 for Euler, dw = 2 +
// kLsWords + iterations (nrows + 31) / 32: the iteration count, the taken
// bits, the line search's decision bits and the rows' Hessian decision
// words of every forward, when not null.
template <bool EXT, bool ELL, bool DAMP>
__global__ void __launch_bounds__(kWarp* kMaxEnvsPerBlock, 1)
    megastep_kernel(Tab T, Opt o, In in, const float* __restrict__ qpos_in,
                    const float* __restrict__ qvel_in,
                    const float* __restrict__ act_in,
                    const float* __restrict__ ws_in,
                    float* __restrict__ qpos_out,
                    float* __restrict__ qvel_out,
                    float* __restrict__ act_out, float* __restrict__ ws_out,
                    int* __restrict__ decisions, int n_steps, float dt,
                    int rk4, int use_dv, int env_floats) {
  extern __shared__ float smem[];
  const int e = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (e >= o.E) return;  // the whole warp
  const Env s = load_env<ELL>(T, in, smem, env_floats, e, qpos_in,
                              qvel_in, act_in, ws_in);
  const int nv = s.nv, na = T.h(NA), lane = s.lane;
  const bool muscle = T.h(FLAGS) & MUSCLE;
  const float* act_lim = T.f(F_ACTB);  // (lo, hi) per act slot
  const int per = rk4 ? 4 : 1;  // forwards per substep
  const int dw = 2 + kLsWords + o.iterations * ((s.nrows + 31) >> 5);
  float* qpos = s.vec(V_QPOS);
  float* qvel = s.vec(V_QVEL);
  float* ws = s.vec(V_WS);
  const float* qacc = s.vec(V_X);
  // forward f's record, or null
  auto record = [&](int f) -> int* {
    return decisions ? decisions + ((size_t)e * per * n_steps + f) * dw
                     : nullptr;
  };
  auto put = [&](int* dd, int it, unsigned taken) {
    if (!dd || lane) return;
    dd[0] = it;
    dd[1] = (int)taken;
  };
  const float a[3] = {0.5f, 0.5f, 1.f};
  const float bw[4] = {1.f / 6, 1.f / 3, 1.f / 3, 1.f / 6};
  float* qs = s.vec(V_QS);
  float* vs = s.vec(V_VS);
  float* aq = s.vec(V_AQ);
  float* av = s.vec(V_AV);
  phase_start(e, lane);
  // the forwards in order from one call site, forward f being stage
  // f % per of substep f / per: the forward's code is most of the
  // kernel's, and a call site each for RK4 and Euler doubled the kernel's
  // instructions (67k for the elliptic instance) and, through instruction
  // fetch, its time (the A1-shaped model's megastep 91 against 53 ms,
  // PERF.md)
  for (int f = 0; f < per * n_steps; ++f) {
    const int i = f % per;
    if (rk4 && i == 0) {
      for (int k = lane; k < nv; k += kWarp) {
        qs[k] = qpos[k];
        vs[k] = qvel[k];
      }
      __syncwarp();
    }
    int it;
    unsigned taken;
    int* dd = record(f);
    forward_env<EXT, ELL, DAMP>(T, o, in, s, rk4 ? qs : qpos,
                                rk4 ? vs : qvel, it, taken,
                                dd ? (unsigned*)(dd + 2) : nullptr,
                                dd ? (unsigned*)(dd + 2 + kLsWords) : nullptr);
    put(dd, it, taken);
    // the updates round as the plain version's separate tensor operations
    // do (forward.euler, forward.rk4: each product, then each sum), so
    // that the two integrate the same accelerations to the same state
    if (!rk4) {
      float* dv = s.vec(V_OUT);
      if (use_dv)
        euler_dv(T, s, qacc, dv);
      else
        for (int k = lane; k < nv; k += kWarp) dv[k] = qacc[k];
      __syncwarp();
      for (int k = lane; k < nv; k += kWarp) {
        qvel[k] = __fadd_rn(qvel[k], __fmul_rn(dt, dv[k]));
        qpos[k] = __fadd_rn(qpos[k], __fmul_rn(dt, qvel[k]));
        ws[k] = qacc[k];
      }
      if (muscle)
        for (int k = lane; k < na; k += kWarp)
          s.mus[k] = fminf(fmaxf(__fadd_rn(s.mus[k],
                                           __fmul_rn(dt, s.mus[na + k])),
                                 act_lim[2 * k]),
                           act_lim[2 * k + 1]);
    } else {
      // stage 1 warm-starts from the carried value, stages 2-4 from the
      // stage-1 qacc (mj_step copies it before mj_RungeKutta's stages)
      const float dta = i < 3 ? dt * a[i] : 0.f;
      for (int k = lane; k < nv; k += kWarp) {
        aq[k] = i == 0 ? __fmul_rn(bw[0], vs[k])
                       : __fadd_rn(aq[k], __fmul_rn(bw[i], vs[k]));
        av[k] = i == 0 ? __fmul_rn(bw[0], qacc[k])
                       : __fadd_rn(av[k], __fmul_rn(bw[i], qacc[k]));
        if (i == 0) ws[k] = qacc[k];
        if (i < 3) {
          qs[k] = __fadd_rn(qpos[k], __fmul_rn(dta, vs[k]));
          vs[k] = __fadd_rn(qvel[k], __fmul_rn(dta, qacc[k]));
        } else {
          qpos[k] = __fadd_rn(qpos[k], __fmul_rn(dt, aq[k]));
          qvel[k] = __fadd_rn(qvel[k], __fmul_rn(dt, av[k]));
        }
      }
    }
    __syncwarp();
    phase_tick(e, lane, PH_STEP);
  }
  for (int k = lane; k < nv; k += kWarp) {
    qpos_out[(size_t)e * nv + k] = qpos[k];
    qvel_out[(size_t)e * nv + k] = qvel[k];
    ws_out[(size_t)e * nv + k] = ws[k];
  }
  for (int k = lane; k < na; k += kWarp)
    act_out[(size_t)e * na + k] = muscle ? s.mus[k] : act_in[(size_t)e * na + k];
}

// The instance of a kernel template that a launcher's ext (0: the
// plane-only collision; the extended collision with 1: elliptic rows and the
// double solve, 2: pyramidal rows) and damp (the damping rows) select,
// handed to go. The wide library (LMT_NVM > 24) compiles the plane-only
// and the extended pyramidal instances, with and without the rows, and
// returns cudaErrorNotSupported for the extended elliptic one (elliptic
// plans stop at nv 24, as the reference's do).
#if LMT_NVM > 24
#define LMT_INSTANCE(KERNEL, ext, damp, go)                        \
  ((ext) == 1 ? (int)cudaErrorNotSupported                          \
   : (damp)   ? ((ext) == 2 ? go(KERNEL<true, false, true>)         \
                            : go(KERNEL<false, false, true>))       \
              : ((ext) == 2 ? go(KERNEL<true, false, false>)        \
                            : go(KERNEL<false, false, false>)))
#else
#define LMT_INSTANCE(KERNEL, ext, damp, go)                      \
  ((damp) ? ((ext) == 1   ? go(KERNEL<true, true, true>)          \
             : (ext) == 2 ? go(KERNEL<true, false, true>)         \
                          : go(KERNEL<false, false, true>))       \
          : ((ext) == 1   ? go(KERNEL<true, true, false>)         \
             : (ext) == 2 ? go(KERNEL<true, false, false>)        \
                          : go(KERNEL<false, false, false>)))
#endif

// the kernel's dynamic shared memory limit past 48 KB, and all of the
// SM's shared memory for it
template <class K>
int prepare(K kernel, size_t bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                       100);
  return (int)cudaGetLastError();
}

}  // namespace

// ints/flts: the packed plan (ops/plan.py). Per-env inputs env-major:
// qpos (E, nq), qvel, ws (E, nv), act_in (E, na), ctrl (E, nu), qfrc_applied
// (E, nv), xfrc (E, nbody, 6), damp (E, nv) (each env's joint damping,
// for a plan with DAMP_ROWS; null selects the instances without the
// rows). Outputs env-major: qacc, qacc_smooth, qfrc (E, nv), cdist (E,
// ncon), cgid and cgid1 (E, ncon) int (geom 2 and, from the extended
// collision, geom 1), cforce (E, nrows - first contact row) in the plan's
// row layout, iters and taken (E,) int, ls (E, 4) int (the line search's
// decisions), rows (E, iterations, (nrows + 31) / 32) int (each step's
// Hessian decisions of the rows), dv (E, nv) or null (no euler_dv),
// act_dot (E, na) (written with muscles), cpos (E, ncon, 3) the slots'
// points, or null (the checks read them; the main path does not). jrows:
// the rows' J scratch (E, nrows, nv | 1) where the launch keeps J out of
// shared memory, else null (read by the wide library only). The launch
// (ops/plan.py MegaLaunch): env_floats of shared memory per env,
// envs_per_block envs (warps) per block. ext: 0 a plane-only plan, 1 a mega_ell plan with
// elliptic cones (the extended collision, elliptic rows, the double
// solve), 2 a mega_ell plan with pyramidal cones (LMT_INSTANCE).
extern "C" int lmt_mega_forward(
    const void* ints, const void* flts, const void* qpos, const void* qvel,
    const void* act_in, const void* ctrl, const void* qfrc_applied,
    const void* xfrc, const void* ws, const void* damp, void* qacc,
    void* qacc_smooth, void* qfrc, void* cdist, void* cgid, void* cgid1, void* cforce,
    void* iters, void* taken, void* ls, void* rows, void* dv, void* act_dot,
    void* cpos, void* jrows, int E, int iterations, int ls_iterations,
    int ext,
    int env_floats,
    int envs_per_block, float scale, float tol, void* stream) {
  if (E <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock || ext < 0 ||
      ext > 2)
    return (int)cudaErrorInvalidValue;
  const Tab T{(const int*)ints, (const float*)flts};
  const Opt o{E, iterations, ls_iterations, scale, tol};
  const In in{(const float*)ctrl, (const float*)qfrc_applied,
              (const float*)xfrc, (const float*)damp, (float*)jrows};
  const Out out{(float*)qacc_smooth, (float*)qfrc, (float*)cdist,
                (float*)cforce, (float*)dv, (int*)cgid, (int*)cgid1,
                (float*)cpos};
  const size_t bytes = (size_t)envs_per_block * env_floats * sizeof(float);
  const int grid = (E + envs_per_block - 1) / envs_per_block;
  auto go = [&](auto kernel) {
    const int rc = prepare(kernel, bytes);
    if (rc) return rc;
    kernel<<<grid, kWarp * envs_per_block, bytes, (cudaStream_t)stream>>>(
        T, o, in, out, (const float*)qpos, (const float*)qvel,
        (const float*)act_in, (const float*)ws, (float*)qacc,
        (float*)act_dot, (int*)iters, (int*)taken, (int*)ls, (int*)rows,
        env_floats);
    return (int)cudaGetLastError();
  };
  return LMT_INSTANCE(mega_forward_kernel, ext, damp, go);
}

// The same inputs; outputs qpos, qvel, ws (E, nv) and act_out (E, na)
// after n_steps substeps of `dt` (rk4: RK4, else Euler with use_dv);
// decisions (E, F n_steps, 2 + 4 + iterations (nrows + 31) / 32) int or
// null; jrows as for lmt_mega_forward.
extern "C" int lmt_megastep(
    const void* ints, const void* flts, const void* qpos, const void* qvel,
    const void* act_in, const void* ctrl, const void* qfrc_applied,
    const void* xfrc, const void* ws, const void* damp, void* qpos_out,
    void* qvel_out,
    void* act_out, void* ws_out, void* decisions, void* jrows, int E,
    int n_steps,
    int iterations, int ls_iterations, int rk4, int use_dv, int ext,
    int env_floats, int envs_per_block, float scale, float tol, float dt,
    void* stream) {
  if (E <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock || ext < 0 ||
      ext > 2)
    return (int)cudaErrorInvalidValue;
  const Tab T{(const int*)ints, (const float*)flts};
  const Opt o{E, iterations, ls_iterations, scale, tol};
  const In in{(const float*)ctrl, (const float*)qfrc_applied,
              (const float*)xfrc, (const float*)damp, (float*)jrows};
  const size_t bytes = (size_t)envs_per_block * env_floats * sizeof(float);
  const int grid = (E + envs_per_block - 1) / envs_per_block;
  auto go = [&](auto kernel) {
    const int rc = prepare(kernel, bytes);
    if (rc) return rc;
    kernel<<<grid, kWarp * envs_per_block, bytes, (cudaStream_t)stream>>>(
        T, o, in, (const float*)qpos, (const float*)qvel,
        (const float*)act_in, (const float*)ws, (float*)qpos_out,
        (float*)qvel_out, (float*)act_out, (float*)ws_out, (int*)decisions,
        n_steps, dt, rk4, use_dv, env_floats);
    return (int)cudaGetLastError();
  };
  return LMT_INSTANCE(megastep_kernel, ext, damp, go);
}

// Resident warps (envs) per SM of both kernels at this launch (out[0] the
// one-forward kernel, out[1] the megastep; damp: the instances with the
// damping rows), from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int lmt_mega_occupancy(int env_floats, int envs_per_block,
                                  int ext, int damp, int* out) {
  const size_t bytes = (size_t)envs_per_block * env_floats * sizeof(float);
  int n[2] = {0, 0};
  auto occ = [&](auto kernel, int* o) {
    const int rc = prepare(kernel, bytes);
    if (rc) return rc;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        o, kernel, kWarp * envs_per_block, bytes);
    return (int)cudaGetLastError();
  };
  if (ext < 0 || ext > 2) return (int)cudaErrorInvalidValue;
  auto fwd = [&](auto kernel) { return occ(kernel, n); };
  auto step = [&](auto kernel) { return occ(kernel, n + 1); };
  int rc = LMT_INSTANCE(mega_forward_kernel, ext, damp, fwd);
  if (!rc) rc = LMT_INSTANCE(megastep_kernel, ext, damp, step);
  out[0] = n[0] * envs_per_block;
  out[1] = n[1] * envs_per_block;
  return rc;
}

#ifdef LMT_PHASES
// The per-phase clock buffer (E, kPhases + 1) int64 of the next launches
// (tools/megastep_phases.py zeroes it).
extern "C" int lmt_mega_phases(void* buf) {
  long long* p = (long long*)buf;
  cudaMemcpyToSymbol(g_phase, &p, sizeof(p));
  return (int)cudaGetLastError();
}
#endif
