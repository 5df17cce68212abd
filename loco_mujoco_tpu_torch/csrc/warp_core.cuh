// The warp-per-env core of the port's constraint kernels: one warp owns one
// env, whose state lives in the block's dynamic shared memory. csrc/mega.cu
// (the mega forward and the megastep), csrc/fused.cu (the fused smooth
// stage, rows and solve) and csrc/newton.cu (the standalone Newton solve)
// include it, so the three kernels run one copy of each function:
//
// - the `Env` view over one env's shared region, laid out from a launch
//   census in ops/plan.py (`MegaLaunch` for the mega kernels, `FusedLaunch`
//   and `SolveLaunch` for the other two; the offsets in SHM order, `env_at`);
// - the warp helpers: sums in one fixed order by shuffles (`wsum`), the
//   first-index argmin (`wargmin`), ballot compaction of row lists
//   (`compact`), the Cholesky factor with both substitutions a column and
//   an unknown at a time (`wfactor_solve`), `wmat_vec`, `jdot`, `jar_wide`
//   and the elliptic cone zones (`cone_zone`, `cone_terms`);
// - the smooth stage from FK outputs (`com_pos`, `crb`, `smooth_force`,
//   `smooth_acc`), the constraint row builders (`joint_rows`,
//   `contact_rows`, `ell_contact_rows`, `contact_rows_all` over the mega
//   kernels' slots, `row_classes`), the Newton solve (`Solve<P>`, `newton`,
//   in float or, for elliptic rows, double), the row forces at the solution
//   (`row_forces`) and Euler's implicit damping (`euler_dv`);
// - the per-phase clocks of tools/megastep_phases.py (`phase_tick`), and
//   the launchers' shared-memory attributes (`prepare`).
//
// The formulas are forward_core.cuh's and newton_core.cuh's (`Tab`, `kbi`,
// `r_of`, `affine_force`, `Rows`), in the operation order of the port's
// staged path, which is the kernels' plain version. Everything here sits in
// an anonymous namespace: each kernel source compiles its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "forward_core.cuh"

namespace {

using namespace lmt;

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

// The env e's view of its shared region at base: sh, the launch census's
// offsets in SHM order (a table I_SHM of the plan, or the launcher's);
// h(k), the header count k of the kernel's problem (NV, NBODY, NROWS,
// NCON).
template <class H>
__device__ __forceinline__ Env env_at(const int* sh, float* base, int e,
                                      H&& h) {
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
  s.nv = h(NV);
  s.nvj = sh[SH_NVJ];
  s.rs = sh[SH_RS];
  s.sw = sh[SH_SLOTW];
  s.pmax = sh[SH_PMAX];
  s.kmax = sh[SH_KMAX];
  s.nb = h(NBODY);
  s.nrows = h(NROWS);
  s.ncon = h(NCON);
  s.e = e;
  s.lane = threadIdx.x & (kWarp - 1);
  return s;
}

// The view of a plan's env from its I_SHM table (the mega kernels').
__device__ Env env_of(const Tab& T, float* base, int e) {
  return env_at(T.i(I_SHM), base, e, [&](int k) { return T.h(k); });
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
// once for a float x): the returned forces are D times this difference of
// two nearly equal terms on stiff rows (impratio 100 on elliptic friction
// rows), so it is rounded once, at the end, as the plain version does
template <class X>
__device__ __forceinline__ X jar_wide(const float* j, const X* x, int nv,
                                      float aref) {
  double t = 0.0;
  for (int k = 0; k < nv; ++k) t += (double)j[k] * (double)x[k];
  return (X)(t - (double)aref);
}

// The cone zone of one elliptic contact at jar values s (its dim rows), in
// precision T: per-row force f and Hessian diagonal weight w, the cost c,
// and, in the middle zone, the rank-1 direction g (weight wg) and the
// curvature c2 (sum_k s_k^2 J_k J_k' - Jq Jq'), Jq = sum_k q_k s_k J_k, q_k =
// u_k / t, summed in Lagrange's form: c2 sum_{k<l} v_kl v_kl' with v_kl =
// q_l s_k J_k - q_k s_l J_l, plus c2 (1 - |q|^2) s_k^2 on the diagonal
// weights -- the same matrix without the difference of two terms that grow
// as 1/t near the apex (the plain version sums it so too).
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

// The zone of elliptic contact ci (rows r..r+d-1, active) at jar s, in
// cone-scaled coordinates u_k = jar_k sqrt(D_k / D_0) (solver.py:102-161):
// separating (no force), sticking (every row quadratic) or the middle zone
// (cost 0.5 D_0 / (1 + mu^2) (n - mu t)^2), with its loops unrolled over
// kDimMax, so that a lane keeps the cone's arrays in registers; in double
// (the elliptic plans' Newton solve) the same steps on the float inputs
// widened; s holds the contact's dim jar values (zero past dim).
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
// per component, each entry on its own lane. The armature is the plan's
// F_DOF column, or this env's `arm` (nv) where the caller gives one (the
// fused kernel's non-smooth layout, whose vector carries each env's).
__device__ void crb(const Tab& T, const Env& s,
                    const float* arm = nullptr) {
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
    if (a == b) m += arm ? arm[a] : df[2 * a + 1];
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

// qacc_smooth = M^-1 qfrc_smooth (inertia.factor_m, linalg.cho_solve):
// V_ASM from V_QFS, the factor of M into L.
__device__ __forceinline__ void smooth_acc(const Env& s) {
  const int nv = s.nv;
  for (int a = s.lane; a < nv; a += kWarp)
    for (int b = 0; b <= a; ++b) s.L[a * nv + b] = s.M[a * nv + b];
  __syncwarp();
  wfactor_solve<false>(s, s.L, (const float*)s.vec(V_QFS), s.vec(V_ASM), nv,
                       false);
}

// ---- constraint rows ------------------------------------------------------
// Each row goes to the env's arrays (constraint.make_constraint's
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
// times the rotational Jacobian as ax[3 + t] (one dof of
// constraint.make_constraint's contact Jacobian).
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
// the blocked layout; iw is the slot's invweight before the pyramid's
// 2 mu1^2 (1 + mu1^2).
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
// (constraint.make_constraint's elliptic branch; the reference's
// _forward_env_block :1654-1700): the normal, the tangents, then torsion
// and rolling from the rotational Jacobian, with aref = -b vel (- k imp pos
// on the normal) and R_n = r_of(imp, iw), R_k = max(R_n mu0^2 / (mu_k^2
// impratio), MINVAL) for the friction rows (fric: the 5 friction
// coefficients); *mu_out, where given, gets the cone coefficient
// mu0 / sqrt(impratio). dim 1 is one frictionless row.
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
// What loco_mujoco_tpu/ops/pallas_newton.py: solve_core computes, a warp per
// env: the cost-based warm-start select, then `iterations` rounds of (Hessian
// M + J'diag(w)J with the elliptic contacts' cone terms, Cholesky, the
// safeguarded-secant line search of `ls_iterations` steps on phi'), with
// MuJoCo's per-env termination: take a step only if it lowers the cost, and
// stop once the scaled improvement or the scaled gradient drops below the
// tolerance; x is exactly the x of the last accepted step (solve_core
// :671-710, solver.py:341-383). For elliptic plans (P double) the solve runs in double on the
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
// (iterations, (nrows + 31) / 32) words: ops/hopper_newton.py row_bits). The
// row quantities are newton_core.cuh's `Rows` over the env's arrays (E = 1,
// e = 0). Row
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
  // entry, each over the rows with a Hessian term in row order. An
  // elliptic contact's zone is formed
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
// aref taken in double: rounded once for a float x, kept in double with
// the forces for the double solve's x.
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


// The row quantities of the solve over the env's shared arrays.
__device__ Rows rows_of(const Tab& T, const Env& s) {
  return Rows{s.ra(R_AREF), s.ra(R_D), s.R,      s.fl,
              s.ra(R_ACT),  1,         0,        T.h(NE),
              T.h(NFL),     T.i(I_ELL), T.h(NELL), s.mu};
}

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
