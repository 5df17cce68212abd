// Device code of one env's forward, one thread per env, for csrc/fused.cu
// (FK outputs and contact slots passed in); csrc/mega.cu, a warp per env,
// shares its table reader, its row formulas (kbi, r_of, inert_mul) and,
// through newton_core.cuh, the solve's row quantities, and keeps its own
// warp-parallel counterparts of the rest. It holds
//
// - the reader of the packed plan tables (ops/plan.py: an int buffer that
//   starts with the header `Header`, and a float buffer);
// - the smooth stage from FK outputs (loco_mujoco_tpu/ops/
//   pallas_constraint.py _smooth_preamble :950-1180 and the in-kernel CRB
//   :1301-1346): com, cinert, cdof (com_pos), the CRB mass matrix and its
//   Cholesky factor (crb_factor), cvel / cdof_dot, the RNE bias, joint
//   springs and dampers, the joint actuators with their affine gain and
//   bias (affine_force), the xfrc projection and qfrc_smooth
//   (smooth_force), and qacc_smooth = M^-1 qfrc_smooth (smooth_acc);
// - the constraint row builders (:1374-1590): JOINT equalities, friction
//   loss, limits, the inert pad rows, the four pyramidal facets of one
//   contact slot in the reference's blocked facet layout (:1660-1665), and
//   the dim rows of one elliptic slot, slot-major (:1654-1700);
// - the constraint force pass (qfrc = J'f, :1864-1890) and Euler's
//   implicit damping dv = (M + h diag(damping))^-1 M qacc (:1893-1906).
//
// The arithmetic follows the port's staged path (kinematics.com_pos,
// inertia.crb, velocity.py, passive.py, actuation.py, constraint.py,
// linalg.py), the kernels' plain versions, in its operation order.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "newton_core.cuh"

namespace lmt {

constexpr int NVM = LMT_NVM;  // dofs (24, or 32: ops/plan.py NV_WIDTHS)
constexpr int BMAX = 32;  // bodies (BODY_MAX)
constexpr int MUSM = 128; // muscles and activations (MUS_MAX)
constexpr float kMinImp = 0.0001f, kMaxImp = 0.9999f;

// the int header of the packed tables, in ops/plan.py HEADER order
enum Header {
  NQ, NV, NBODY, NJNT, NU, NE, NFL, NL, NPAD, NROWS, NCON, FLAGS, NBOX,
  KBOX, OFFBOX, NCYL, KCYL, OFFCYL, NMESH, KMESH, OFFMESH, F_BODY, I_BODY,
  I_TOPO, F_JNT, I_JNT, F_DOF, I_DOF, I_ANC, I_DMASK, F_ACT, I_ACT, F_EQ,
  I_EQ, F_FL, I_FL, F_LIM, I_LIM, F_CON, F_BOX, I_BOX, F_CYL, I_CYL, F_MESH,
  I_MESH, F_VERT, PACKW, I_GBODY, NMOT, NA, NMUS, F_MUS, I_MUS, I_SEG,
  F_SITE, I_SITE, F_ACTB, NELL, I_ELL, NXGRP, I_XGRP, F_XGRP, I_XPAIR,
  F_XPAIR, I_CON, I_SHM
};
enum Flag {
  PASSIVE = 1, ACTUATION = 2, CLAMPCTRL = 4, REFSAFE = 8, UNIFORM = 16,
  FRIC_UNIFORM = 32, SMOOTH = 64, MUSCLE = 128, ELLIPTIC = 256,
  // per-env joint damping (the reference's sm_dyn_damping): the passive
  // force reads each env's damping row instead of F_DOF's column. The
  // launchers select the kernel instance that reads the rows (a template
  // parameter), so the instances without them are the plan's as before.
  DAMP_ROWS = 512
};
// F_CON: plane normal (3), plane point (3), contact frame (9), margin,
// solref (2), solimp (5), friction (2) -- zero unless UNIFORM -- then the
// timestep, gravity (3) and impratio
constexpr int kConFrame = 6, kConMargin = 15, kConSolref = 16,
              kConSolimp = 18, kConFric = 23, kConDt = 25, kConGravity = 26,
              kConImpratio = 29;

struct Tab {
  const int* I;
  const float* F;
  __device__ int h(int k) const { return I[k]; }
  __device__ const float* f(int k) const { return F + I[k]; }
  __device__ const int* i(int k) const { return I + I[k]; }
};

// Env-last row scratch of the solve (mu: the elliptic contacts' cone
// coefficients) and the solve's options.
struct Io {
  float *J, *aref, *D, *R, *act, *fl, *jar, *jv, *mu;
  int E, iterations, ls_iterations;
  float scale, tol;
};

// ---- small vector helpers (the port's ops/math.py formulas) -------------
__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// packed cinert [Ixx Iyy Izz Ixy Ixz Iyz mc(3) m] times a motion vector
__device__ void inert_mul(const float* ci, const float* v, float* o) {
  const float* w = v;
  const float* vl = v + 3;
  const float iw0 = ci[0] * w[0] + ci[3] * w[1] + ci[4] * w[2];
  const float iw1 = ci[3] * w[0] + ci[1] * w[1] + ci[5] * w[2];
  const float iw2 = ci[4] * w[0] + ci[5] * w[1] + ci[2] * w[2];
  float a[3], b[3];
  cross(ci + 6, vl, a);
  cross(ci + 6, w, b);
  o[0] = iw0 + a[0];
  o[1] = iw1 + a[1];
  o[2] = iw2 + a[2];
  for (int i = 0; i < 3; ++i) o[3 + i] = ci[9] * vl[i] - b[i];
}

__device__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// A joint actuator's force before its limit (actuation.actuation,
// `_smooth_preamble` :1126-1147): gain c + bias, the gain fixed or affine
// (g0 + g1 ln + g2 vel), the bias none or affine (b0 + b1 ln + b2 vel),
// ln = qpos[q] gear, vel = qvel[v] gear. A: the F_ACT entry (gear, g0, ctrl
// and force limits, g1, g2, b0, b1, b2), B: the I_ACT entry (v, limits,
// ctrl index, q, gain affine, bias affine). A motor (fixed gain, no bias)
// keeps its one product, gain c: its own branch, ahead of the affine
// terms, kept the plane-only megastep at its earlier time (a form that
// added a zero bias to every motor cost it ~1%). The affine terms round
// each product and sum on its own, in the reference's order, as the plain
// version does.
__device__ __forceinline__ float affine_force(const float* A, const int* B,
                                              float c, const float* qpos,
                                              const float* qvel) {
  if (!(B[5] | B[6])) return A[1] * c;
  float gain = A[1], bias = 0.f;
  const float ln = __fmul_rn(qpos[B[4]], A[0]);
  const float vel = __fmul_rn(qvel[B[0]], A[0]);
  if (B[5])
    gain = __fadd_rn(__fadd_rn(gain, __fmul_rn(A[6], ln)),
                     __fmul_rn(A[7], vel));
  if (B[6])
    bias = __fadd_rn(__fadd_rn(A[8], __fmul_rn(A[9], ln)),
                     __fmul_rn(A[10], vel));
  return __fadd_rn(__fmul_rn(gain, c), bias);
}

// constraint.kbi: stiffness, damping and impedance at `pos`
__device__ void kbi(const float* sr, const float* si, float pos, float dt,
                    bool refsafe, float& k, float& b, float& imp) {
  const float dmin = clampf(si[0], kMinImp, kMaxImp);
  const float dmax = clampf(si[1], kMinImp, kMaxImp);
  const float width = si[2];
  const float mid = clampf(si[3], kMinImp, kMaxImp);
  const float power = fmaxf(si[4], 1.f);
  const float x = clampf(fabsf(pos) / fmaxf(width, kMinVal), 0.f, 1.f);
  const float lo = powf(x, power) / powf(mid, power - 1.f);
  const float hi = 1.f - powf(1.f - x, power) / powf(1.f - mid, power - 1.f);
  const float y = x < mid ? lo : hi;
  imp = clampf(dmin + y * (dmax - dmin), kMinImp, kMaxImp);
  float tc = sr[0];
  const float dr = sr[1];
  if (refsafe) tc = fmaxf(tc, 2.f * dt);
  if (sr[0] <= 0.f || sr[1] <= 0.f) {
    k = -sr[0] / fmaxf(dmax * dmax, kMinVal);
    b = -sr[1] / fmaxf(dmax, kMinVal);
  } else {
    k = 1.f / fmaxf(dmax * dmax * tc * tc * dr * dr, kMinVal);
    b = 2.f / fmaxf(dmax * tc, kMinVal);
  }
}

__device__ float r_of(float imp, float iw) {
  return fmaxf((1.f - imp) / fmaxf(imp, kMinVal) * iw, kMinVal);
}

// Cholesky factor L of the SPD matrix A (row stride NVM; only its lower
// triangle is read, so L may be A), pivots floored at 1e-30
// (linalg.cholesky)
__device__ void cholesky(const float* A, float* L, int nv) {
  for (int j = 0; j < nv; ++j) {
    float d = A[j * NVM + j];
    for (int k = 0; k < j; ++k) d -= L[j * NVM + k] * L[j * NVM + k];
    const float dj = sqrtf(fmaxf(d, 1e-30f));
    L[j * NVM + j] = dj;
    for (int i = j + 1; i < nv; ++i) {
      float v = A[i * NVM + j];
      for (int k = 0; k < j; ++k) v -= L[i * NVM + k] * L[j * NVM + k];
      L[i * NVM + j] = v / dj;
    }
  }
}

// x = (L L')^-1 b (linalg.cho_solve)
__device__ void cho_solve(const float* L, const float* b, float* x, int nv) {
  float y[NVM];
  for (int i = 0; i < nv; ++i) {
    float v = b[i];
    for (int k = 0; k < i; ++k) v -= L[i * NVM + k] * y[k];
    y[i] = v / L[i * NVM + i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    float v = y[i];
    for (int k = i + 1; k < nv; ++k) v -= L[k * NVM + i] * x[k];
    x[i] = v / L[i * NVM + i];
  }
}

// ---- the smooth stage of one env -----------------------------------------
struct Body {
  float xipos[BMAX][3], ximat[BMAX][9];
  float xanchor[NVM][3], xaxis[NVM][3];
  float com[3];
  float cinert[BMAX][10], crb[BMAX][10];
  float cdof[NVM][6], cdof_dot[NVM][6];
  float cvel[BMAX][6], cfrc[BMAX][6];
  float M[NVM * NVM], L[NVM * NVM];
  float qfrc_smooth[NVM], asm_[NVM];
};

// com of the tree, cinert, cdof (kinematics.com_pos)
__device__ void com_pos(const Tab& T, Body& s) {
  const int nb = T.h(NBODY), njnt = T.h(NJNT);
  const float* bf = T.f(F_BODY);
  const int* ji = T.i(I_JNT);
  float wsum[3] = {0.f, 0.f, 0.f}, msum = 0.f;
  for (int b = 1; b < nb; ++b) {
    const float m = bf[20 * b + 14];
    for (int k = 0; k < 3; ++k) wsum[k] += m * s.xipos[b][k];
    msum += m;
  }
  for (int k = 0; k < 3; ++k) s.com[k] = wsum[k] / fmaxf(msum, 1e-12f);
  for (int k = 0; k < 10; ++k) s.cinert[0][k] = 0.f;  // the world: no mass
  for (int b = 1; b < nb; ++b) {
    const float* B = bf + 20 * b;
    const float m = B[14];
    const float* Id = B + 15;
    const float* R = s.ximat[b];
    float c[3];
    for (int k = 0; k < 3; ++k) c[k] = s.xipos[b][k] - s.com[k];
    const float c2 = c[0] * c[0] + c[1] * c[1] + c[2] * c[2];
    auto iw = [&](int i, int k) {
      const float v = R[3 * i] * Id[0] * R[3 * k] +
                      R[3 * i + 1] * Id[1] * R[3 * k + 1] +
                      R[3 * i + 2] * Id[2] * R[3 * k + 2];
      return v + m * ((i == k ? c2 : 0.f) - c[i] * c[k]);
    };
    float* ci = s.cinert[b];
    ci[0] = iw(0, 0);
    ci[1] = iw(1, 1);
    ci[2] = iw(2, 2);
    ci[3] = iw(0, 1);
    ci[4] = iw(0, 2);
    ci[5] = iw(1, 2);
    for (int k = 0; k < 3; ++k) ci[6 + k] = m * c[k];
    ci[9] = m;
  }
  for (int j = 0; j < njnt; ++j) {
    const int d = ji[4 * j + 2];
    const float* ax = s.xaxis[j];
    if (ji[4 * j]) {
      float off[3], lin[3];
      for (int k = 0; k < 3; ++k) off[k] = s.com[k] - s.xanchor[j][k];
      cross(ax, off, lin);
      for (int k = 0; k < 3; ++k) {
        s.cdof[d][k] = ax[k];
        s.cdof[d][3 + k] = lin[k];
      }
    } else {
      for (int k = 0; k < 3; ++k) {
        s.cdof[d][k] = 0.f;
        s.cdof[d][3 + k] = ax[k];
      }
    }
  }
}

// CRB mass matrix (+ armature: `arm`, nv floats, or the plan's when null)
// and its Cholesky factor (inertia.crb, inertia.factor_m)
__device__ void crb_factor(const Tab& T, Body& s, const float* arm) {
  const int nb = T.h(NBODY), nv = T.h(NV);
  const int* topo = T.i(I_TOPO);
  const int* bi = T.i(I_BODY);
  const int* dof_body = T.i(I_DOF);
  const int* anc = T.i(I_ANC);
  const float* df = T.f(F_DOF);
  for (int b = 0; b < nb; ++b)
    for (int k = 0; k < 10; ++k) s.crb[b][k] = s.cinert[b][k];
  for (int t = nb - 2; t >= 0; --t) {  // children into parents
    const int b = topo[t], p = bi[4 * b];
    for (int k = 0; k < 10; ++k) s.crb[p][k] += s.crb[b][k];
  }
  for (int a = 0; a < nv; ++a) {
    float buf[6];
    inert_mul(s.crb[dof_body[a]], s.cdof[a], buf);
    for (int b = 0; b <= a; ++b) {
      float m = 0.f;
      if (anc[a * nv + b]) {
        m = buf[0] * s.cdof[b][0];
        for (int i = 1; i < 6; ++i) m += buf[i] * s.cdof[b][i];
      }
      if (a == b) m += arm ? arm[a] : df[2 * a + 1];
      s.M[a * NVM + b] = m;
      s.M[b * NVM + a] = m;
    }
  }
  cholesky(s.M, s.L, nv);
}

// Velocity stage, passive, motors and xfrc: qfrc_smooth. ctrl (nu),
// qfrc_applied (nv) and xfrc (nbody, 6) are this env's inputs; DAMP: damp
// (nv) is its joint damping (DAMP_ROWS), else the plan's F_DOF column
// serves and damp is not read.
template <bool DAMP>
__device__ void smooth_force(const Tab& T, const float* ctrl,
                             const float* qfrc_applied, const float* xfrc,
                             const float* damp, const float* qpos,
                             const float* qvel, Body& s) {
  const int nb = T.h(NBODY), nv = T.h(NV), nmot = T.h(NMOT), njnt = T.h(NJNT);
  const int flags = T.h(FLAGS);
  const int* topo = T.i(I_TOPO);
  const int* bi = T.i(I_BODY);
  const int* dof_body = T.i(I_DOF);
  const int* anc = T.i(I_ANC);
  const int* dmask = T.i(I_DMASK);
  const float* con = T.f(F_CON);

  // com_vel: cvel of every body, cdof_dot from the strict-ancestor velocity
  float vd[NVM][6];
  for (int d = 0; d < nv; ++d)
    for (int i = 0; i < 6; ++i) vd[d][i] = s.cdof[d][i] * qvel[d];
  for (int b = 0; b < nb; ++b)
    for (int i = 0; i < 6; ++i) {
      float v = 0.f;
      for (int d = 0; d < nv; ++d)
        if (dmask[b * nv + d]) v += vd[d][i];
      s.cvel[b][i] = v;
    }
  for (int d = 0; d < nv; ++d) {
    float vb[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int k = 0; k < nv; ++k)
      if (k != d && anc[d * nv + k])
        for (int i = 0; i < 6; ++i) vb[i] += vd[k][i];
    float a[3], l1[3], l2[3];
    cross(vb, s.cdof[d], a);
    cross(vb, s.cdof[d] + 3, l1);
    cross(vb + 3, s.cdof[d], l2);
    for (int i = 0; i < 3; ++i) {
      s.cdof_dot[d][i] = a[i];
      s.cdof_dot[d][3 + i] = l1[i] + l2[i];
    }
  }
  // rne with zero acceleration: cfrc, subtree sums, bias
  for (int b = 0; b < nb; ++b) {
    float cacc[6];
    for (int i = 0; i < 3; ++i) cacc[i] = 0.f;
    for (int i = 0; i < 3; ++i) cacc[3 + i] = -con[kConGravity + i];
    float ad[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int d = 0; d < nv; ++d)
      if (dmask[b * nv + d])
        for (int i = 0; i < 6; ++i) ad[i] += s.cdof_dot[d][i] * qvel[d];
    for (int i = 0; i < 6; ++i) cacc[i] = cacc[i] + ad[i];
    float ia[6], iv[6], a1[3], a2[3], l[3];
    inert_mul(s.cinert[b], cacc, ia);
    inert_mul(s.cinert[b], s.cvel[b], iv);
    cross(s.cvel[b], iv, a1);
    cross(s.cvel[b] + 3, iv + 3, a2);
    cross(s.cvel[b], iv + 3, l);
    for (int i = 0; i < 3; ++i) {
      s.cfrc[b][i] = ia[i] + (a1[i] + a2[i]);
      s.cfrc[b][3 + i] = ia[3 + i] + l[i];
    }
  }
  for (int t = nb - 2; t >= 0; --t) {
    const int b = topo[t], p = bi[4 * b];
    for (int i = 0; i < 6; ++i) s.cfrc[p][i] += s.cfrc[b][i];
  }
  float passive[NVM], actf[NVM];
  for (int d = 0; d < nv; ++d) passive[d] = actf[d] = 0.f;
  if (flags & PASSIVE) {
    const float* jf = T.f(F_JNT);
    const int* ji = T.i(I_JNT);
    const float* df = T.f(F_DOF);
    for (int j = 0; j < njnt; ++j) {
      const float* Jf = jf + 10 * j;
      passive[ji[4 * j + 2]] += -Jf[7] * (qpos[ji[4 * j + 1]] - Jf[8]);
    }
    for (int d = 0; d < nv; ++d)
      passive[d] = passive[d] - (DAMP ? damp[d] : df[2 * d]) * qvel[d];
  }
  if (nmot) {  // the joint actuators: ctrl index ai[8 m + 3]
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
  // xfrc projection (forward._xfrc_projection); zero wrenches add nothing
  float xf[NVM];
  for (int d = 0; d < nv; ++d) xf[d] = 0.f;
  for (int b = 1; b < nb; ++b) {
    const float* w = xfrc + (size_t)b * 6;
    bool any = false;
    for (int i = 0; i < 6; ++i) any |= w[i] != 0.f;
    if (!any) continue;
    float off[3], oxf[3], te[3];
    for (int k = 0; k < 3; ++k) off[k] = s.xipos[b][k] - s.com[k];
    cross(off, w, oxf);
    for (int k = 0; k < 3; ++k) te[k] = w[3 + k] + oxf[k];
    for (int d = 0; d < nv; ++d) {
      if (!dmask[b * nv + d]) continue;
      const float* u = s.cdof[d];
      xf[d] += u[0] * te[0] + u[1] * te[1] + u[2] * te[2] + u[3] * w[0] +
               u[4] * w[1] + u[5] * w[2];
    }
  }
  for (int d = 0; d < nv; ++d) {
    const float* f6 = s.cfrc[dof_body[d]];
    float bias = s.cdof[d][0] * f6[0];
    for (int i = 1; i < 6; ++i) bias += s.cdof[d][i] * f6[i];
    s.qfrc_smooth[d] = passive[d] - bias + actf[d] + qfrc_applied[d] + xf[d];
  }
}

// qacc_smooth = M^-1 qfrc_smooth with the factor (linalg.cho_solve)
__device__ void smooth_acc(const Tab& T, Body& s) {
  cho_solve(s.L, s.qfrc_smooth, s.asm_, T.h(NV));
}

// ---- constraint rows -------------------------------------------------------
// Every row gets its act flag and, when active, J (env-last (nrows, nv, E)),
// aref, D and R (constraint.make_constraint's formulas).
struct RowWriter {
  const Io& io;
  int e, nv;
  __device__ size_t at(int r) const { return (size_t)r * io.E + e; }
  __device__ float& J(int r, int k) const {
    return io.J[((size_t)r * nv + k) * io.E + e];
  }
  __device__ void off(int r) const { io.act[at(r)] = 0.f; }
  __device__ void set(int r, float aref, float R) const {
    io.aref[at(r)] = aref;
    io.R[at(r)] = R;
    io.D[at(r)] = 1.f / R;
    io.act[at(r)] = 1.f;
  }
  __device__ void finish(int r, float k, float b, float imp, float pos,
                         float vel, float iw) const {
    const float R = r_of(imp, iw);
    io.aref[at(r)] = -b * vel - k * imp * pos;
    io.R[at(r)] = R;
    io.D[at(r)] = 1.f / R;
    io.act[at(r)] = 1.f;
  }
};

// The JOINT-equality, friction-loss, limit and inert pad rows, in that
// order from row 0; returns the first contact row.
__device__ int joint_rows(const Tab& T, const RowWriter& w,
                          const float* qpos, const float* qvel) {
  const int nv = T.h(NV), ne = T.h(NE), nfl = T.h(NFL), nl = T.h(NL);
  const int npad = T.h(NPAD);
  const bool refsafe = T.h(FLAGS) & REFSAFE;
  const float dt = T.f(F_CON)[kConDt];
  int r = 0;
  const float* ef = T.f(F_EQ);
  const int* ei = T.i(I_EQ);
  for (int q = 0; q < ne; ++q, ++r) {
    const float* A = ef + 16 * q;
    const int* B = ei + 4 * q;
    const float m2 = A[12];
    const float dif = m2 * (qpos[B[2]] - A[15]);
    const float poly = A[0] + A[1] * dif + A[2] * (dif * dif) +
                       A[3] * (dif * dif * dif) +
                       A[4] * (dif * dif * dif * dif);
    const float dpoly = A[1] + 2.f * A[2] * dif + 3.f * A[3] * (dif * dif) +
                        4.f * A[4] * (dif * dif * dif);
    const float pos = qpos[B[0]] - A[14] - poly;
    for (int k = 0; k < nv; ++k)
      w.J(r, k) = (k == B[1] ? 1.f : 0.f) - (k == B[3] ? dpoly * m2 : 0.f);
    float vel = 0.f;
    for (int k = 0; k < nv; ++k) vel += w.J(r, k) * qvel[k];
    float kk, bb, imp;
    kbi(A + 5, A + 7, pos, dt, refsafe, kk, bb, imp);
    w.finish(r, kk, bb, imp, pos, vel, A[13]);
  }
  const float* ff = T.f(F_FL);
  const int* fi = T.i(I_FL);
  for (int q = 0; q < nfl; ++q, ++r) {
    const float* A = ff + 10 * q;
    for (int k = 0; k < nv; ++k) w.J(r, k) = k == fi[q] ? 1.f : 0.f;
    float kk, bb, imp;
    kbi(A, A + 2, 0.f, dt, refsafe, kk, bb, imp);
    w.finish(r, kk, bb, imp, 0.f, qvel[fi[q]], A[8]);
    w.io.fl[(size_t)q * w.io.E + w.e] = A[7];
  }
  const float* lf = T.f(F_LIM);
  const int* li = T.i(I_LIM);
  for (int q = 0; q < nl; ++q, ++r) {
    const float* A = lf + 12 * q;
    const float x = qpos[li[2 * q]];
    const float dlo = x - A[0], dhi = A[1] - x;
    const bool use_lo = dlo <= dhi;
    const float dist = use_lo ? dlo : dhi;
    const float sign = use_lo ? 1.f : -1.f;
    if (!(dist < A[2])) {
      w.off(r);
      continue;
    }
    const int v = li[2 * q + 1];
    for (int k = 0; k < nv; ++k) w.J(r, k) = k == v ? sign : 0.f;
    const float pos = dist - A[2];
    float kk, bb, imp;
    kbi(A + 3, A + 5, pos, dt, refsafe, kk, bb, imp);
    w.finish(r, kk, bb, imp, pos, sign * qvel[v], A[10]);
  }
  for (int q = 0; q < npad; ++q, ++r) w.off(r);
  return r;
}

// The frame rows times the point Jacobian of a contact at cpos between
// bodies b1 and b2 (its chain mask is b2's minus b1's; b < 0: none):
// ax[t][v] for t = 0..2, and with `rot` the frame rows times the rotational
// Jacobian as ax[3 + t][v] (torsion and rolling rows).
__device__ void contact_axes(const Tab& T, const Body& s, const float* cpos,
                             const float* frame, int b1, int b2, bool rot,
                             float (*ax)[NVM]) {
  const int nv = T.h(NV);
  const int* dmask = T.i(I_DMASK);
  float off[3];
  for (int i = 0; i < 3; ++i) off[i] = cpos[i] - s.com[i];
  for (int v = 0; v < nv; ++v) {
    const float m = (b2 >= 0 ? (float)dmask[b2 * nv + v] : 0.f) -
                    (b1 >= 0 ? (float)dmask[b1 * nv + v] : 0.f);
    float jp[3] = {0.f, 0.f, 0.f}, jr[3] = {0.f, 0.f, 0.f};
    if (m != 0.f) {
      const float* u = s.cdof[v];
      jp[0] = m * ((u[1] * off[2] - u[2] * off[1]) + u[3]);
      jp[1] = m * ((u[2] * off[0] - u[0] * off[2]) + u[4]);
      jp[2] = m * ((u[0] * off[1] - u[1] * off[0]) + u[5]);
      for (int i = 0; i < 3; ++i) jr[i] = m * u[i];
    }
    for (int t = 0; t < 3; ++t) {
      const float* fr = frame + 3 * t;
      ax[t][v] = fr[0] * jp[0] + fr[1] * jp[1] + fr[2] * jp[2];
      if (rot) ax[3 + t][v] = fr[0] * jr[0] + fr[1] * jr[1] + fr[2] * jr[2];
    }
  }
}

// One active condim-3 contact slot c: facet f (J = Jn +- mu_t Jt, f = 0..3
// for +mu1 t1, -mu1 t1, +mu2 t2, -mu2 t2) goes to row s0 + f ncon + c, the
// blocked layout.
// The point Jacobian is masked by the chain of body b2 minus that of b1
// (b < 0: none); `frame` holds the rows n, t1, t2; iw is the slot's
// invweight before the pyramid's 2 mu1^2 (1 + mu1^2).
__device__ void contact_rows(const Tab& T, const RowWriter& w, int s0, int c,
                             const Body& s, const float* cpos,
                             const float* frame, int b1, int b2, float pos,
                             const float* sr, const float* si, float iw,
                             float mu1, float mu2, const float* qvel) {
  const int nv = T.h(NV), ncon = T.h(NCON);
  const bool refsafe = T.h(FLAGS) & REFSAFE;
  const float dt = T.f(F_CON)[kConDt];
  float ax[3][NVM];  // frame rows times the point Jacobian
  contact_axes(T, s, cpos, frame, b1, b2, false, ax);
  float kk, bb, imp;
  kbi(sr, si, pos, dt, refsafe, kk, bb, imp);
  const float iwp = iw * 2.f * mu1 * mu1 * (1.f + mu1 * mu1);
  const float mus[2] = {mu1, mu2};
  for (int f = 0; f < 4; ++f) {
    const int t = 1 + f / 2;
    const float sm = (f & 1 ? -1.f : 1.f) * mus[t - 1];
    const int r = s0 + f * ncon + c;
    float vel = 0.f;
    for (int v = 0; v < nv; ++v) {
      const float jv = ax[0][v] + sm * ax[t][v];
      w.J(r, v) = jv;
      vel += jv * qvel[v];
    }
    w.finish(r, kk, bb, imp, pos, vel, iwp);
  }
}

// One active elliptic contact slot (constraint.make_constraint's elliptic
// branch; the reference's _forward_env_block :1654-1700): dim rows from row
// r0, slot-major -- the normal, the tangents, then torsion and rolling from
// the rotational Jacobian -- with aref = -b vel (- k imp pos on the normal)
// and R_n = r_of(imp, iw), R_k = max(R_n mu0^2 / (mu_k^2 impratio), MINVAL)
// for the friction rows (fric: the 5 friction coefficients); *mu_out gets
// the cone coefficient mu0 / sqrt(impratio). dim 1 is one frictionless row.
__device__ void ell_contact_rows(const Tab& T, const RowWriter& w, int r0,
                                 int dim, const Body& s, const float* cpos,
                                 const float* frame, int b1, int b2,
                                 float pos, const float* sr, const float* si,
                                 float iw, const float* fric,
                                 const float* qvel, float* mu_out) {
  const int nv = T.h(NV);
  const bool refsafe = T.h(FLAGS) & REFSAFE;
  const float* con = T.f(F_CON);
  const float dt = con[kConDt], impratio = con[kConImpratio];
  float ax[6][NVM];
  contact_axes(T, s, cpos, frame, b1, b2, dim > 3, ax);
  float kk, bb, imp;
  kbi(sr, si, pos, dt, refsafe, kk, bb, imp);
  const float rn = r_of(imp, iw);
  const float mu = fric[0];
  for (int t = 0; t < dim; ++t) {
    const int r = r0 + t;
    float vel = 0.f;
    for (int v = 0; v < nv; ++v) {
      w.J(r, v) = ax[t][v];
      vel += ax[t][v] * qvel[v];
    }
    const float aref = t == 0 ? -bb * vel - kk * imp * pos : -bb * vel;
    const float R = t == 0 ? rn
                           : fmaxf(rn * (mu * mu) /
                                       (fric[t - 1] * fric[t - 1]) / impratio,
                                   kMinVal);
    w.set(r, aref, R);
  }
  if (mu_out) *mu_out = mu / sqrtf(impratio);
}

// The Newton solve of the rows, then the force of every row (put(r, f))
// and qfrc = J'f; qacc, the decisions (iters, taken and, where given, the
// line search's ls_bits and the rows' row_bits) out.
template <class Put>
__device__ void solve_rows(const Tab& T, const Io& io, int e, const Body& s,
                           const float* ws, float* qacc, float* qfrc,
                           int& iters, unsigned& taken, unsigned* ls_bits,
                           unsigned* row_bits, Put&& put) {
  const int nv = T.h(NV), nrows = T.h(NROWS);
  const Rows rows{io.aref, io.D,    io.R,    io.fl,     io.act,
                  (size_t)io.E, e,  T.h(NE), T.h(NFL),  T.i(I_ELL),
                  T.h(NELL),    io.mu};
  auto Mat = [&](int a, int b) { return s.M[a * NVM + b]; };
  newton_solve<NVM>(io.J, rows, Mat, s.asm_, ws, qacc, io.jar, io.jv, nv,
                    nrows, io.iterations, io.ls_iterations, io.scale, io.tol,
                    iters, taken, ls_bits, row_bits);
  if (!qfrc) return;
  for (int k = 0; k < nv; ++k) qfrc[k] = 0.f;
  row_forces<NVM>(io.J, rows, qacc, nv, nrows,
                  [&](int r, float f, const float* jr) {
                    if (f != 0.f)
                      for (int k = 0; k < nv; ++k) qfrc[k] += jr[k] * f;
                    put(r, f);
                  });
}

// Euler's implicit damping (pallas_constraint.py:1893-1906):
// dv = (M + h diag(damping))^-1 (M qacc), with M of this forward; the
// factor of M in s.L is overwritten by that of M + h diag(damping)
// (factored in place).
__device__ void euler_dv(const Tab& T, Body& s, const float* qacc, float* dv) {
  const int nv = T.h(NV);
  const float h = T.f(F_CON)[kConDt];
  const float* df = T.f(F_DOF);
  float mq[NVM];
  for (int a = 0; a < nv; ++a) {
    float v = 0.f;
    for (int b = 0; b < nv; ++b) v += s.M[a * NVM + b] * qacc[b];
    mq[a] = v;
    for (int b = 0; b < a; ++b) s.L[a * NVM + b] = s.M[a * NVM + b];
    s.L[a * NVM + a] = s.M[a * NVM + a] + h * df[2 * a];
  }
  cholesky(s.L, s.L, nv);
  cho_solve(s.L, mq, dv, nv);
}

}  // namespace lmt
