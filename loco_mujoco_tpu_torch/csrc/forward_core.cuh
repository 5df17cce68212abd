// Device code shared by the port's plan-driven kernels (csrc/mega.cu,
// csrc/fused.cu, through csrc/warp_core.cuh):
//
// - the reader of the packed plan tables (ops/plan.py: an int buffer that
//   starts with the header `Header`, and a float buffer), `Tab`;
// - the row formulas of constraint.make_constraint: the impedance
//   `kbi` and the regularizer `r_of`;
// - the small vector helpers of the smooth stage (`cross`, `inert_mul`)
//   and the joint actuators' force with their affine gain and bias
//   (`affine_force`, loco_mujoco_tpu/ops/pallas_constraint.py
//   _smooth_preamble :1126-1147).
//
// The arithmetic follows the port's staged path (kinematics.com_pos,
// inertia.crb, velocity.py, passive.py, actuation.py, constraint.py), the
// kernels' plain versions, in its operation order.

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

}  // namespace lmt
