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
// the reference), the Newton solve and Euler damping of warp_core.cuh,
// which csrc/fused.cu and csrc/newton.cu run too (its row quantities,
// `Rows`, are newton_core.cuh's). Differences from the Pallas kernel, none of
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
// bit-deterministic from run to run, and they record the discrete
// decisions of the solve (warp_core.cuh `newton`: the iteration count, the taken
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

#include "warp_core.cuh"

namespace {

using namespace lmt;

constexpr float kBig = 1e10f;

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


// ---- one forward, and the kernels ---------------------------------------------
// Outputs of one forward that the one-forward kernel writes (env-major);
// the megastep passes none.
struct Out {
  float *qacc_smooth, *qfrc, *cdist, *cforce, *dv;
  int *cgid, *cgid1;
  float* cpos;  // the slots' points (E, ncon, 3), or null
};

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
  smooth_acc(s);
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
