// The mega path: a whole forward (FK, collision, smooth stage, constraint
// rows, Newton solve) as one kernel, and a whole control step (n RK4
// substeps of four forwards each) as one kernel. One thread owns one env.
//
// mega_forward_kernel replaces the Pallas program of
// loco_mujoco_tpu/ops/pallas_constraint.py: _mega_batched (its pallas_call)
// with its body _make_fused_kernel(mega=True) -> _forward_env_block, which
// inlines pallas_fk.fk_env_block, pallas_fk.collide_env_block (plane-box
// _box_slots and plane-mesh _mesh_group_slots with top-K), _smooth_preamble,
// the CRB mass matrix and qacc_smooth by Cholesky, the JOINT-equality /
// friction-loss / limit / pyramidal contact rows and solve_core.
// megastep_kernel replaces _megastep_batched (its pallas_call) with its
// body _make_megastep_kernel, RK4 branch: the same forward looped over the
// four RK4 stages of each of n substeps, carrying qpos, qvel and the warm
// start (stage 1 warm-starts from the carried value; its qacc warm-starts
// stages 2-4 and the next substep, pallas_constraint.py:2731-2755).
//
// The arithmetic follows the port's staged path, which is these kernels'
// plain version (ops/hopper_mega.py): kinematics.py, inertia.py,
// velocity.py, passive.py, actuation.py, collision.py with the plane-mesh
// select and top-K of plane_mesh.cu, constraint.py, and the Newton solve of
// newton_core.cuh (the one Newton code, shared with newton.cu). Differences
// from the Pallas kernel, none of which changes a result beyond summation
// order: each thread decides its own conservative skip of the plane-mesh
// vertex walk (the TPU block decided for 1,024 envs at once), computes the
// neighbour manifold only for the pairs the top-K selects, and skips its
// own inactive constraint rows in every solve pass, so the reference's
// fast/full branch pair (mega_fast) has no counterpart here.
//
// Static tables: two read-only buffers built once per model by
// ops/plan.py (an int buffer that starts with the header `Header`, and a
// float buffer): the body tree, joints, dofs, actuators, the equality /
// friction-loss / limit rows, the contact statics, the plane-box pairs, the
// plane-mesh pairs and their vertex and neighbour tables (CSR offsets into
// one flat table, each hull at its own vertex count). All threads of a warp
// read the same entry at the same step, so those loads broadcast.
//
// Layout: the inputs and outputs are env-major (E, k) as the Data fields
// hold them (each thread reads and writes its own k contiguous values), so
// no relayout kernel runs around these kernels. The constraint rows go to
// global scratch allocated by the wrapper, env-last ((nrows, nv, E) for J),
// so the solve's row passes coalesce, as in newton.cu.
//
// Bound: operations, not bytes. Per forward an env reads ~0.5 KB of state
// and writes ~0.4 KB, but does ~10^5 float operations (the mesh height maps
// of near pairs, the CRB and Cholesky, and the Newton iterations over its
// active rows). What limits this first version is latency and occupancy:
// one thread per env gives E / 32 warps (128 at 4096 envs for 132 SMs, the
// limit that makes the standalone Newton kernel slow), and the per-thread
// state (body frames, cinert, M and its factor, contact slots, the Hessian)
// lives in local memory, cached in L1/L2. The design keeps everything of a
// forward on chip or in L2 and launches once per forward (or once per
// control step), which removes the staged path's thousands of launches;
// spreading an env over a warp is left to later work.
//
// Rounding: the collision functions (geom_pose, box_slots, collide) write
// each product and each sum with __fmul_rn / __fadd_rn / __fsub_rn, which
// nvcc never fuses into a multiply-add, so they round as the plain
// versions' separate operations do and the active contact sets match. The
// rest of the file is compiled with contraction on, as newton.cu is.

#include <cuda_runtime.h>
#include <math.h>

#include "newton_core.cuh"

namespace {

constexpr int NVM = 24;   // dofs (ops/plan.py NV_MAX)
constexpr int BMAX = 32;  // bodies (BODY_MAX)
constexpr int CMAX = 64;  // contact slots (CON_MAX)
constexpr int PMAX = 128; // plane-mesh pairs (PAIR_MAX)
constexpr float kBig = 1e10f;
constexpr float kMinImp = 0.0001f, kMaxImp = 0.9999f;
constexpr float kMinVal = 1e-15f;

// the int header of the packed tables, in ops/plan.py HEADER order
enum Header {
  NQ, NV, NBODY, NJNT, NU, NE, NFL, NL, NPAD, NROWS, NCON, FLAGS, NBOX,
  KBOX, OFFBOX, NMESH, KMESH, OFFMESH, F_BODY, I_BODY, I_TOPO, F_JNT, I_JNT,
  F_DOF, I_DOF, I_ANC, I_DMASK, F_ACT, I_ACT, F_EQ, I_EQ, F_FL, I_FL, F_LIM,
  I_LIM, F_CON, F_BOX, I_BOX, F_MESH, I_MESH, F_VERT
};
enum Flag { PASSIVE = 1, ACTUATION = 2, CLAMPCTRL = 4, REFSAFE = 8 };

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

// ---- per-thread state ----------------------------------------------------
struct State {
  float xpos[BMAX][3], xquat[BMAX][4], xmat[BMAX][9];
  float xipos[BMAX][3], ximat[BMAX][9];
  float xanchor[NVM][3], xaxis[NVM][3];
  float com[3];
  float cinert[BMAX][10], crb[BMAX][10];
  float cdof[NVM][6], cdof_dot[NVM][6];
  float cvel[BMAX][6], cfrc[BMAX][6];
  float M[NVM * NVM], L[NVM * NVM];
  float qfrc_smooth[NVM], asm_[NVM];
  float cpos[CMAX][3], cdist[CMAX];
  int cbody[CMAX], cgid[CMAX];
  float d0[PMAX];  // support depth, or the conservative bound
  int i0[PMAX];    // support vertex
};

// Env-major per-env inputs held constant over a control step, and the
// env-last row scratch of the solve.
struct Io {
  const float* ctrl;
  const float* qfrc_applied;
  const float* xfrc;
  float *J, *aref, *D, *R, *act, *fl, *jar, *jv;
  int E, iterations, ls_iterations;
  float scale, tol;
};

// ---- position stage ------------------------------------------------------
__device__ void fk(const Tab& T, const float* qpos, State& s) {
  const int nb = T.h(NBODY);
  const float* bf = T.f(F_BODY);
  const int* bi = T.i(I_BODY);
  const float* jf = T.f(F_JNT);
  const int* ji = T.i(I_JNT);
  const int* topo = T.i(I_TOPO);
  for (int k = 0; k < 3; ++k) s.xpos[0][k] = 0.f;
  s.xquat[0][0] = 1.f;
  s.xquat[0][1] = s.xquat[0][2] = s.xquat[0][3] = 0.f;
  for (int t = 0; t < nb - 1; ++t) {
    const int b = topo[t];
    const int p = bi[4 * b];
    const float* B = bf + 20 * b;
    float pos[3], quat[4], r[3];
    quat_rotate(s.xquat[p], B, r);
    for (int k = 0; k < 3; ++k) pos[k] = s.xpos[p][k] + r[k];
    quat_mul(s.xquat[p], B + 3, quat);
    const int j0 = bi[4 * b + 1], nj = bi[4 * b + 2];
    for (int j = j0; j < j0 + nj; ++j) {
      const float* Jf = jf + 10 * j;
      const float* jp = Jf;
      const float* ja = Jf + 3;
      float anchor[3], axis[3];
      quat_rotate(quat, jp, r);
      for (int k = 0; k < 3; ++k) anchor[k] = pos[k] + r[k];
      quat_rotate(quat, ja, axis);
      for (int k = 0; k < 3; ++k) {
        s.xanchor[j][k] = anchor[k];
        s.xaxis[j][k] = axis[k];
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
    for (int k = 0; k < 3; ++k) s.xpos[b][k] = pos[k];
    for (int k = 0; k < 4; ++k) s.xquat[b][k] = quat[k];
  }
  for (int b = 0; b < nb; ++b) {
    const float* B = bf + 20 * b;
    float r[3], im[9];
    quat_to_mat(s.xquat[b], s.xmat[b]);
    quat_rotate(s.xquat[b], B + 7, r);
    for (int k = 0; k < 3; ++k) s.xipos[b][k] = s.xpos[b][k] + r[k];
    quat_to_mat(B + 10, im);
    mat_mul3(s.xmat[b], im, s.ximat[b]);
  }
}

// com of the tree, cinert, cdof (kinematics.com_pos)
__device__ void com_pos(const Tab& T, State& s) {
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

// CRB mass matrix (+ armature) and its Cholesky factor (inertia.crb,
// inertia.factor_m; pivots floored at 1e-30 as linalg.cholesky)
__device__ void crb_factor(const Tab& T, State& s) {
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
      if (a == b) m += df[2 * a + 1];
      s.M[a * NVM + b] = m;
      s.M[b * NVM + a] = m;
    }
  }
  for (int j = 0; j < nv; ++j) {
    float d = s.M[j * NVM + j];
    for (int k = 0; k < j; ++k) d -= s.L[j * NVM + k] * s.L[j * NVM + k];
    const float dj = sqrtf(fmaxf(d, 1e-30f));
    s.L[j * NVM + j] = dj;
    for (int i = j + 1; i < nv; ++i) {
      float v = s.M[i * NVM + j];
      for (int k = 0; k < j; ++k) v -= s.L[i * NVM + k] * s.L[j * NVM + k];
      s.L[i * NVM + j] = v / dj;
    }
  }
}

// ---- velocity stage, passive, actuation, xfrc (qfrc_smooth) --------------
__device__ void smooth_force(const Tab& T, const Io& io, int e,
                             const float* qpos, const float* qvel,
                             State& s) {
  const int nb = T.h(NBODY), nv = T.h(NV), nu = T.h(NU), njnt = T.h(NJNT);
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
    for (int i = 0; i < 3; ++i) cacc[3 + i] = -con[26 + i];
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
    for (int d = 0; d < nv; ++d) passive[d] = passive[d] - df[2 * d] * qvel[d];
  }
  if (nu) {
    const float* af = T.f(F_ACT);
    const int* ai = T.i(I_ACT);
    for (int u = 0; u < nu; ++u) {
      const float* A = af + 6 * u;
      float c = io.ctrl[(size_t)e * nu + u];
      if ((flags & CLAMPCTRL) && ai[3 * u + 1]) c = fminf(fmaxf(c, A[2]), A[3]);
      float f = A[1] * c;
      if (ai[3 * u + 2]) f = fminf(fmaxf(f, A[4]), A[5]);
      if (!(flags & ACTUATION)) f = 0.f;
      actf[ai[3 * u]] += f * A[0];
    }
  }
  // xfrc projection (forward._xfrc_projection); zero wrenches add nothing
  float xf[NVM];
  for (int d = 0; d < nv; ++d) xf[d] = 0.f;
  for (int b = 1; b < nb; ++b) {
    const float* w = io.xfrc + ((size_t)e * nb + b) * 6;
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
    s.qfrc_smooth[d] = passive[d] - bias + actf[d] +
                       io.qfrc_applied[(size_t)e * nv + d] + xf[d];
  }
  // qacc_smooth = M^-1 qfrc_smooth with the factor (linalg.cho_solve)
  float y[NVM];
  for (int i = 0; i < nv; ++i) {
    float v = s.qfrc_smooth[i];
    for (int k = 0; k < i; ++k) v -= s.L[i * NVM + k] * y[k];
    y[i] = v / s.L[i * NVM + i];
  }
  for (int i = nv - 1; i >= 0; --i) {
    float v = y[i];
    for (int k = i + 1; k < nv; ++k) v -= s.L[k * NVM + i] * s.asm_[k];
    s.asm_[i] = v / s.L[i * NVM + i];
  }
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

// world pose of a pair's geom: qp = xpos + xmat gpos, R2 = xmat R(gquat)
__device__ void geom_pose(const State& s, int body, const float* G,
                          float* qp, float* R2) {
  const float* xm = s.xmat[body];
  for (int i = 0; i < 3; ++i)
    qp[i] = radd(s.xpos[body][i],
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

// plane-box: the 4 deepest of 8 corners (collision.plane_box)
__device__ void box_slots(const float* n, const float* pp, const float* qp,
                          const float* R, const float* size, int slot0,
                          int body, int gid, State& s) {
  float pts[8][3], h[8];
  int c = 0;
  for (int sx = -1; sx <= 1; sx += 2)
    for (int sy = -1; sy <= 1; sy += 2)
      for (int sz = -1; sz <= 1; sz += 2, ++c) {
        const float l[3] = {sx * size[0], sy * size[1], sz * size[2]};
        for (int i = 0; i < 3; ++i)
          pts[c][i] = radd(qp[i], rdot3(R[3 * i], R[3 * i + 1], R[3 * i + 2],
                                        l[0], l[1], l[2]));
        h[c] = rdot3(n[0], n[1], n[2], pts[c][0] - pp[0], pts[c][1] - pp[1],
                     pts[c][2] - pp[2]);
      }
  for (int r = 0; r < 4; ++r) {
    int best = 0;
    for (int i = 1; i < 8; ++i)
      if (h[i] < h[best]) best = i;
    const int o = slot0 + r;
    const float d = h[best];
    s.cdist[o] = d;
    for (int i = 0; i < 3; ++i)
      s.cpos[o][i] = rsub(pts[best][i], rmul(n[i], 0.5f * d));
    s.cbody[o] = body;
    s.cgid[o] = gid;
    h[best] = kBig;
  }
}

__device__ void collide(const Tab& T, State& s) {
  const float* con = T.f(F_CON);
  const float* n = con;
  const float* pp = con + 3;
  // plane-box group
  const int nbox = T.h(NBOX), kbox = T.h(KBOX), offbox = T.h(OFFBOX);
  if (nbox) {
    const float* bf = T.f(F_BOX);
    const int* bi = T.i(I_BOX);
    unsigned taken = 0u;
    for (int r = 0; r < kbox; ++r) {
      int p = r;  // k == P: pairs in order
      if (kbox < nbox) {  // top-k by the exact support distance
        float m = 0.f;
        p = -1;
        for (int q = 0; q < nbox; ++q) {
          const float* B = bf + 12 * q;
          float qp[3], R[9];
          geom_pose(s, bi[2 * q], B, qp, R);
          const float h = rdot3(n[0], n[1], n[2], qp[0] - pp[0],
                                qp[1] - pp[1], qp[2] - pp[2]);
          float supp = 0.f;
          for (int j = 0; j < 3; ++j)
            supp = radd(supp, rmul(fabsf(rdot3(n[0], n[1], n[2], R[j],
                                               R[3 + j], R[6 + j])),
                                   B[7 + j]));
          const float key = ((taken >> q) & 1u) ? kBig : h - supp - B[10];
          if (p < 0 || key < m) {
            m = key;
            p = q;
          }
        }
        taken |= 1u << p;
      }
      const float* B = bf + 12 * p;
      float qp[3], R[9];
      geom_pose(s, bi[2 * p], B, qp, R);
      box_slots(n, pp, qp, R, B + 7, offbox + 4 * r, bi[2 * p], bi[2 * p + 1],
                s);
    }
  }
  // plane-mesh group: support depth (or the conservative bound) per pair,
  // top-k by depth - margin, then the manifold of the selected pairs
  const int P = T.h(NMESH), kmesh = T.h(KMESH), offmesh = T.h(OFFMESH);
  if (!P) return;
  const float* mf = T.f(F_MESH);
  const int* mi = T.i(I_MESH);
  const float* vert = T.f(F_VERT);
  for (int p = 0; p < P; ++p) {
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
    s.d0[p] = d0;
    s.i0[p] = i0;
  }
  unsigned taken[PMAX / 32];
  for (int i = 0; i < PMAX / 32; ++i) taken[i] = 0u;
  for (int r = 0; r < kmesh; ++r) {
    float m = 0.f;
    int best = -1;
    for (int p = 0; p < P; ++p) {
      const bool used = (taken[p >> 5] >> (p & 31)) & 1u;
      const float key = used ? kBig : s.d0[p] - mf[16 * p + 7];
      if (best < 0 || key < m) {
        m = key;
        best = p;
      }
    }
    taken[best >> 5] |= 1u << (best & 31);
    const int o = offmesh + 3 * r;
    if (!(m < 0.f)) {  // inactive slot: pair 0's ids, the 1e10 depth
      for (int f = 0; f < 3; ++f) {
        s.cdist[o + f] = kBig;
        for (int i = 0; i < 3; ++i) s.cpos[o + f][i] = 0.f;
        s.cbody[o + f] = mi[0];
        s.cgid[o + f] = mi[1];
      }
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
    const int V = Gi[3], D = Gi[4], v0 = s.i0[best];
    const float* tb = vert + Gi[2];
    const float d0 = s.d0[best];
    float d[3] = {d0, kBig, kBig};
    float vs[9] = {tb[v0], tb[V + v0], tb[2 * V + v0], 0.f, 0.f, 0.f,
                   0.f, 0.f, 0.f};
    // the first two hull-graph neighbours of the support vertex below the
    // margin and outside the dedupe radius (plane_mesh.cu select_kernel)
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
        d[1 + cnt] = hc;
        vs[3 + 3 * cnt] = cx;
        vs[4 + 3 * cnt] = cy;
        vs[5 + 3 * cnt] = cz;
        ++cnt;
      }
    }
    // world slot positions w = qp + R v - n d / 2 (plane_mesh.cu topk)
    for (int f = 0; f < 3; ++f) {
      const float hf = 0.5f * d[f];
      for (int i = 0; i < 3; ++i) {
        const float w =
            radd(radd(radd(qp[i], rmul(R[3 * i], vs[3 * f])),
                      rmul(R[3 * i + 1], vs[3 * f + 1])),
                 rmul(R[3 * i + 2], vs[3 * f + 2]));
        s.cpos[o + f][i] = rsub(w, rmul(n[i], hf));
      }
      s.cdist[o + f] = d[f];
      s.cbody[o + f] = Gi[0];
      s.cgid[o + f] = Gi[1];
    }
  }
}

// ---- constraint rows ------------------------------------------------------
// Writes every row's act flag and, for active rows, J (env-last), aref, D,
// R and the friction-loss bounds (constraint.make_constraint's row order:
// equalities, friction loss, limits, the inert pad rows, then 4 pyramidal
// facets per contact slot).
__device__ void make_rows(const Tab& T, const Io& io, int e,
                          const float* qpos, const float* qvel,
                          const State& s) {
  const int nv = T.h(NV), ne = T.h(NE), nfl = T.h(NFL), nl = T.h(NL);
  const int npad = T.h(NPAD), ncon = T.h(NCON);
  const bool refsafe = T.h(FLAGS) & REFSAFE;
  const float* con = T.f(F_CON);
  const float dt = con[25];
  const size_t sE = (size_t)io.E;
  auto at = [&](int r) { return (size_t)r * sE + e; };
  auto jrow = [&](int r, int k) -> float& {
    return io.J[((size_t)r * nv + k) * sE + e];
  };
  auto finish = [&](int r, float k, float b, float imp, float pos, float vel,
                    float iw) {
    const float R = r_of(imp, iw);
    io.aref[at(r)] = -b * vel - k * imp * pos;
    io.R[at(r)] = R;
    io.D[at(r)] = 1.f / R;
    io.act[at(r)] = 1.f;
  };
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
      jrow(r, k) = (k == B[1] ? 1.f : 0.f) - (k == B[3] ? dpoly * m2 : 0.f);
    float vel = 0.f;
    for (int k = 0; k < nv; ++k) vel += jrow(r, k) * qvel[k];
    float kk, bb, imp;
    kbi(A + 5, A + 7, pos, dt, refsafe, kk, bb, imp);
    finish(r, kk, bb, imp, pos, vel, A[13]);
  }
  const float* ff = T.f(F_FL);
  const int* fi = T.i(I_FL);
  for (int q = 0; q < nfl; ++q, ++r) {
    const float* A = ff + 10 * q;
    for (int k = 0; k < nv; ++k) jrow(r, k) = k == fi[q] ? 1.f : 0.f;
    float kk, bb, imp;
    kbi(A, A + 2, 0.f, dt, refsafe, kk, bb, imp);
    finish(r, kk, bb, imp, 0.f, qvel[fi[q]], A[8]);
    io.fl[(size_t)q * sE + e] = A[7];
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
      io.act[at(r)] = 0.f;
      continue;
    }
    const int v = li[2 * q + 1];
    for (int k = 0; k < nv; ++k) jrow(r, k) = k == v ? sign : 0.f;
    const float pos = dist - A[2];
    float kk, bb, imp;
    kbi(A + 3, A + 5, pos, dt, refsafe, kk, bb, imp);
    finish(r, kk, bb, imp, pos, sign * qvel[v], A[10]);
  }
  for (int q = 0; q < npad; ++q, ++r) io.act[at(r)] = 0.f;
  const int* dmask = T.i(I_DMASK);
  const float* bf = T.f(F_BODY);
  const float* frame = con + 6;
  const float cmargin = con[15];
  const float mu0 = con[23];
  const float mus[2] = {con[23], con[24]};
  for (int c = 0; c < ncon; ++c, r += 4) {
    const float dist = s.cdist[c];
    if (!(dist < cmargin)) {
      for (int f = 0; f < 4; ++f) io.act[at(r + f)] = 0.f;
      continue;
    }
    const int cb = s.cbody[c];
    float off[3];
    for (int i = 0; i < 3; ++i) off[i] = s.cpos[c][i] - s.com[i];
    float ax[3][NVM];  // frame rows times the point Jacobian
    for (int v = 0; v < nv; ++v) {
      float jp[3] = {0.f, 0.f, 0.f};
      if (dmask[cb * nv + v]) {
        const float* u = s.cdof[v];
        jp[0] = (u[1] * off[2] - u[2] * off[1]) + u[3];
        jp[1] = (u[2] * off[0] - u[0] * off[2]) + u[4];
        jp[2] = (u[0] * off[1] - u[1] * off[0]) + u[5];
      }
      for (int t = 0; t < 3; ++t)
        ax[t][v] = frame[3 * t] * jp[0] + frame[3 * t + 1] * jp[1] +
                   frame[3 * t + 2] * jp[2];
    }
    const float pos = dist - cmargin;
    float kk, bb, imp;
    kbi(con + 16, con + 18, pos, dt, refsafe, kk, bb, imp);
    const float iw = bf[20 * cb + 18] * 2.f * mu0 * mu0 * (1.f + mu0 * mu0);
    for (int f = 0; f < 4; ++f) {
      const int t = 1 + f / 2;
      const float sm = (f & 1 ? -1.f : 1.f) * mus[t - 1];
      float vel = 0.f;
      for (int v = 0; v < nv; ++v) {
        const float jv = ax[0][v] + sm * ax[t][v];
        jrow(r + f, v) = jv;
        vel += jv * qvel[v];
      }
      finish(r + f, kk, bb, imp, pos, vel, iw);
    }
  }
}

// Outputs of one forward that the one-forward kernel writes (env-major);
// the megastep leaves these null.
struct Out {
  float *qacc_smooth, *qfrc, *cdist, *cforce;
  int *cgid;
};

// One forward of env e at (qpos, qvel) warm-started from ws; qacc out.
__device__ void forward_env(const Tab& T, const Io& io, const Out& out,
                            int e, const float* qpos, const float* qvel,
                            const float* ws, State& s, float* qacc,
                            int& iters, unsigned& taken) {
  const int nv = T.h(NV), nrows = T.h(NROWS), ncon = T.h(NCON);
  fk(T, qpos, s);
  com_pos(T, s);
  crb_factor(T, s);
  smooth_force(T, io, e, qpos, qvel, s);
  collide(T, s);
  make_rows(T, io, e, qpos, qvel, s);
  const size_t sE = (size_t)io.E;
  const lmt::Rows rows{io.aref, io.D, io.R, io.fl, io.act, sE, e,
                       T.h(NE), T.h(NFL)};
  auto Mat = [&](int a, int b) { return s.M[a * NVM + b]; };
  lmt::newton_solve<NVM>(io.J, rows, Mat, s.asm_, ws, qacc, io.jar, io.jv,
                         nv, nrows, io.iterations, io.ls_iterations,
                         io.scale, io.tol, iters, taken);
  if (!out.qfrc) return;
  float jr[NVM], qfrc[NVM];
  for (int k = 0; k < nv; ++k) qfrc[k] = 0.f;
  const int base = nrows - 4 * ncon;
  for (int r = 0; r < nrows; ++r) {
    const float f = lmt::row_force<NVM>(io.J, rows, qacc, jr, nv, r);
    if (f != 0.f)
      for (int k = 0; k < nv; ++k) qfrc[k] += jr[k] * f;
    if (r >= base) out.cforce[(size_t)e * 4 * ncon + (r - base)] = f;
  }
  for (int k = 0; k < nv; ++k) {
    out.qfrc[(size_t)e * nv + k] = qfrc[k];
    out.qacc_smooth[(size_t)e * nv + k] = s.asm_[k];
  }
  for (int c = 0; c < ncon; ++c) {
    out.cdist[(size_t)e * ncon + c] = s.cdist[c];
    out.cgid[(size_t)e * ncon + c] = s.cgid[c];
  }
}

__global__ void __launch_bounds__(32) mega_forward_kernel(
    Tab T, Io io, Out out, const float* __restrict__ qpos_in,
    const float* __restrict__ qvel_in, const float* __restrict__ ws_in,
    float* __restrict__ qacc_out, int* __restrict__ iters_out,
    int* __restrict__ taken_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= io.E) return;
  State s;
  const int nv = T.h(NV);
  float qpos[NVM], qvel[NVM], ws[NVM], qacc[NVM];
  for (int k = 0; k < nv; ++k) {
    qpos[k] = qpos_in[(size_t)e * nv + k];
    qvel[k] = qvel_in[(size_t)e * nv + k];
    ws[k] = ws_in[(size_t)e * nv + k];
  }
  int it;
  unsigned taken;
  forward_env(T, io, out, e, qpos, qvel, ws, s, qacc, it, taken);
  for (int k = 0; k < nv; ++k) qacc_out[(size_t)e * nv + k] = qacc[k];
  iters_out[e] = it;
  taken_out[e] = (int)taken;
}

// n RK4 substeps (mj_RungeKutta's tableau; forward.py _rk4), carrying
// qpos, qvel and the warm start. decisions (E, 4 n, 2): the iteration
// count and the taken bits of every forward, when not null.
__global__ void __launch_bounds__(32) megastep_kernel(
    Tab T, Io io, const float* __restrict__ qpos_in,
    const float* __restrict__ qvel_in, const float* __restrict__ ws_in,
    float* __restrict__ qpos_out, float* __restrict__ qvel_out,
    float* __restrict__ ws_out, int* __restrict__ decisions, int n_steps,
    float dt) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= io.E) return;
  State s;
  const Out none{nullptr, nullptr, nullptr, nullptr, nullptr};
  const int nv = T.h(NV);
  float qpos[NVM], qvel[NVM], ws[NVM];
  for (int k = 0; k < nv; ++k) {
    qpos[k] = qpos_in[(size_t)e * nv + k];
    qvel[k] = qvel_in[(size_t)e * nv + k];
    ws[k] = ws_in[(size_t)e * nv + k];
  }
  const float a[3] = {0.5f, 0.5f, 1.f};
  const float bw[4] = {1.f / 6, 1.f / 3, 1.f / 3, 1.f / 6};
  for (int step = 0; step < n_steps; ++step) {
    float qs[NVM], vs[NVM], aq[NVM], av[NVM], qacc[NVM];
    for (int k = 0; k < nv; ++k) {
      qs[k] = qpos[k];
      vs[k] = qvel[k];
    }
    for (int i = 0; i < 4; ++i) {
      int it;
      unsigned taken;
      // stage 1 warm-starts from the carried value, stages 2-4 from the
      // stage-1 qacc (mj_step copies it before mj_RungeKutta's stages)
      forward_env(T, io, none, e, qs, vs, ws, s, qacc, it, taken);
      if (decisions) {
        int* dd = decisions + ((size_t)e * 4 * n_steps + 4 * step + i) * 2;
        dd[0] = it;
        dd[1] = (int)taken;
      }
      for (int k = 0; k < nv; ++k) {
        aq[k] = i == 0 ? bw[0] * vs[k] : aq[k] + bw[i] * vs[k];
        av[k] = i == 0 ? bw[0] * qacc[k] : av[k] + bw[i] * qacc[k];
      }
      if (i == 0)
        for (int k = 0; k < nv; ++k) ws[k] = qacc[k];
      if (i < 3)
        for (int k = 0; k < nv; ++k) {
          qs[k] = qpos[k] + dt * a[i] * vs[k];
          vs[k] = qvel[k] + dt * a[i] * qacc[k];
        }
    }
    for (int k = 0; k < nv; ++k) {
      qpos[k] = qpos[k] + dt * aq[k];
      qvel[k] = qvel[k] + dt * av[k];
    }
  }
  for (int k = 0; k < nv; ++k) {
    qpos_out[(size_t)e * nv + k] = qpos[k];
    qvel_out[(size_t)e * nv + k] = qvel[k];
    ws_out[(size_t)e * nv + k] = ws[k];
  }
}

Io make_io(const void* ctrl, const void* qfrc_applied, const void* xfrc,
           void* J, void* aref, void* D, void* R, void* act, void* fl,
           void* jar, void* jv, int E, int iterations, int ls_iterations,
           float scale, float tol) {
  return Io{(const float*)ctrl, (const float*)qfrc_applied,
            (const float*)xfrc, (float*)J, (float*)aref, (float*)D,
            (float*)R, (float*)act, (float*)fl, (float*)jar, (float*)jv,
            E, iterations, ls_iterations, scale, tol};
}

constexpr int kBlock = 32;

}  // namespace

// ints/flts: the packed plan (ops/plan.py). Per-env inputs env-major:
// qpos (E, nq), qvel, ws (E, nv), ctrl (E, nu), qfrc_applied (E, nv),
// xfrc (E, nbody, 6). Outputs env-major: qacc, qacc_smooth, qfrc (E, nv),
// cdist (E, ncon), cgid (E, ncon) int, cforce (E, ncon, 4), iters and
// taken (E,) int. Scratch env-last: J (nrows, nv, E), aref, D, R, act,
// jar, jv (nrows, E), fl (max(nfl, 1), E).
extern "C" int lmt_mega_forward(
    const void* ints, const void* flts, const void* qpos, const void* qvel,
    const void* ctrl, const void* qfrc_applied, const void* xfrc,
    const void* ws, void* qacc, void* qacc_smooth, void* qfrc, void* cdist,
    void* cgid, void* cforce, void* iters, void* taken, void* J, void* aref,
    void* D, void* R, void* act, void* fl, void* jar, void* jv, int E,
    int iterations, int ls_iterations, float scale, float tol,
    void* stream) {
  if (E <= 0) return 0;
  const Tab T{(const int*)ints, (const float*)flts};
  const Io io = make_io(ctrl, qfrc_applied, xfrc, J, aref, D, R, act, fl,
                        jar, jv, E, iterations, ls_iterations, scale, tol);
  const Out out{(float*)qacc_smooth, (float*)qfrc, (float*)cdist,
                (float*)cforce, (int*)cgid};
  mega_forward_kernel<<<(E + kBlock - 1) / kBlock, kBlock, 0,
                        (cudaStream_t)stream>>>(
      T, io, out, (const float*)qpos, (const float*)qvel, (const float*)ws,
      (float*)qacc, (int*)iters, (int*)taken);
  return (int)cudaGetLastError();
}

// The same inputs and scratch; outputs qpos, qvel, ws (E, nv) after
// n_steps RK4 substeps of `dt`; decisions (E, 4 n_steps, 2) int or null.
extern "C" int lmt_megastep(
    const void* ints, const void* flts, const void* qpos, const void* qvel,
    const void* ctrl, const void* qfrc_applied, const void* xfrc,
    const void* ws, void* qpos_out, void* qvel_out, void* ws_out,
    void* decisions, void* J, void* aref, void* D, void* R, void* act,
    void* fl, void* jar, void* jv, int E, int n_steps, int iterations,
    int ls_iterations, float scale, float tol, float dt, void* stream) {
  if (E <= 0) return 0;
  const Tab T{(const int*)ints, (const float*)flts};
  const Io io = make_io(ctrl, qfrc_applied, xfrc, J, aref, D, R, act, fl,
                        jar, jv, E, iterations, ls_iterations, scale, tol);
  megastep_kernel<<<(E + kBlock - 1) / kBlock, kBlock, 0,
                    (cudaStream_t)stream>>>(
      T, io, (const float*)qpos, (const float*)qvel, (const float*)ws,
      (float*)qpos_out, (float*)qvel_out, (float*)ws_out, (int*)decisions,
      n_steps, dt);
  return (int)cudaGetLastError();
}
