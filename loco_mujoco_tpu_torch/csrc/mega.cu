// The mega path: a whole forward (FK, collision, smooth stage, constraint
// rows, Newton solve) as one kernel, and a whole control step (n substeps
// of RK4 or Euler) as one kernel. One thread owns one env.
//
// mega_forward_kernel replaces the Pallas program of
// loco_mujoco_tpu/ops/pallas_constraint.py: _mega_batched (its pallas_call)
// with its body _make_fused_kernel(mega=True) -> _forward_env_block, which
// inlines pallas_fk.fk_env_block, pallas_fk.collide_env_block (plane-box
// _box_slots and plane-mesh _mesh_group_slots with top-K), _smooth_preamble,
// the CRB mass matrix and qacc_smooth by Cholesky, the JOINT-equality /
// friction-loss / limit / pyramidal contact rows, solve_core and, for Euler
// models, the implicit-damping dv (euler_dv, :1893-1906).
// An elliptic plan with the extended collision (mega_ell: ELLIPTIC and
// NXGRP > 0) runs collide_ext instead, the counterpart of
// pallas_fk.collide_env_block_ext (:1714-2039): every classic analytic
// pair kind, self pairs included, into generic contact slots (frame, both
// geoms and bodies, the group's statics), then dim elliptic rows per slot
// and the Newton solve's cone zones.
// A plan with muscles (flag MUSCLE) adds the tendon and muscle stage
// (muscle_block; pallas_fk.muscle_env_block :1140-1350, inlined at
// pallas_constraint.py:1245-1264) after the smooth stage: qfrc_smooth gains
// the muscles' joint forces and the kernel writes act_dot (E, na) in act
// slot order.
// megastep_kernel replaces _megastep_batched (its pallas_call) with its
// body _make_megastep_kernel: the same forward looped over n substeps,
// carrying qpos, qvel and the warm start. RK4 runs the four stages of each
// substep (stage 1 warm-starts from the carried value; its qacc warm-starts
// stages 2-4 and the next substep, pallas_constraint.py:2731-2755); Euler
// (:2761-2787) runs one forward, qvel += dt dv with dv = euler_dv (or qacc
// when EULERDAMP is disabled), qpos += dt qvel, act += dt act_dot clamped
// to each act slot's range (the clamped value feeds the next forward), and
// carries that qacc as the warm start. RK4 with activations is no megastep
// path (the wrapper refuses it, as the reference does).
//
// The arithmetic follows the port's staged path, which is these kernels'
// plain version (ops/hopper_mega.py): kinematics.py and collision.py with
// the plane-mesh select and top-K of plane_mesh.cu here, then the fused
// constraint stage: the smooth stage, rows (contact facets blocked, as in
// fused.cu and the reference) and Euler damping of forward_core.cuh with
// the Newton solve of newton_core.cuh (the one Newton code, shared with
// newton.cu). Differences from the Pallas kernel, none of which
// changes a result beyond summation order: each thread decides its own
// conservative skip of the plane-mesh vertex walk (the TPU block decided
// for 1,024 envs at once), computes the neighbour manifold only for the
// pairs the top-K selects, and skips its own inactive constraint rows in
// every solve pass, so the reference's fast/full branch pair (mega_fast)
// has no counterpart here.
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
// Rounding: the collision functions (geom_pose, box_slots, collide and the
// extended collision's) write each product and each sum with
// __fmul_rn / __fadd_rn / __fsub_rn, which
// nvcc never fuses into a multiply-add, so they round as the plain
// versions' separate operations do and the active contact sets match. The
// rest of the file is compiled with contraction on, as newton.cu is.

#include <cuda_runtime.h>
#include <math.h>

#include "forward_core.cuh"

namespace {

using namespace lmt;

constexpr int CMAX = 80;  // contact slots (ops/plan.py CON_MAX)
constexpr int PMAX = 128; // plane-mesh pairs (PAIR_MAX)
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

// ---- per-thread state: the smooth stage's, FK frames, contact slots -------
struct State : Body {
  float xpos[BMAX][3], xquat[BMAX][4], xmat[BMAX][9];
  float cpos[CMAX][3], cdist[CMAX];
  int cbody[CMAX], cgid[CMAX];
  // the extended collision's generic slots: frame, geom 1 and its body,
  // group and invweight (collide_ext)
  float cframe[CMAX][9], ciw[CMAX];
  int cgid1[CMAX], cbody1[CMAX], cgrp[CMAX];
  float d0[PMAX];  // support depth, or the conservative bound
  int i0[PMAX];    // support vertex
};

// Env-major per-env inputs held constant over a control step.
struct In {
  const float* ctrl;
  const float* qfrc_applied;
  const float* xfrc;
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
  SPHERE_CAPSULE, SPHERE_BOX, CAPSULE_CAPSULE
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

// The slots of one selected pair into s, from slot o on.
__device__ void ext_slots(int kind, const float* pp, const float* R1,
                          const float* qp, const float* R2, const float* s1,
                          const float* s2, int o, State& s) {
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
        float c[3], d[3];
        const float off = kind == PLANE_SPHERE ? 0.f
                                               : rmul(q ? -1.f : 1.f, s2[1]);
        for (int i = 0; i < 3; ++i)
          c[i] = kind == PLANE_SPHERE ? qp[i] : radd(qp[i], rmul(off, axis[i]));
        rsub3(c, pp, d);
        const float dist = rsub(rdot(n, d), s2[0]);
        const float depth = radd(s2[0], rmul(0.5f, dist));
        s.cdist[o + q] = dist;
        for (int i = 0; i < 3; ++i)
          s.cpos[o + q][i] = rsub(c[i], rmul(n[i], depth));
        for (int i = 0; i < 9; ++i) s.cframe[o + q][i] = fr[i];
      }
      return;
    }
    if (kind == PLANE_CYLINDER) {
      const float r = s2[0], hl = s2[1];
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
        for (int i = 0; i < 3; ++i) d[i] = R2[3 * i];
      }
      rcross(axis, d, e);
      const float le = fmaxf(rnorm(e), 1e-15f);
      for (int i = 0; i < 3; ++i) e[i] = e[i] / le;
      const float c120 = -0.5f, s120 = 0.8660254037844386f;
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
        const float h = rdot(n, h3);
        s.cdist[o + q] = h;
        for (int i = 0; i < 3; ++i)
          s.cpos[o + q][i] = rsub(p[i], rmul(n[i], rmul(0.5f, h)));
        for (int i = 0; i < 9; ++i) s.cframe[o + q][i] = fr[i];
      }
      return;
    }
    // plane-box: the four deepest corners (collision.plane_box)
    box_slots(n, pp, qp, R2, s2, o, 0, 0, s);
    for (int q = 0; q < 4; ++q)
      for (int i = 0; i < 9; ++i) s.cframe[o + q][i] = fr[i];
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
    s.cdist[o + 1] = kBig;
    for (int i = 0; i < 3; ++i) s.cpos[o + 1][i] = 0.f;
    for (int i = 0; i < 9; ++i) s.cframe[o + 1][i] = fr[i];
  }
  s.cdist[o] = dist;
  for (int i = 0; i < 3; ++i) s.cpos[o][i] = pos[i];
  for (int i = 0; i < 9; ++i) s.cframe[o][i] = fr[i];
}

__device__ void collide_ext(const Tab& T, State& s) {
  const int ng = T.h(NXGRP);
  const int* gi = T.i(I_XGRP);
  const int* pi = T.i(I_XPAIR);
  const float* pf = T.f(F_XPAIR);
  const float* gf = T.f(F_XGRP);
  for (int g = 0; g < ng; ++g) {
    const int* G = gi + 8 * g;
    const int kind = G[0], k = G[1], slots = G[2], P = G[3], off = G[4],
              first = G[5];
    const float margin = gf[16 * g];
    unsigned taken = 0u;
    for (int rk = 0; rk < k; ++rk) {
      int p = rk;  // k == P: pairs in order
      if (k < P) {
        float m = 0.f;
        p = -1;
        for (int q = 0; q < P; ++q) {
          const int* I = pi + 4 * (first + q);
          const float* F = pf + 24 * (first + q);
          float p1[3], R1[9], p2[3], R2[9];
          geom_pose(s, I[1], F, p1, R1);
          geom_pose(s, I[3], F + 11, p2, R2);
          const float key =
              ((taken >> q) & 1u)
                  ? kBig
                  : ext_key(kind, p1, R1, p2, R2, F + 7, F + 18, F[10],
                            F[21], margin);
          if (p < 0 || key < m) {
            m = key;
            p = q;
          }
        }
        taken |= 1u << p;
      }
      const int* I = pi + 4 * (first + p);
      const float* F = pf + 24 * (first + p);
      float p1[3], R1[9], p2[3], R2[9];
      geom_pose(s, I[1], F, p1, R1);
      geom_pose(s, I[3], F + 11, p2, R2);
      const int o = off + slots * rk;
      ext_slots(kind, p1, R1, p2, R2, F + 7, F + 18, o, s);
      for (int q = 0; q < slots; ++q) {
        s.cgid1[o + q] = I[0];
        s.cbody1[o + q] = I[1];
        s.cgid[o + q] = I[2];
        s.cbody[o + q] = I[3];
        s.cgrp[o + q] = g;
        s.ciw[o + q] = F[22];
      }
    }
  }
}

// ---- tendons and muscles ---------------------------------------------------
// One segment of a tendon path: from site A (on body ba) to site B (on bb),
// the sites computed from the body frames; u the unit direction and cA, cB
// the com-referenced endpoint offsets crossed with u, so that
// u . (J_B - J_A) qvel = cB . w_B + u . v_B - (cA . w_A + u . v_A) with
// (w, v) a body's cvel (tendon.py's segment Jacobian).
struct Seg {
  float len, u[3], cA[3], cB[3];
  int ba, bb;
};

__device__ void segment(const Tab& T, const State& s, const int* sg,
                        Seg& g) {
  const float* sf = T.f(F_SITE);
  const int* si = T.i(I_SITE);
  float p[2][3];
  const int b2[2] = {si[sg[0]], si[sg[1]]};
  for (int e = 0; e < 2; ++e) {
    const float* l = sf + 4 * sg[e];
    const float* R = s.xmat[b2[e]];
    for (int i = 0; i < 3; ++i)
      p[e][i] = s.xpos[b2[e]][i] + (R[3 * i] * l[0] + R[3 * i + 1] * l[1] +
                                    R[3 * i + 2] * l[2]);
  }
  float d[3], offA[3], offB[3];
  for (int i = 0; i < 3; ++i) {
    d[i] = p[1][i] - p[0][i];
    offA[i] = p[0][i] - s.com[i];
    offB[i] = p[1][i] - s.com[i];
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
// flimited]) its tendon's length and velocity from its segments (pass 1),
// the FLV force (mju_muscleGain / Bias) on act, act_dot (mju_muscleDynamics,
// tausmooth 0) into act_dot[act_slot]; then (pass 2) the segments again, each
// adding gear force through its endpoint bodies into per-body wrenches,
// projected on every dof of their chains (I_DMASK). Needs s.cvel
// (smooth_force) and adds to s.qfrc_smooth. act (na) and ctrl (nu) are this
// env's; act_dot (na) out.
__device__ void muscle_block(const Tab& T, State& s, const float* ctrl,
                             const float* act, float* act_dot) {
  const int nmus = T.h(NMUS), na = T.h(NA), nv = T.h(NV), nb = T.h(NBODY);
  const int flags = T.h(FLAGS);
  const float* mf = T.f(F_MUS);
  const int* mi = T.i(I_MUS);
  const int* sg = T.i(I_SEG);
  const int* dmask = T.i(I_DMASK);
  for (int a = 0; a < na; ++a) act_dot[a] = 0.f;
  float gf[MUSM];  // gear * force of each muscle
  Seg g;
  for (int i = 0; i < nmus; ++i) {
    const float* P = mf + 28 * i;
    const int* Q = mi + 6 * i;
    float len = 0.f, vel = 0.f;
    for (int k = Q[0]; k < Q[0] + Q[1]; ++k) {
      segment(T, s, sg + 2 * k, g);
      len += g.len;
      vel += (dot3(g.cB, s.cvel[g.bb]) + dot3(g.u, s.cvel[g.bb] + 3)) -
             (dot3(g.cA, s.cvel[g.ba]) + dot3(g.u, s.cvel[g.ba] + 3));
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
  float W[BMAX][6];
  for (int b = 0; b < nb; ++b)
    for (int k = 0; k < 6; ++k) W[b][k] = 0.f;
  for (int i = 0; i < nmus; ++i) {
    const int* Q = mi + 6 * i;
    for (int k = Q[0]; k < Q[0] + Q[1]; ++k) {
      segment(T, s, sg + 2 * k, g);
      for (int j = 0; j < 3; ++j) {
        W[g.bb][j] += gf[i] * g.cB[j];
        W[g.bb][3 + j] += gf[i] * g.u[j];
        W[g.ba][j] -= gf[i] * g.cA[j];
        W[g.ba][3 + j] -= gf[i] * g.u[j];
      }
    }
  }
  for (int v = 0; v < nv; ++v) {
    float q = 0.f;
    for (int b = 1; b < nb; ++b)
      if (dmask[b * nv + v])
        q += dot3(s.cdof[v], W[b]) + dot3(s.cdof[v] + 3, W[b] + 3);
    s.qfrc_smooth[v] += q;
  }
}

// ---- constraint rows ------------------------------------------------------
// The fused kernel's row order: equalities, friction loss, limits, the inert
// pad rows, then the 4 pyramidal facets of every slot, blocked (facet f of
// slot c at row base + f ncon + c).
template <bool EXT>
__device__ void make_rows(const Tab& T, const Io& io, int e,
                          const float* qpos, const float* qvel,
                          const State& s) {
  const RowWriter w{io, e, T.h(NV)};
  const int base = joint_rows(T, w, qpos, qvel);
  const int ncon = T.h(NCON);
  const float* con = T.f(F_CON);
  const float* bf = T.f(F_BODY);
  if constexpr (EXT) {  // the extended collision's slots, elliptic rows
    const int* cinfo = T.i(I_CON);  // per slot: dim, first row
    const float* gf = T.f(F_XGRP);
    int ci = 0;  // elliptic contact index
    for (int c = 0; c < ncon; ++c) {
      const int dim = cinfo[2 * c], r0 = cinfo[2 * c + 1];
      const float* G = gf + 16 * s.cgrp[c];
      float* mu = dim >= 3 ? io.mu + (size_t)(ci++) * io.E + e : nullptr;
      if (!(s.cdist[c] < G[1])) {
        for (int t = 0; t < dim; ++t) w.off(r0 + t);
        continue;
      }
      ell_contact_rows(T, w, r0, dim, s, s.cpos[c], s.cframe[c],
                       s.cbody1[c], s.cbody[c], s.cdist[c] - G[1], G + 2,
                       G + 4, s.ciw[c], G + 9, qvel, mu);
    }
    return;
  }
  for (int c = 0; c < ncon; ++c) {
    const float dist = s.cdist[c];
    if (!(dist < con[kConMargin])) {
      for (int f = 0; f < 4; ++f) w.off(base + f * ncon + c);
      continue;
    }
    const int cb = s.cbody[c];
    contact_rows(T, w, base, c, s, s.cpos[c], con + kConFrame, -1, cb,
                 dist - con[kConMargin], con + kConSolref, con + kConSolimp,
                 bf[20 * cb + 18], con[kConFric], con[kConFric + 1], qvel);
  }
}

// Outputs of one forward that the one-forward kernel writes (env-major);
// the megastep leaves these null.
struct Out {
  float *qacc_smooth, *qfrc, *cdist, *cforce, *dv;
  int *cgid, *cgid1;
};

// One forward of env e at (qpos, qvel, act) warm-started from ws; qacc and
// act_dot (na, with muscles) out. EXT: the extended collision and elliptic
// rows of a mega_ell plan (a separate instance, so that the plane-only
// kernels carry none of its code or registers).
template <bool EXT>
__device__ void forward_env(const Tab& T, const Io& io, const In& in,
                            const Out& out, int e, const float* qpos,
                            const float* qvel, const float* act,
                            const float* ws, State& s, float* qacc,
                            float* act_dot, int& iters, unsigned& taken,
                            unsigned* ls_bits) {
  const int nv = T.h(NV), nrows = T.h(NROWS), ncon = T.h(NCON);
  const float* ctrl = in.ctrl + (size_t)e * T.h(NU);
  fk(T, qpos, s);
  com_pos(T, s);
  crb_factor(T, s, nullptr);
  smooth_force(T, ctrl, in.qfrc_applied + (size_t)e * nv,
               in.xfrc + (size_t)e * T.h(NBODY) * 6, qpos, qvel, s);
  if (T.h(FLAGS) & MUSCLE) muscle_block(T, s, ctrl, act, act_dot);
  smooth_acc(T, s);
  if constexpr (EXT)
    collide_ext(T, s);
  else
    collide(T, s);
  make_rows<EXT>(T, io, e, qpos, qvel, s);
  // the contact rows, in the plan's layout (blocked facets or slot-major
  // elliptic rows), after the joint and pad rows
  const int base = T.h(NE) + T.h(NFL) + T.h(NL) + T.h(NPAD);
  const int crows = nrows - base;
  float qfrc[NVM];
  solve_rows(T, io, e, s, ws, qacc, out.qfrc ? qfrc : nullptr, iters, taken,
             ls_bits, [&](int r, float f) {
               if (r >= base) out.cforce[(size_t)e * crows + r - base] = f;
             });
  if (!out.qfrc) return;
  for (int k = 0; k < nv; ++k) {
    out.qfrc[(size_t)e * nv + k] = qfrc[k];
    out.qacc_smooth[(size_t)e * nv + k] = s.asm_[k];
  }
  for (int c = 0; c < ncon; ++c) {
    out.cdist[(size_t)e * ncon + c] = s.cdist[c];
    out.cgid[(size_t)e * ncon + c] = s.cgid[c];
    if constexpr (EXT) out.cgid1[(size_t)e * ncon + c] = s.cgid1[c];
  }
  if (out.dv) {
    float dv[NVM];
    euler_dv(T, s, qacc, dv);
    for (int k = 0; k < nv; ++k) out.dv[(size_t)e * nv + k] = dv[k];
  }
}

template <bool EXT>
__global__ void __launch_bounds__(32) mega_forward_kernel(
    Tab T, Io io, In in, Out out, const float* __restrict__ qpos_in,
    const float* __restrict__ qvel_in, const float* __restrict__ act_in,
    const float* __restrict__ ws_in, float* __restrict__ qacc_out,
    float* __restrict__ act_dot_out, int* __restrict__ iters_out,
    int* __restrict__ taken_out, int* __restrict__ ls_out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= io.E) return;
  State s;
  const int nv = T.h(NV), na = T.h(NA);
  float qpos[NVM], qvel[NVM], ws[NVM], qacc[NVM], act[MUSM], act_dot[MUSM];
  for (int k = 0; k < nv; ++k) {
    qpos[k] = qpos_in[(size_t)e * nv + k];
    qvel[k] = qvel_in[(size_t)e * nv + k];
    ws[k] = ws_in[(size_t)e * nv + k];
  }
  for (int a = 0; a < na; ++a) act[a] = act_in[(size_t)e * na + a];
  int it;
  unsigned taken, ls[kLsWords];
  forward_env<EXT>(T, io, in, out, e, qpos, qvel, act, ws, s, qacc, act_dot,
                   it,
              taken, ls);
  for (int w = 0; w < kLsWords; ++w)
    ls_out[(size_t)e * kLsWords + w] = (int)ls[w];
  for (int k = 0; k < nv; ++k) qacc_out[(size_t)e * nv + k] = qacc[k];
  if (T.h(FLAGS) & MUSCLE)
    for (int a = 0; a < na; ++a) act_dot_out[(size_t)e * na + a] = act_dot[a];
  iters_out[e] = it;
  taken_out[e] = (int)taken;
}

// n substeps of RK4 (mj_RungeKutta's tableau; forward.py _rk4) or Euler
// (forward.py _euler; use_dv: qvel moves by euler_dv, else by qacc),
// carrying qpos, qvel, the activations (Euler) and the warm start.
// decisions (E, F n, 2 + kLsWords), F = 4 for RK4 and 1 for Euler: the
// iteration count, the taken bits and the line search's decision bits of
// every forward, when not null.
template <bool EXT>
__global__ void __launch_bounds__(32) megastep_kernel(
    Tab T, Io io, In in, const float* __restrict__ qpos_in,
    const float* __restrict__ qvel_in, const float* __restrict__ act_in,
    const float* __restrict__ ws_in, float* __restrict__ qpos_out,
    float* __restrict__ qvel_out, float* __restrict__ act_out,
    float* __restrict__ ws_out, int* __restrict__ decisions, int n_steps,
    float dt, int rk4, int use_dv) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= io.E) return;
  State s;
  const Out none{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                 nullptr};
  const int nv = T.h(NV), na = T.h(NA);
  const float* act_lim = T.f(F_ACTB);  // (lo, hi) per act slot
  const int per = rk4 ? 4 : 1;  // forwards per substep
  float qpos[NVM], qvel[NVM], ws[NVM], act[MUSM], act_dot[MUSM];
  for (int k = 0; k < nv; ++k) {
    qpos[k] = qpos_in[(size_t)e * nv + k];
    qvel[k] = qvel_in[(size_t)e * nv + k];
    ws[k] = ws_in[(size_t)e * nv + k];
  }
  for (int a = 0; a < na; ++a) act[a] = act_in[(size_t)e * na + a];
  unsigned ls[kLsWords];
  unsigned* lsp = decisions ? ls : nullptr;
  auto record = [&](int f, int it, unsigned taken) {
    if (!decisions) return;
    int* dd = decisions + ((size_t)e * per * n_steps + f) * (2 + kLsWords);
    dd[0] = it;
    dd[1] = (int)taken;
    for (int w = 0; w < kLsWords; ++w) dd[2 + w] = (int)ls[w];
  };
  const float a[3] = {0.5f, 0.5f, 1.f};
  const float bw[4] = {1.f / 6, 1.f / 3, 1.f / 3, 1.f / 6};
  for (int step = 0; step < n_steps; ++step) {
    float qacc[NVM];
    int it;
    unsigned taken;
    if (!rk4) {
      forward_env<EXT>(T, io, in, none, e, qpos, qvel, act, ws, s, qacc,
                       act_dot,
                  it, taken, lsp);
      record(step, it, taken);
      float dv[NVM];
      if (use_dv)
        euler_dv(T, s, qacc, dv);
      else
        for (int k = 0; k < nv; ++k) dv[k] = qacc[k];
      for (int k = 0; k < nv; ++k) {
        qvel[k] = qvel[k] + dt * dv[k];
        qpos[k] = qpos[k] + dt * qvel[k];
        ws[k] = qacc[k];
      }
      if (T.h(FLAGS) & MUSCLE)
        for (int a = 0; a < na; ++a)
          act[a] = fminf(fmaxf(act[a] + dt * act_dot[a], act_lim[2 * a]),
                         act_lim[2 * a + 1]);
      continue;
    }
    float qs[NVM], vs[NVM], aq[NVM], av[NVM];
    for (int k = 0; k < nv; ++k) {
      qs[k] = qpos[k];
      vs[k] = qvel[k];
    }
    for (int i = 0; i < 4; ++i) {
      // stage 1 warm-starts from the carried value, stages 2-4 from the
      // stage-1 qacc (mj_step copies it before mj_RungeKutta's stages)
      forward_env<EXT>(T, io, in, none, e, qs, vs, act, ws, s, qacc, act_dot,
                       it,
                  taken, lsp);
      record(4 * step + i, it, taken);
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
  for (int a = 0; a < na; ++a) act_out[(size_t)e * na + a] = act[a];
}

Io make_io(void* J, void* aref, void* D, void* R, void* act, void* fl,
           void* jar, void* jv, void* mu, int E, int iterations,
           int ls_iterations, float scale, float tol) {
  return Io{(float*)J,   (float*)aref, (float*)D,  (float*)R,
            (float*)act, (float*)fl,   (float*)jar, (float*)jv,
            (float*)mu,  E,            iterations, ls_iterations,
            scale,       tol};
}

constexpr int kBlock = 32;

}  // namespace

// ints/flts: the packed plan (ops/plan.py). Per-env inputs env-major:
// qpos (E, nq), qvel, ws (E, nv), act_in (E, na), ctrl (E, nu), qfrc_applied
// (E, nv), xfrc (E, nbody, 6). Outputs env-major: qacc, qacc_smooth, qfrc
// (E, nv), cdist (E, ncon), cgid and cgid1 (E, ncon) int (geom 2 and, from
// the extended collision, geom 1), cforce (E, nrows - first contact row) in
// the plan's row layout, iters and taken (E,) int, ls (E, 4) int (the line
// search's decisions), dv (E, nv) or null (no
// euler_dv), act_dot (E, na) (written with muscles). Scratch env-last: J
// (nrows, nv, E), aref, D, R, act, jar, jv (nrows, E), fl (max(nfl, 1), E),
// mu (max(ncon_ell, 1), E). ext: the plan is mega_ell (the extended
// collision and elliptic rows).
extern "C" int lmt_mega_forward(
    const void* ints, const void* flts, const void* qpos, const void* qvel,
    const void* act_in, const void* ctrl, const void* qfrc_applied,
    const void* xfrc, const void* ws, void* qacc, void* qacc_smooth,
    void* qfrc, void* cdist, void* cgid, void* cgid1, void* cforce,
    void* iters, void* taken, void* ls, void* dv, void* act_dot, void* J,
    void* aref,
    void* D, void* R, void* act, void* fl, void* jar, void* jv, void* mu,
    int E, int iterations, int ls_iterations, int ext, float scale,
    float tol, void* stream) {
  if (E <= 0) return 0;
  const Tab T{(const int*)ints, (const float*)flts};
  const Io io = make_io(J, aref, D, R, act, fl, jar, jv, mu, E, iterations,
                        ls_iterations, scale, tol);
  const In in{(const float*)ctrl, (const float*)qfrc_applied,
              (const float*)xfrc};
  const Out out{(float*)qacc_smooth, (float*)qfrc, (float*)cdist,
                (float*)cforce, (float*)dv, (int*)cgid, (int*)cgid1};
  auto go = [&](auto kernel) {
    kernel<<<(E + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
        T, io, in, out, (const float*)qpos, (const float*)qvel,
        (const float*)act_in, (const float*)ws, (float*)qacc,
        (float*)act_dot, (int*)iters, (int*)taken, (int*)ls);
  };
  if (ext)
    go(mega_forward_kernel<true>);
  else
    go(mega_forward_kernel<false>);
  return (int)cudaGetLastError();
}

// The same inputs and scratch; outputs qpos, qvel, ws (E, nv) and act_out
// (E, na) after n_steps substeps of `dt` (rk4: RK4, else Euler with
// use_dv); decisions (E, F n_steps, 6) int or null.
extern "C" int lmt_megastep(
    const void* ints, const void* flts, const void* qpos, const void* qvel,
    const void* act_in, const void* ctrl, const void* qfrc_applied,
    const void* xfrc, const void* ws, void* qpos_out, void* qvel_out,
    void* act_out, void* ws_out, void* decisions, void* J, void* aref,
    void* D, void* R, void* act, void* fl, void* jar, void* jv, void* mu,
    int E, int n_steps, int iterations, int ls_iterations, int rk4,
    int use_dv, int ext, float scale, float tol, float dt, void* stream) {
  if (E <= 0) return 0;
  const Tab T{(const int*)ints, (const float*)flts};
  const Io io = make_io(J, aref, D, R, act, fl, jar, jv, mu, E, iterations,
                        ls_iterations, scale, tol);
  const In in{(const float*)ctrl, (const float*)qfrc_applied,
              (const float*)xfrc};
  auto go = [&](auto kernel) {
    kernel<<<(E + kBlock - 1) / kBlock, kBlock, 0, (cudaStream_t)stream>>>(
        T, io, in, (const float*)qpos, (const float*)qvel,
        (const float*)act_in, (const float*)ws, (float*)qpos_out,
        (float*)qvel_out, (float*)act_out, (float*)ws_out, (int*)decisions,
        n_steps, dt, rk4, use_dv);
  };
  if (ext)
    go(megastep_kernel<true>);
  else
    go(megastep_kernel<false>);
  return (int)cudaGetLastError();
}
