// The fused constraint kernel: the smooth stage from FK outputs, the
// constraint rows, the Newton solve and Euler's implicit damping of one
// forward, one thread per env.
//
// fused_kernel replaces the Pallas program of
// loco_mujoco_tpu/ops/pallas_constraint.py: _fused_batched (its
// pallas_call) with its body _make_fused_kernel(mega=False) ->
// _forward_env_block in its two vec layouts. Smooth (:1268-1281, plan flag
// SMOOTH): from the packed per-env vector of FK outputs it computes com,
// cinert, cdof, the RNE bias, passive forces and motor actuation
// (qfrc_smooth, _smooth_preamble :950-1180). Non-smooth (:1282-1299, the
// muscle humanoid's staged path): the vector carries cdof, the root
// subtree com, cinert, qfrc_smooth (the staged tendon, velocity, passive
// and actuation stages computed them) and the armature. Then, in both, the
// CRB mass matrix and qacc_smooth = M^-1 qfrc_smooth (:1301-1346), the
// JOINT-equality / friction-loss / limit rows and the pyramidal contact
// rows of the slots the staged collision filled (:1447-1590), the Newton
// solve (newton_core.cuh), the force of every row and qfrc = J'f
// (:1864-1890), and euler_dv = (M + h diag(damping))^-1 M qacc
// (:1893-1906). A plan with DAMP_ROWS (per-env joint damping, the
// reference's sm_dyn_damping, :529-537, with its rows at :1270) carries
// each env's damping after the warm start in the smooth vector, and the
// passive force reads it there. The device functions are forward_core.cuh's (csrc/mega.cu
// has warp-per-env counterparts of them); the arithmetic follows the
// port's staged path, the
// kernel's plain version (ops/hopper_fused.py fused_constraint_plain).
//
// Contact pack (ops/plan.py pack_w, per slot):
//   uniform statics (5): pos (3), dist, geom2 -- the frame, margin, solref,
//     solimp and friction are the plan's, the body comes from geom2
//     through the plan's geom -> body table; (7) adds the pair's two
//     sliding frictions;
//   generic (24 + nfric): pos (3), frame (9, rows n t1 t2), dist,
//     includemargin, friction (nfric: 2 pyramidal, 5 elliptic), solref
//     (2), solimp (5), invweight of both bodies, body 1, body 2 -- the
//     point Jacobian's chain mask is body 2's minus body 1's (_kbi_dyn's
//     per-slot parameters). Elliptic plans (flag ELLIPTIC, A1) always take
//     it (29 floats).
//
// Row layout (the reference's): JOINT equalities, friction loss, limits,
// npad inert rows, then the contact rows: pyramidal facets BLOCKED, facet f
// (+mu1 t1, -mu1 t1, +mu2 t2, -mu2 t2) of slot c at row s0 + f ncon + c;
// elliptic cones slot-major, dim rows per slot from the plan's I_CON
// table (forward_core.cuh ell_contact_rows), with the cone zones of
// newton_core.cuh over the plan's elliptic runs. The kernel writes every
// row's force in that layout; the wrapper remaps them to
// efc_force_contact's per-slot order.
//
// Layout: the vector, the pack and the outputs are env-major (E, k) (each
// thread reads and writes its own k contiguous values), so no relayout
// kernel runs around this kernel, unlike the TPU's lanes layout and its
// grouped blocking (use_grouped, pick_s), which have no counterpart here.
// The rows go to global scratch, env-last ((nrows, nv, E) for J), so the
// solve's row passes coalesce, as in newton.cu.
//
// Bound: operations, not bytes. An env reads ~1 KB (vector and pack) and
// writes ~0.7 KB but does ~10^4-10^5 float operations (CRB and Cholesky,
// the smooth stage, the rows, the Newton iterations over its active rows).
// One thread per env gives E / 32 warps (128 at 4096 envs for 132 SMs),
// and the per-thread state lives in local memory: latency, not issue
// rate, limits this first version (the mega kernels now run a warp per
// env with the state in shared memory; this kernel is next).

#include <cuda_runtime.h>
#include <math.h>

#include "forward_core.cuh"

namespace {

using namespace lmt;

// Env-major operands and outputs of the fused kernel.
struct Fused {
  const float* vec;   // (E, nvec) smooth: [qpos qvel xipos ximat xanchor
                      // xaxis ctrl qfrc_applied xfrc ws], then the env's
                      // damping (nv) under DAMP_ROWS; non-smooth: [qpos
                      // qvel cdof com cinert qfrc_smooth ws armature]
  const float* pack;  // (E, ncon, pack_w)
  float *qacc, *force, *qfrc, *qacc_smooth, *dv;  // dv null: no euler_dv
  int *iters, *taken, *ls;  // ls: (E, kLsWords) line-search decisions
  int* rows;  // (E, iterations, (nrows + 31) / 32) the rows' decisions
  int nvec;
};

// DAMP: the plan's per-env damping rows (DAMP_ROWS), an instance of its
// own, so that the kernel without them is unchanged.
template <bool DAMP>
__global__ void __launch_bounds__(32) fused_kernel(Tab T, Io io, Fused F) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= io.E) return;
  const int nv = T.h(NV), nb = T.h(NBODY), njnt = T.h(NJNT), nu = T.h(NU);
  const int nrows = T.h(NROWS), ncon = T.h(NCON), W = T.h(PACKW);
  const int flags = T.h(FLAGS);
  Body s;
  float qpos[NVM], qvel[NVM], ws[NVM], qacc[NVM], qfrc[NVM];
  const float* v = F.vec + (size_t)e * F.nvec;
  for (int k = 0; k < nv; ++k) {
    qpos[k] = v[k];
    qvel[k] = v[nv + k];
  }
  v += 2 * nv;
  if (flags & SMOOTH) {
    for (int b = 0; b < nb; ++b)
      for (int k = 0; k < 3; ++k) s.xipos[b][k] = v[3 * b + k];
    v += 3 * nb;
    for (int b = 0; b < nb; ++b)
      for (int k = 0; k < 9; ++k) s.ximat[b][k] = v[9 * b + k];
    v += 9 * nb;
    for (int j = 0; j < njnt; ++j)
      for (int k = 0; k < 3; ++k) s.xanchor[j][k] = v[3 * j + k];
    v += 3 * njnt;
    for (int j = 0; j < njnt; ++j)
      for (int k = 0; k < 3; ++k) s.xaxis[j][k] = v[3 * j + k];
    v += 3 * njnt;
    const float* ctrl = v;
    const float* app = ctrl + nu;
    const float* xfrc = app + nv;
    for (int k = 0; k < nv; ++k) ws[k] = xfrc[6 * nb + k];
    // per-env damping rows after the warm start (_forward_env_block
    // :1270, the vec of fused_constraint :2254)
    const float* damp = DAMP ? xfrc + 6 * nb + nv : nullptr;
    com_pos(T, s);
    crb_factor(T, s, nullptr);
    smooth_force<DAMP>(T, ctrl, app, xfrc, damp, qpos, qvel, s);
  } else {
    for (int d = 0; d < nv; ++d)
      for (int k = 0; k < 6; ++k) s.cdof[d][k] = v[6 * d + k];
    v += 6 * nv;
    for (int k = 0; k < 3; ++k) s.com[k] = v[k];
    v += 3;
    for (int b = 0; b < nb; ++b)
      for (int k = 0; k < 10; ++k) s.cinert[b][k] = v[10 * b + k];
    v += 10 * nb;
    for (int k = 0; k < nv; ++k) {
      s.qfrc_smooth[k] = v[k];
      ws[k] = v[nv + k];
    }
    crb_factor(T, s, v + 2 * nv);
  }
  smooth_acc(T, s);

  const RowWriter w{io, e, nv};
  const int s0 = joint_rows(T, w, qpos, qvel);
  const float* con = T.f(F_CON);
  const float* bf = T.f(F_BODY);
  const int* gbody = T.i(I_GBODY);
  const int* cinfo = T.i(I_CON);  // per slot: dim, first row
  const bool uniform = flags & UNIFORM, elliptic = flags & ELLIPTIC;
  const int nf = elliptic ? 5 : 2;  // frictions in the generic pack
  int ci = 0;                       // elliptic contact index
  for (int c = 0; c < ncon; ++c) {
    const float* p = F.pack + ((size_t)e * ncon + c) * W;
    const float dist = uniform ? p[3] : p[12];
    const float margin = uniform ? con[kConMargin] : p[13];
    const int dim = cinfo[2 * c], r0 = cinfo[2 * c + 1];
    float* mu = elliptic && dim >= 3 ? io.mu + (size_t)(ci++) * io.E + e
                                     : nullptr;
    if (!(dist < margin)) {
      if (elliptic)
        for (int t = 0; t < dim; ++t) w.off(r0 + t);
      else
        for (int f = 0; f < 4; ++f) w.off(s0 + f * ncon + c);
      continue;
    }
    if (elliptic) {  // generic pack, slot-major rows
      ell_contact_rows(T, w, r0, dim, s, p, p + 3, (int)p[22 + nf],
                       (int)p[23 + nf], dist - margin, p + 14 + nf,
                       p + 16 + nf, p[21 + nf], p + 14, qvel, mu);
    } else if (uniform) {
      const int body = gbody[(int)p[4]];
      const bool fu = flags & FRIC_UNIFORM;
      contact_rows(T, w, s0, c, s, p, con + kConFrame, -1, body,
                   dist - margin, con + kConSolref, con + kConSolimp,
                   bf[20 * body + 18], fu ? con[kConFric] : p[5],
                   fu ? con[kConFric + 1] : p[6], qvel);
    } else {
      contact_rows(T, w, s0, c, s, p, p + 3, (int)p[24], (int)p[25],
                   dist - margin, p + 16, p + 18, p[23], p[14], p[15], qvel);
    }
  }

  int it;
  unsigned taken, ls[kLsWords];
  float* force = F.force + (size_t)e * nrows;
  unsigned* rb = (unsigned*)F.rows +
                 (size_t)e * io.iterations * ((nrows + 31) >> 5);
  solve_rows(T, io, e, s, ws, qacc, qfrc, it, taken, ls, rb,
             [&](int r, float f) { force[r] = f; });
  for (int w = 0; w < kLsWords; ++w) F.ls[(size_t)e * kLsWords + w] = (int)ls[w];
  for (int k = 0; k < nv; ++k) {
    F.qacc[(size_t)e * nv + k] = qacc[k];
    F.qfrc[(size_t)e * nv + k] = qfrc[k];
    F.qacc_smooth[(size_t)e * nv + k] = s.asm_[k];
  }
  F.iters[e] = it;
  F.taken[e] = (int)taken;
  if (F.dv) {
    float dv[NVM];
    euler_dv(T, s, qacc, dv);
    for (int k = 0; k < nv; ++k) F.dv[(size_t)e * nv + k] = dv[k];
  }
}

constexpr int kBlock = 32;

}  // namespace

// ints/flts: the packed plan (ops/plan.py). vec (E, nvec) and pack
// (E, ncon, pack_w) env-major. Outputs env-major: qacc, qfrc, qacc_smooth
// (E, nv), force (E, nrows) in the plan's row layout, iters and taken
// (E,) int, ls (E, 4) int (the line search's decisions), rows (E,
// iterations, (nrows + 31) / 32) int (the rows' Hessian decisions), dv
// (E, nv) or null. Scratch env-last: J (nrows, nv, E), aref,
// D, R, act, jar, jv (nrows, E), fl (max(nfl, 1), E), mu (max(ncon_ell,
// 1), E).
extern "C" int lmt_fused(const void* ints, const void* flts, const void* vec,
                         const void* pack, void* qacc, void* force,
                         void* qfrc, void* qacc_smooth, void* dv, void* iters,
                         void* taken, void* ls, void* rows, void* J,
                         void* aref, void* D,
                         void* R,
                         void* act, void* fl, void* jar, void* jv, void* mu,
                         int E, int nvec, int damp_rows, int iterations,
                         int ls_iterations, float scale, float tol,
                         void* stream) {
  if (E <= 0) return 0;
  const Tab T{(const int*)ints, (const float*)flts};
  const Io io{(float*)J,   (float*)aref, (float*)D,  (float*)R,
              (float*)act, (float*)fl,   (float*)jar, (float*)jv,
              (float*)mu,  E,            iterations, ls_iterations,
              scale,       tol};
  const Fused F{(const float*)vec, (const float*)pack, (float*)qacc,
                (float*)force, (float*)qfrc, (float*)qacc_smooth, (float*)dv,
                (int*)iters, (int*)taken, (int*)ls, (int*)rows, nvec};
  const int grid = (E + kBlock - 1) / kBlock;
  if (damp_rows)
    fused_kernel<true><<<grid, kBlock, 0, (cudaStream_t)stream>>>(T, io, F);
  else
    fused_kernel<false><<<grid, kBlock, 0, (cudaStream_t)stream>>>(T, io, F);
  return (int)cudaGetLastError();
}
