// The fused constraint kernel: the smooth stage from FK outputs, the
// constraint rows, the Newton solve and Euler's implicit damping of one
// forward, one warp per env.
//
// fused_kernel replaces the Pallas program of
// loco_mujoco_tpu/ops/pallas_constraint.py: _fused_batched (its
// pallas_call) with its body _make_fused_kernel(mega=False) ->
// _forward_env_block in its two vec layouts. Smooth (:1268-1281, plan flag
// SMOOTH): from the packed per-env vector of FK outputs it computes com,
// cinert, cdof, the RNE bias, passive forces and the joint actuators
// (qfrc_smooth, _smooth_preamble :950-1180). Non-smooth (:1282-1299, the
// staged path of the muscle humanoid and of actuators with activations):
// the vector carries cdof, the root subtree com, cinert, qfrc_smooth (the
// staged tendon, velocity, passive and actuation stages computed them) and
// the armature, which the CRB reads there in place of the plan's F_DOF
// column: each env's own where it is randomized or differs between stacked
// variants (the reference's per-env leaf under vmap, :2257-2264). Then, in
// both, the CRB mass matrix and qacc_smooth =
// M^-1 qfrc_smooth (:1301-1346), the JOINT-equality / friction-loss /
// limit rows and the contact rows of the slots the staged collision filled
// (:1447-1590), the Newton solve, the force of every row and qfrc = J'f
// (:1864-1890), and euler_dv = (M + h diag(damping))^-1 M qacc
// (:1893-1906). A plan with DAMP_ROWS (per-env joint damping, the
// reference's sm_dyn_damping, :529-537, with its rows at :1270) carries
// each env's damping after the warm start in the smooth vector, and the
// passive force reads it there (a template instance of its own).
//
// Every stage is csrc/warp_core.cuh's, the mega kernels' own (com_pos,
// crb, smooth_force, smooth_acc, joint_rows, contact_rows /
// ell_contact_rows, row_classes, newton, row_forces, euler_dv); only the
// walk over the contact pack is this file's (`pack_rows`), since the
// staged collision hands over packed slots where the mega kernels' own
// collision fills slot fields. Elliptic plans (flag ELLIPTIC, A1) solve in
// double, as the mega kernels' elliptic instance does: its plain version is
// ops/hopper_fused.fused_constraint_plain(solve64=True).
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
//     per-slot parameters). Elliptic plans always take it (29 floats).
//
// Row layout (the reference's): JOINT equalities, friction loss, limits,
// npad inert rows, then the contact rows: pyramidal facets BLOCKED, facet f
// (+mu1 t1, -mu1 t1, +mu2 t2, -mu2 t2) of slot c at row s0 + f ncon + c;
// elliptic cones slot-major, dim rows per slot from the plan's I_CON
// table. The kernel writes every row's force in that layout; the wrapper
// remaps them to efc_force_contact's per-slot order.
//
// Layout: the vector, the pack and the outputs are env-major (E, k); a
// warp copies its env's vector and pack, coalesced, into its shared region
// (ops/plan.py FusedLaunch: the env's vectors, cdof, joints, bodies, M, the
// factor or the Newton direction, the rows and their lists, the pack, the
// decision words). The rows' J stays in shared memory where the census
// leaves RESIDENT_FLOOR warps per SM, else in a per-env global scratch
// (E, nrows, nv | 1), read as the mega kernels read theirs.
//
// Bound: operations, not bytes. An env reads ~1 KB (vector and pack) and
// writes ~0.7 KB but does ~10^4-10^5 float operations (the smooth stage,
// the CRB and its factor, the rows, the Newton iterations over its active
// rows). The warp spreads them over its lanes as in the mega kernels: per
// body, joint and dof work lane per item, the rows lane per row or slot,
// the solve's row passes lane per active row, the Hessian lane per entry
// and the factor lane per row of each column.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "warp_core.cuh"

namespace {

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
  float* jrows;  // (E, nrows, nv | 1) the rows' J, or null (J in shared)
  int E, nvec, iterations, ls_iterations;
  float scale, tol;
};

// The contact rows of the pack's slots (in the env's slot region, pack_w
// floats each) after the joint and pad rows, lane per slot: the pyramidal
// facets of a uniform or generic pack, or (ELL) an elliptic slot's dim
// rows with its cone coefficient at its index among the slots of dim >= 3.
template <bool ELL>
__device__ void pack_rows(const Tab& T, const Env& s, const float* qvel) {
  const int ncon = s.ncon;
  const int nR = T.h(NE) + T.h(NFL);
  const int base = nR + T.h(NL) + T.h(NPAD);
  const int flags = T.h(FLAGS);
  const float* con = T.f(F_CON);
  if constexpr (ELL) {  // the generic pack with 5 frictions
    const int* cinfo = T.i(I_CON);  // per slot: dim, first row
    int cbase = 0;  // elliptic contacts before this round's slots
    for (int c0 = 0; c0 < ncon; c0 += kWarp) {
      const int c = c0 + s.lane;
      const int dim = c < ncon ? cinfo[2 * c] : 0;
      const unsigned ell = __ballot_sync(kFull, dim >= 3);
      const int ci = cbase + __popc(ell & ((1u << s.lane) - 1u));
      cbase += __popc(ell);
      if (c >= ncon) continue;
      const int r0 = cinfo[2 * c + 1];
      const float* p = s.slot(c);
      if (!(p[12] < p[13])) {
        for (int t = 0; t < dim; ++t) row_off(s, r0 + t);
        continue;
      }
      ell_contact_rows(T, s, nR, r0, dim, p, p + 3, (int)p[27], (int)p[28],
                       p[12] - p[13], p + 19, p + 21, p[26], p + 14, qvel,
                       dim >= 3 ? s.mu + ci : nullptr);
    }
  } else if (flags & UNIFORM) {
    const float* bf = T.f(F_BODY);
    const int* gbody = T.i(I_GBODY);
    const bool fu = flags & FRIC_UNIFORM;
    for (int c = s.lane; c < ncon; c += kWarp) {
      const float* p = s.slot(c);
      const float dist = p[3];
      if (!(dist < con[kConMargin])) {
        for (int f = 0; f < 4; ++f) row_off(s, base + f * ncon + c);
        continue;
      }
      const int body = gbody[(int)p[4]];
      contact_rows(T, s, nR, base, c, p, con + kConFrame, -1, body,
                   dist - con[kConMargin], con + kConSolref,
                   con + kConSolimp, bf[20 * body + 18],
                   fu ? con[kConFric] : p[5], fu ? con[kConFric + 1] : p[6],
                   qvel);
    }
  } else {  // the generic pack with 2 frictions
    for (int c = s.lane; c < ncon; c += kWarp) {
      const float* p = s.slot(c);
      if (!(p[12] < p[13])) {
        for (int f = 0; f < 4; ++f) row_off(s, base + f * ncon + c);
        continue;
      }
      contact_rows(T, s, nR, base, c, p, p + 3, (int)p[24], (int)p[25],
                   p[12] - p[13], p + 16, p + 18, p[23], p[14], p[15], qvel);
    }
  }
  __syncwarp();
}

// One warp per env, kMaxEnvsPerBlock envs at most per block (blockDim.x /
// 32 of them), env_floats of dynamic shared memory each, laid out by shm.
// DAMP: the plan's per-env damping rows (DAMP_ROWS), an instance of its
// own, so that the kernel without them reads no damping operand. ELL: the
// elliptic rows and the double solve (an elliptic plan's instance).
template <bool DAMP, bool ELL>
__global__ void __launch_bounds__(kWarp* kMaxEnvsPerBlock, 1)
    fused_kernel(Tab T, Fused F, const int* __restrict__ shm,
                 int env_floats) {
  extern __shared__ float smem[];
  const int e = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (e >= F.E) return;  // the whole warp
  Env s = env_at(shm, smem + (size_t)(threadIdx.x / kWarp) * env_floats, e,
                 [&](int k) { return T.h(k); });
  if (F.jrows) s.J = F.jrows + (size_t)e * s.nrows * s.nvj;
  const int nv = s.nv, nb = s.nb, njnt = T.h(NJNT), nu = T.h(NU);
  const int nrows = s.nrows, ncon = s.ncon, W = s.sw;
  const float* v = F.vec + (size_t)e * F.nvec;
  float* qpos = s.vec(V_QPOS);
  float* qvel = s.vec(V_QVEL);
  float* ws = s.vec(V_WS);
  for (int k = s.lane; k < nv; k += kWarp) {
    qpos[k] = v[k];
    qvel[k] = v[nv + k];
  }
  v += 2 * nv;
  if (T.h(FLAGS) & SMOOTH) {
    const float* xipos = v;
    const float* ximat = xipos + 3 * nb;
    const float* xanchor = ximat + 9 * nb;
    const float* xaxis = xanchor + 3 * njnt;
    const float* ctrl = xaxis + 3 * njnt;
    const float* app = ctrl + nu;
    const float* xfrc = app + nv;
    // per-env damping rows after the warm start (_forward_env_block
    // :1270, the vec of fused_constraint :2254)
    const float* damp = DAMP ? xfrc + 6 * nb + nv : nullptr;
    for (int i = s.lane; i < 12 * nb; i += kWarp) {
      const int b = i < 3 * nb ? i / 3 : (i - 3 * nb) / 9;
      const int k = i < 3 * nb ? B_XIPOS + i % 3 : B_XIMAT + (i - 3 * nb) % 9;
      s.body(b)[k] = xipos[i];  // xipos and ximat are adjacent
    }
    for (int i = s.lane; i < 3 * njnt; i += kWarp) {
      s.jnt[6 * (i / 3) + i % 3] = xanchor[i];
      s.jnt[6 * (i / 3) + 3 + i % 3] = xaxis[i];
    }
    for (int k = s.lane; k < nv; k += kWarp) ws[k] = xfrc[6 * nb + k];
    __syncwarp();
    com_pos(T, s);
    crb(T, s);
    smooth_force<DAMP>(T, s, ctrl, app, xfrc, damp, qpos, qvel);
  } else {
    const float* cdof = v;
    const float* com = cdof + 6 * nv;
    const float* cinert = com + 3;
    const float* qfs = cinert + 10 * nb;
    const float* arm = qfs + 2 * nv;  // after qfrc_smooth and the warm start
    for (int i = s.lane; i < 6 * nv; i += kWarp) s.cdof[i] = cdof[i];
    if (s.lane < 3) s.misc[kMiscCom + s.lane] = com[s.lane];
    for (int i = s.lane; i < 10 * nb; i += kWarp)
      s.body(i / 10)[B_CINERT + i % 10] = cinert[i];
    for (int k = s.lane; k < nv; k += kWarp) {
      s.vec(V_QFS)[k] = qfs[k];
      ws[k] = qfs[nv + k];
    }
    __syncwarp();
    crb(T, s, arm);
  }
  smooth_acc(s);
  // the staged collision's contact pack into the slot region
  const float* pk = F.pack + (size_t)e * ncon * W;
  for (int i = s.lane; i < ncon * W; i += kWarp) s.sl[i] = pk[i];
  if (ELL) row_classes(T, s);  // ends in a warp barrier
  __syncwarp();
  joint_rows(T, s, qpos, qvel);
  pack_rows<ELL>(T, s, qvel);
  const Rows rows = rows_of(T, s);
  const int nrw = (nrows + 31) >> 5;
  int it;
  unsigned taken;
  // the elliptic plans' Newton solve in double (warp_core.cuh Solve)
  newton<typename std::conditional<ELL, double, float>::type>(
      s, rows, ELL, ws, F.iterations, F.ls_iterations, F.scale, F.tol, it,
      taken, (unsigned*)F.ls + (size_t)e * kLsWords,
      (unsigned*)F.rows + (size_t)e * F.iterations * nrw);
  const float* x = s.vec(V_X);
  if constexpr (ELL)  // at the double solve's x
    row_forces(s, rows, ELL, (const double*)solve_vecs(s));
  else
    row_forces(s, rows, ELL, x);
  const float* Fr = s.ra(R_F);
  unsigned short* lf = s.list(L_F);
  const int nF = compact(s, nrows, lf, [&](int r) { return Fr[r] != 0.f; });
  for (int a = s.lane; a < nv; a += kWarp) {
    float q = 0.f;
    for (int i = 0; i < nF; ++i) q += s.jrow(lf[i])[a] * Fr[lf[i]];
    F.qfrc[(size_t)e * nv + a] = q;
    F.qacc_smooth[(size_t)e * nv + a] = s.vec(V_ASM)[a];
    F.qacc[(size_t)e * nv + a] = x[a];
  }
  for (int r = s.lane; r < nrows; r += kWarp)
    F.force[(size_t)e * nrows + r] = Fr[r];
  if (s.lane == 0) {
    F.iters[e] = it;
    F.taken[e] = (int)taken;
  }
  if (F.dv) {
    float* dv = s.vec(V_OUT);
    euler_dv(T, s, x, dv);
    for (int k = s.lane; k < nv; k += kWarp) F.dv[(size_t)e * nv + k] = dv[k];
  }
}

// The instance of the kernel that damp (the damping rows) and ell (an
// elliptic plan) select, handed to go. The wide library (LMT_NVM > 24)
// compiles the two pyramidal instances and returns cudaErrorNotSupported
// for an elliptic one (elliptic plans stop at nv 24, ops/plan.py).
template <class G>
int instance(int damp, int ell, G&& go) {
#if LMT_NVM > 24
  if (ell) return (int)cudaErrorNotSupported;
  return damp ? go(fused_kernel<true, false>) : go(fused_kernel<false, false>);
#else
  if (ell)
    return damp ? go(fused_kernel<true, true>) : go(fused_kernel<false, true>);
  return damp ? go(fused_kernel<true, false>) : go(fused_kernel<false, false>);
#endif
}

}  // namespace

// ints/flts: the packed plan (ops/plan.py); shm: the launch's per-env
// offsets (ops/plan.py FusedLaunch.table(), SHM order, int32 on the card).
// vec (E, nvec) and pack (E, ncon, pack_w) env-major. Outputs env-major:
// qacc, qfrc, qacc_smooth (E, nv), force (E, nrows) in the plan's row
// layout, iters and taken (E,) int, ls (E, 4) int (the line search's
// decisions), rows (E, iterations, (nrows + 31) / 32) int (the rows'
// Hessian decisions), dv (E, nv) or null. jrows: the rows' J scratch
// (E, nrows, nv | 1) where the launch keeps J out of shared memory, else
// null. damp_rows: the plan's damping rows; ell: an elliptic plan. The
// launch: env_floats of shared memory per env, envs_per_block envs
// (warps) per block.
extern "C" int lmt_fused(const void* ints, const void* flts, const void* shm,
                         const void* vec, const void* pack, void* qacc,
                         void* force, void* qfrc, void* qacc_smooth,
                         void* dv, void* iters, void* taken, void* ls,
                         void* rows, void* jrows, int E, int nvec,
                         int damp_rows, int ell, int iterations,
                         int ls_iterations, int env_floats,
                         int envs_per_block, float scale, float tol,
                         void* stream) {
  if (E <= 0) return 0;
  if (envs_per_block < 1 || envs_per_block > kMaxEnvsPerBlock)
    return (int)cudaErrorInvalidValue;
  const Tab T{(const int*)ints, (const float*)flts};
  const Fused F{(const float*)vec, (const float*)pack, (float*)qacc,
                (float*)force, (float*)qfrc, (float*)qacc_smooth, (float*)dv,
                (int*)iters, (int*)taken, (int*)ls, (int*)rows,
                (float*)jrows, E, nvec, iterations, ls_iterations, scale,
                tol};
  const size_t bytes = (size_t)envs_per_block * env_floats * sizeof(float);
  const int grid = (E + envs_per_block - 1) / envs_per_block;
  return instance(damp_rows, ell, [&](auto kernel) {
    const int rc = prepare(kernel, bytes);
    if (rc) return rc;
    kernel<<<grid, kWarp * envs_per_block, bytes, (cudaStream_t)stream>>>(
        T, F, (const int*)shm, env_floats);
    return (int)cudaGetLastError();
  });
}

// Resident warps (envs) per SM of the instance (damp, ell) at this launch,
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int lmt_fused_occupancy(int env_floats, int envs_per_block,
                                   int damp, int ell, int* out) {
  const size_t bytes = (size_t)envs_per_block * env_floats * sizeof(float);
  return instance(damp, ell, [&](auto kernel) {
    const int rc = prepare(kernel, bytes);
    if (rc) return rc;
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kWarp * envs_per_block, bytes);
    out[0] = n * envs_per_block;
    return (int)cudaGetLastError();
  });
}
