// The batched Newton constraint solve, one warp per env.
//
// Replaces the Pallas solve kernel of loco_mujoco_tpu/ops/pallas_newton.py:
// _solve_batched (pallas_call) with its body _make_kernel -> solve_core and
// chol_solve_spd, reached through get_solver from solver.solve's fast path
// (the staged step of a model without a row plan). The solve is
// warp_core.cuh's `newton` and `row_forces`, the mega and fused kernels'
// own: the cost-based warm start, `iterations` Newton steps (Hessian
// M + J'diag(w)J, Cholesky, the safeguarded-secant line search of
// `ls_iterations` trials) and MuJoCo's per-env termination, for equality,
// friction-loss and one-sided rows (limits, pyramidal contact facets).
//
// Layout: the operands come env-major, as ops/hopper_newton.solve receives
// them: J (E, nefc, nv), M (E, nv, nv), aref, D, R, act and the
// friction-loss bounds (E, nefc), qacc_smooth and the warm start (E, nv);
// the outputs go out env-major: qacc (E, nv), the row forces (E, nefc), the
// decisions (iters, taken (E,), the line search's words (E, 4) and each
// step's Hessian decision of every row (E, iterations, (nefc + 31) / 32)).
// So no relayout runs around the kernel. J stays in device memory: a lane
// per row reads its row's nv contiguous floats (the row passes), a lane per
// dof a row coalesced (the gradient, the Hessian), as the mega kernels' J
// scratch is read. Each warp copies its env's M, row quantities and vectors
// once into its shared region (ops/plan.py SolveLaunch: the row arrays and
// the three row lists, M, H and the gradient, the vectors and the decision
// words; 19 KB per env at 456 rows and nv 19).
//
// Bound: operations. Per env and Newton step the solve does ~nA nv^2 / 2
// multiply-adds for the Hessian over its nA rows with a Hessian term and
// nv^3 / 6 for the Cholesky against nefc nv 4 bytes of J, most of them
// inactive and never read. The warp spreads the row passes over its lanes
// (lane per active row), the Hessian over the lower triangle's entries and
// the factor over the rows of each column; the copies are coalesced.

#include <cuda_runtime.h>
#include <math.h>

#include "warp_core.cuh"

namespace {

// Env-major operands and outputs of the solve.
struct Operands {
  const float *J, *M, *aref, *D, *R, *floss, *act, *asm_, *ws;
  float *x, *force;
  int *iters, *taken, *ls, *rows;
  int E, nv, nefc, ne, nfl, iterations, ls_iterations;
  float scale, tol;
};

__global__ void __launch_bounds__(kWarp* kMaxEnvsPerBlock, 1)
    newton_kernel(Operands o, const int* __restrict__ shm, int env_floats) {
  extern __shared__ float smem[];
  const int e = blockIdx.x * (blockDim.x / kWarp) + threadIdx.x / kWarp;
  if (e >= o.E) return;  // the whole warp
  const int nv = o.nv, nefc = o.nefc, ne = o.ne, nfl = o.nfl;
  Env s = env_at(shm, smem + (size_t)(threadIdx.x / kWarp) * env_floats, e,
                 [&](int k) { return k == NV ? nv : k == NROWS ? nefc : 0; });
  s.J = const_cast<float*>(o.J) + (size_t)e * nefc * nv;  // read only
  const size_t er = (size_t)e * nefc, ev = (size_t)e * nv;
  for (int i = s.lane; i < nv * nv; i += kWarp) s.M[i] = o.M[ev * nv + i];
  for (int r = s.lane; r < nefc; r += kWarp) {
    s.ra(R_AREF)[r] = o.aref[er + r];
    s.ra(R_D)[r] = o.D[er + r];
    s.ra(R_ACT)[r] = o.act[er + r];
  }
  for (int r = s.lane; r < ne + nfl; r += kWarp) s.R[r] = o.R[er + r];
  for (int q = s.lane; q < nfl; q += kWarp) s.fl[q] = o.floss[er + ne + q];
  for (int k = s.lane; k < nv; k += kWarp) {
    s.vec(V_ASM)[k] = o.asm_[ev + k];
    s.vec(V_WS)[k] = o.ws[ev + k];
  }
  __syncwarp();
  const Rows rows{s.ra(R_AREF), s.ra(R_D), s.R, s.fl, s.ra(R_ACT), 1, 0, ne,
                  nfl};
  const int nrw = (nefc + 31) >> 5;
  int it;
  unsigned taken;
  newton<float>(s, rows, false, s.vec(V_WS), o.iterations, o.ls_iterations,
                o.scale, o.tol, it, taken,
                (unsigned*)o.ls + (size_t)e * kLsWords,
                (unsigned*)o.rows + (size_t)e * o.iterations * nrw);
  const float* x = s.vec(V_X);
  row_forces(s, rows, false, x);
  const float* F = s.ra(R_F);
  for (int r = s.lane; r < nefc; r += kWarp) o.force[er + r] = F[r];
  for (int k = s.lane; k < nv; k += kWarp) o.x[ev + k] = x[k];
  if (s.lane == 0) {
    o.iters[e] = it;
    o.taken[e] = (int)taken;
  }
}

}  // namespace

// Env-major operands and outputs (see the note above); shm: the launch's
// per-env offsets (ops/plan.py SolveLaunch.table(), SHM order, int32 on the
// card), env_floats of shared memory per env, envs_per_block envs (warps)
// per block. One lane-array width is compiled per library: LMT_NVM, 24, or
// 32 in the library built for nv 25-32 (ops/kernels.py WIDE); a larger nv
// is refused.
extern "C" int lmt_newton_solve(
    const void* J, const void* M, const void* aref, const void* D,
    const void* R, const void* floss, const void* act,
    const void* qacc_smooth, const void* warmstart, void* x_out,
    void* force_out, void* iters_out, void* taken_out, void* ls_out,
    void* rows_out, const void* shm, int E, int nv, int nefc, int ne,
    int nfl, int iterations, int ls_iterations, int env_floats,
    int envs_per_block, float scale, float tol, void* stream) {
  if (E <= 0) return 0;
  if (nv > LMT_NVM || envs_per_block < 1 ||
      envs_per_block > kMaxEnvsPerBlock)
    return (int)cudaErrorInvalidValue;
  const Operands o{(const float*)J,    (const float*)M,
                   (const float*)aref, (const float*)D,
                   (const float*)R,    (const float*)floss,
                   (const float*)act,  (const float*)qacc_smooth,
                   (const float*)warmstart,
                   (float*)x_out,      (float*)force_out,
                   (int*)iters_out,    (int*)taken_out,
                   (int*)ls_out,       (int*)rows_out,
                   E, nv, nefc, ne, nfl, iterations, ls_iterations,
                   scale, tol};
  const size_t bytes = (size_t)envs_per_block * env_floats * sizeof(float);
  const int rc = prepare(newton_kernel, bytes);
  if (rc) return rc;
  const int grid = (E + envs_per_block - 1) / envs_per_block;
  newton_kernel<<<grid, kWarp * envs_per_block, bytes,
                  (cudaStream_t)stream>>>(o, (const int*)shm, env_floats);
  return (int)cudaGetLastError();
}

// Resident warps (envs) per SM of the kernel at this launch, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int lmt_newton_occupancy(int env_floats, int envs_per_block,
                                    int* out) {
  const size_t bytes = (size_t)envs_per_block * env_floats * sizeof(float);
  const int rc = prepare(newton_kernel, bytes);
  if (rc) return rc;
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, newton_kernel, kWarp * envs_per_block, bytes);
  out[0] = n * envs_per_block;
  return (int)cudaGetLastError();
}
