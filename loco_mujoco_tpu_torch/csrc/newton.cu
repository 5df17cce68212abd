// The batched Newton constraint solve, one thread per env.
//
// Replaces the Pallas solve kernel of loco_mujoco_tpu/ops/pallas_newton.py:
// _solve_batched (pallas_call) with its body _make_kernel -> solve_core and
// chol_solve_spd, reached through get_solver from solver.solve's fast path.
// The solve itself is lmt::newton_solve (newton_core.cuh), which the fused
// kernel (fused.cu) shares; this kernel feeds it J, M and the row quantities
// from global memory.
//
// Layout: every operand is env-last, so the 32 threads of a warp read 32
// neighbouring floats: J (nefc, nv, E), M (nv, nv, E), row quantities
// (nefc, E), friction-loss bounds (nfl, E), vectors (nv, E). The (nefc, nv)
// order of J makes its env-last form one plain 2-D transpose of the
// env-major (E, nefc * nv) array; one row of J is nv coalesced loads.
//
// Bound: operations. Per env and iteration the solve does ~nefc * nv^2
// multiply-adds for the Hessian and nv^3 / 3 for the Cholesky against
// nefc * nv * 4 bytes of J, so it is far above the card's 20 flop/byte f32
// balance. What limits this simple first version is latency: H and its
// factor (24 x 24 floats, 32 x 32 in the wide library) live in per-thread
// local memory, cached in L1/L2
// (the stack frame ptxas reports), and only E / 32 warps are in flight (128 warps
// at 4096 envs, one per SM). The row passes re-read J from L2 each time.
// jar and jv (nefc per env) go to global scratch allocated by the wrapper,
// env-last, so the line-search passes stay coalesced.

#include "newton_core.cuh"

namespace {

template <int NVM>
__global__ void __launch_bounds__(32) newton_kernel(
    const float* __restrict__ J, const float* __restrict__ M,
    const float* __restrict__ aref, const float* __restrict__ D,
    const float* __restrict__ R, const float* __restrict__ fl,
    const float* __restrict__ act, const float* __restrict__ qacc_smooth,
    const float* __restrict__ warmstart, float* __restrict__ x_out,
    float* __restrict__ force_out, int* __restrict__ iters_out,
    int* __restrict__ taken_out, float* __restrict__ jar,
    float* __restrict__ jv, int E, int nv, int nefc, int ne, int nfl,
    int iterations, int ls_iterations, float scale, float tol) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  const size_t sE = (size_t)E;
  const lmt::Rows rows{aref, D, R, fl, act, sE, e, ne, nfl};
  auto Mat = [&](int a, int b) { return M[((size_t)a * nv + b) * sE + e]; };

  float x[NVM], asm_[NVM], ws[NVM], jr[NVM];
  for (int k = 0; k < nv; ++k) {
    asm_[k] = qacc_smooth[k * sE + e];
    ws[k] = warmstart[k * sE + e];
  }
  int it;
  unsigned taken;
  lmt::newton_solve<NVM>(J, rows, Mat, asm_, ws, x, jar, jv, nv, nefc,
                         iterations, ls_iterations, scale, tol, it, taken);
  for (int r = 0; r < nefc; ++r)
    force_out[rows.at(r)] = lmt::row_force<NVM>(J, rows, x, jr, nv, r);
  for (int k = 0; k < nv; ++k) x_out[k * sE + e] = x[k];
  iters_out[e] = it;
  taken_out[e] = (int)taken;
}

template <int NVM>
int launch(const float* J, const float* M, const float* aref, const float* D,
           const float* R, const float* fl, const float* act,
           const float* qacc_smooth, const float* warmstart, float* x_out,
           float* force_out, int* iters_out, int* taken_out, float* jar,
           float* jv, int E, int nv, int nefc, int ne, int nfl, int iterations,
           int ls_iterations, float scale, float tol, cudaStream_t stream) {
  const int block = 32;
  newton_kernel<NVM><<<(E + block - 1) / block, block, 0, stream>>>(
      J, M, aref, D, R, fl, act, qacc_smooth, warmstart, x_out, force_out,
      iters_out, taken_out, jar, jv, E, nv, nefc, ne, nfl, iterations,
      ls_iterations, scale, tol);
  return (int)cudaGetLastError();
}

}  // namespace

// Env-last operands (see the note above); jar/jv are (nefc, E) scratch.
// One local-array width is compiled per library: LMT_NVM, 24, or 32 in the
// library built for nv 25-32 (ops/kernels.py WIDE; there H and its factor
// take 4 KB of local memory per thread); a larger nv is refused.
extern "C" int lmt_newton_solve(
    const void* J, const void* M, const void* aref, const void* D,
    const void* R, const void* fl, const void* act, const void* qacc_smooth,
    const void* warmstart, void* x_out, void* force_out, void* iters_out,
    void* taken_out, void* jar, void* jv, int E, int nv, int nefc, int ne,
    int nfl, int iterations, int ls_iterations, float scale, float tol,
    void* stream) {
  if (E <= 0) return 0;
#define LMT_NEWTON(NVM)                                                      \
  return launch<NVM>((const float*)J, (const float*)M, (const float*)aref,  \
                     (const float*)D, (const float*)R, (const float*)fl,    \
                     (const float*)act, (const float*)qacc_smooth,          \
                     (const float*)warmstart, (float*)x_out,                \
                     (float*)force_out, (int*)iters_out, (int*)taken_out,   \
                     (float*)jar, (float*)jv, E, nv, nefc, ne, nfl,         \
                     iterations,                                            \
                     ls_iterations, scale, tol, (cudaStream_t)stream)
  if (nv <= LMT_NVM) LMT_NEWTON(LMT_NVM);
#undef LMT_NEWTON
  return (int)cudaErrorInvalidValue;
}
