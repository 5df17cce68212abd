// The row quantities of the Newton constraint solve, shared by the
// warp-per-env kernels (csrc/warp_core.cuh's `Solve`, which csrc/mega.cu,
// csrc/fused.cu and csrc/newton.cu run): each row's force, Hessian weight
// and cost at its value jar = J x - aref (`Rows::fwc`), as
// loco_mujoco_tpu/ops/pallas_newton.py: solve_core computes them for
// equality rows (quadratic), dof friction loss (Huber, with its bound fl)
// and one-sided rows (limits and pyramidal contact facets, quadratic below
// zero); the elliptic contacts' cone zones are warp_core.cuh's
// (`cone_zone`, `cone_terms`), over the cone coefficients `mu` and the
// runs of equal-dim contacts here. `falsi` is the line search's
// safeguarded secant step.
//
// A kernel builds `Rows` over one env's row arrays in shared memory (E = 1,
// e = 0): aref, D, R (read on the friction-loss rows), act (0: an inactive
// row, skipped by every pass) and fl.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// The widest nv of the kernels' per-lane arrays (forward_core.cuh's NVM):
// 24, or 32 in the libraries built a second time with -DLMT_NVM=32 for the
// models with nv 25-32 (ops/kernels.py NV_WIDTHS, WIDE).
#ifndef LMT_NVM
#define LMT_NVM 24
#endif

namespace lmt {

constexpr float kMinVal = 1e-15f;

constexpr int kDimMax = 6;  // rows of one elliptic contact (condim 6)
constexpr int kLsWords = 4;  // line-search decision words (16 x 8 bits)

// One env's row arrays (runs and mu: the elliptic contacts').
struct Rows {
  const float* aref;
  const float* D;
  const float* R;
  const float* fl;
  const float* act;
  size_t E;
  int e, ne, nfl;
  const int* runs = nullptr;  // (first row, contacts, dim) per elliptic run
  int nruns = 0;
  const float* mu = nullptr;  // (contacts, E) cone coefficients

  __device__ size_t at(int r) const { return (size_t)r * E + e; }

  // force, Hessian weight and cost of active row r at jar value s
  __device__ void fwc(int r, float s, float& f, float& w, float& c) const {
    const size_t o = at(r);
    f = w = c = 0.f;
    const float d = D[o];
    if (r < ne) {  // equality: quadratic
      f = -d * s;
      w = d;
      c = 0.5f * d * s * s;
    } else if (r < ne + nfl) {  // friction loss: Huber
      const float flv = fl[(size_t)(r - ne) * E + e];
      const float rf = R[o] * flv;
      f = fminf(fmaxf(-d * s, -flv), flv);
      const bool quad = fabsf(s) <= rf;
      w = quad ? d : 0.f;
      c = quad ? 0.5f * d * s * s : flv * fabsf(s) - 0.5f * rf * flv;
    } else if (s < 0.f) {  // limit / contact facet: one-sided quadratic
      f = -d * s;
      w = d;
      c = 0.5f * d * s * s;
    }
  }

  __device__ float force(int r, float s) const {
    float f, w, c;
    fwc(r, s, f, w, c);
    return f;
  }
};

__device__ __forceinline__ float falsi(float lo, float dlo, float hi,
                                       float dhi) {
  const float denom = dhi - dlo;
  const float a = denom > kMinVal ? lo - dlo * (hi - lo) / denom
                                  : 0.5f * (lo + hi);
  return fminf(fmaxf(a, lo), hi);
}

}  // namespace lmt
