// The Newton constraint solve of one env, shared by the standalone solve
// kernel (newton.cu) and the mega kernels (mega.cu): one Newton code.
//
// It computes what loco_mujoco_tpu/ops/pallas_newton.py: solve_core
// computes for pyramidal / limit / friction-loss / equality rows: the
// cost-based warm-start select, then `iterations` rounds of (Hessian
// M + J'diag(w)J, Cholesky, the safeguarded-secant line search of
// `ls_iterations` steps on phi'), with MuJoCo's per-env termination: take a
// step only if it lowers the cost, and freeze the env once the scaled
// improvement or the scaled gradient drops below the tolerance. A frozen
// env stops iterating; its x is exactly the x of the last accepted step, as
// in solve_core (pallas_newton.py:671-710) and solver.py:341-383.
//
// Layout: row operands are env-last, so the 32 threads of a warp read 32
// neighbouring floats: J (nefc, nv, E), row quantities (nefc, E),
// friction-loss bounds (nfl, E). An inactive row (act == 0) has zero
// force, Hessian weight and cost, so every pass skips it before loading
// its J row: the sums are the same as over all rows. M comes through an
// accessor (`Mat(a, b)`), global env-last in the standalone kernel and a
// per-thread array in the mega kernels.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lmt {

constexpr float kMinVal = 1e-15f;

struct Rows {
  const float* aref;
  const float* D;
  const float* R;
  const float* fl;
  const float* act;
  size_t E;
  int e, ne, nfl;

  __device__ size_t at(int r) const { return (size_t)r * E + e; }
  __device__ bool on(int r) const { return act[at(r)] != 0.f; }

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

  __device__ float cost(int r, float s) const {
    float f, w, c;
    fwc(r, s, f, w, c);
    return c;
  }
};

__device__ __forceinline__ float falsi(float lo, float dlo, float hi,
                                       float dhi) {
  const float denom = dhi - dlo;
  const float a = denom > kMinVal ? lo - dlo * (hi - lo) / denom
                                  : 0.5f * (lo + hi);
  return fminf(fmaxf(a, lo), hi);
}

// Solve for env rows.e. asm_ (qacc_smooth) and ws (warm start) are nv
// values; x receives qacc. jar, jv: (nefc, E) global scratch. Returns the
// Newton steps run in `iters` and the discrete decisions in `taken`: bit
// i, step i lowered the cost and was taken; bit 31, x started at the warm
// start.
template <int NVM, class MatFn>
__device__ void newton_solve(const float* __restrict__ J, const Rows& rows,
                             MatFn Mat, const float* asm_, const float* ws,
                             float* x, float* __restrict__ jar,
                             float* __restrict__ jv, int nv, int nefc,
                             int iterations, int ls_iterations, float scale,
                             float tol, int& iters, unsigned& taken) {
  const size_t sE = rows.E;
  const int e = rows.e;
  float g[NVM], dx[NVM], mdx0[NVM], mdx[NVM], jr[NVM];
  float H[NVM * NVM];

  auto load_row = [&](int r) {
    for (int k = 0; k < nv; ++k) jr[k] = J[((size_t)r * nv + k) * sE + e];
  };
  auto row_dot = [&](const float* v) {
    float s = 0.f;
    for (int k = 0; k < nv; ++k) s += jr[k] * v[k];
    return s;
  };
  auto mat_vec = [&](const float* v, float* out) {
    for (int a = 0; a < nv; ++a) {
      float s = 0.f;
      for (int b = 0; b < nv; ++b) s += Mat(a, b) * v[b];
      out[a] = s;
    }
  };
  // total cost at v: constraint rows plus 0.5 (v - asm)' M (v - asm)
  auto total_cost = [&](const float* v) {
    float c = 0.f;
    for (int r = 0; r < nefc; ++r) {
      if (!rows.on(r)) continue;
      load_row(r);
      c += rows.cost(r, row_dot(v) - rows.aref[rows.at(r)]);
    }
    float t[NVM], mt[NVM];
    for (int k = 0; k < nv; ++k) t[k] = v[k] - asm_[k];
    mat_vec(t, mt);
    float gauss = 0.f;
    for (int k = 0; k < nv; ++k) gauss += t[k] * mt[k];
    return c + 0.5f * gauss;
  };

  for (int k = 0; k < nv; ++k) dx[k] = ws[k];
  const float c_ws = total_cost(dx);
  const float c_sm = total_cost(asm_);
  const bool use_ws = c_ws < c_sm;
  for (int k = 0; k < nv; ++k) x[k] = use_ws ? dx[k] : asm_[k];
  float cost = fminf(c_ws, c_sm);

  taken = use_ws ? 1u << 31 : 0u;
  int it = 0;
  for (; it < iterations; ++it) {
    // M (x - asm), the gradient start and the Hessian's M part
    for (int k = 0; k < nv; ++k) dx[k] = x[k] - asm_[k];
    mat_vec(dx, mdx0);
    for (int k = 0; k < nv; ++k) g[k] = mdx0[k];
    for (int a = 0; a < nv; ++a) {
      for (int b = 0; b <= a; ++b) H[a * NVM + b] = Mat(a, b);
      H[a * NVM + a] += 1e-12f;
    }
    // one pass over the rows: jar, grad -= J'f, H += J' diag(w) J
    for (int r = 0; r < nefc; ++r) {
      if (!rows.on(r)) continue;
      load_row(r);
      const float s = row_dot(x) - rows.aref[rows.at(r)];
      jar[rows.at(r)] = s;
      float f, w, c;
      rows.fwc(r, s, f, w, c);
      if (f != 0.f)
        for (int k = 0; k < nv; ++k) g[k] -= jr[k] * f;
      if (w != 0.f)
        for (int a = 0; a < nv; ++a) {
          const float wa = w * jr[a];
          if (wa != 0.f)
            for (int b = 0; b <= a; ++b) H[a * NVM + b] += wa * jr[b];
        }
    }
    // Cholesky H = L L' in place (lower), pivots floored at 1e-30
    for (int j = 0; j < nv; ++j) {
      float d = H[j * NVM + j];
      for (int k = 0; k < j; ++k) d -= H[j * NVM + k] * H[j * NVM + k];
      const float dj = sqrtf(fmaxf(d, 1e-30f));
      H[j * NVM + j] = dj;
      const float inv = 1.f / dj;
      for (int i = j + 1; i < nv; ++i) {
        float s = H[i * NVM + j];
        for (int k = 0; k < j; ++k) s -= H[i * NVM + k] * H[j * NVM + k];
        H[i * NVM + j] = s * inv;
      }
    }
    // dx = -H^-1 grad: L y = -g, then L' dx = y
    for (int i = 0; i < nv; ++i) {
      float s = -g[i];
      for (int k = 0; k < i; ++k) s -= H[i * NVM + k] * dx[k];
      dx[i] = s / H[i * NVM + i];
    }
    for (int i = nv - 1; i >= 0; --i) {
      float s = dx[i];
      for (int k = i + 1; k < nv; ++k) s -= H[k * NVM + i] * dx[k];
      dx[i] = s / H[i * NVM + i];
    }
    // jv = J dx, and phi'(0) = dx' M (x - asm) - f(jar)' jv
    float fjv = 0.f;
    for (int r = 0; r < nefc; ++r) {
      if (!rows.on(r)) continue;
      load_row(r);
      const float v = row_dot(dx);
      jv[rows.at(r)] = v;
      fjv += rows.force(r, jar[rows.at(r)]) * v;
    }
    mat_vec(dx, mdx);
    float g0 = 0.f, h0 = 0.f;
    for (int k = 0; k < nv; ++k) {
      g0 += dx[k] * mdx0[k];
      h0 += dx[k] * mdx[k];
    }
    // safeguarded secant on phi'(a) = g0 + a h0 - f(jar + a jv)' jv
    float lo = 0.f, dlo = g0 - fjv, hi = 0.f, dhi = 1.f, a = 1.f;
    bool has_hi = false;
    for (int ls = 0; ls < ls_iterations; ++ls) {
      float d = g0 + a * h0;
      for (int r = 0; r < nefc; ++r) {
        if (!rows.on(r)) continue;
        const size_t o = rows.at(r);
        d -= rows.force(r, jar[o] + a * jv[o]) * jv[o];
      }
      if (d < 0.f) {
        lo = a;
        dlo = d;
      } else {
        hi = a;
        dhi = d;
        has_hi = true;
      }
      a = has_hi ? falsi(lo, dlo, hi, dhi) : a * 2.f;
    }
    const float alpha = has_hi ? falsi(lo, dlo, hi, dhi) : lo;
    // the new cost from this iteration's products; termination test
    float cost_new = 0.f, gn = 0.f;
    for (int r = 0; r < nefc; ++r) {
      if (!rows.on(r)) continue;
      const size_t o = rows.at(r);
      cost_new += rows.cost(r, jar[o] + alpha * jv[o]);
    }
    float gauss = 0.f;
    for (int k = 0; k < nv; ++k) {
      gauss += (x[k] + alpha * dx[k] - asm_[k]) * (mdx0[k] + alpha * mdx[k]);
      gn += g[k] * g[k];
    }
    cost_new += 0.5f * gauss;
    const bool done =
        (cost - cost_new) / scale < tol || sqrtf(gn) / scale < tol;
    if (cost_new < cost) {
      taken |= 1u << it;
      for (int k = 0; k < nv; ++k) x[k] += alpha * dx[k];
      cost = cost_new;
    }
    if (done) {
      ++it;
      break;
    }
  }
  iters = it;
}

// The force of row r at the solution x (0 for an inactive row); jr is
// scratch for the row.
template <int NVM>
__device__ float row_force(const float* __restrict__ J, const Rows& rows,
                           const float* x, float* jr, int nv, int r) {
  if (!rows.on(r)) return 0.f;
  const size_t sE = rows.E;
  for (int k = 0; k < nv; ++k) jr[k] = J[((size_t)r * nv + k) * sE + rows.e];
  float s = 0.f;
  for (int k = 0; k < nv; ++k) s += jr[k] * x[k];
  return rows.force(r, s - rows.aref[rows.at(r)]);
}

}  // namespace lmt
