// The Newton constraint solve of one env, one thread per env, shared by the
// standalone solve kernel (newton.cu) and the fused kernel (fused.cu); its
// row quantities and cone zones (`Rows`, `Cone`) also serve the
// warp-per-env solve of the mega kernels (mega.cu), so the three kernels
// compute one Newton code.
//
// It computes what loco_mujoco_tpu/ops/pallas_newton.py: solve_core
// computes for pyramidal / limit / friction-loss / equality rows and
// elliptic contact cones (solve_core(ell_runs=...), :199-340, :406-426): the
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
// per-thread array in the fused kernel. (The mega kernels hold the rows in
// shared memory and build `Rows` over them with E = 1, e = 0.)
//
// Elliptic contacts (Rows::runs, (first row, contacts, dim) per run of
// equal dim, and their cone coefficients mu env-last (n, E)) are walked
// one contact at a time (Rows::walk): the cone zone of its dim rows in
// cone-scaled coordinates u_k = jar_k sqrt(D_k / D_0) (solver.py:102-161):
// separating (no force), sticking (every row quadratic) or the middle zone
// (cost 0.5 D_0 / (1 + mu^2) (n - mu t)^2), whose Hessian is a rank-1 term
// along its gradient g plus the tangential curvature
// c2 (sum_k s_k^2 J_k J_k' - Jq Jq') (_cone_hessian_terms :173-215; the
// reference adds the rank-1 parts as virtual rows, :406-426, here they are
// added to H directly).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

// The widest nv of the kernels' per-thread and per-lane arrays (the
// template width of newton_solve's callers, forward_core.cuh's NVM): 24,
// or 32 in the libraries built a second time with -DLMT_NVM=32 for the
// models with nv 25-32 (ops/kernels.py NV_WIDTHS, WIDE).
#ifndef LMT_NVM
#define LMT_NVM 24
#endif

namespace lmt {

constexpr float kMinVal = 1e-15f;

constexpr int kDimMax = 6;  // rows of one elliptic contact (condim 6)
constexpr int kLsWords = 4;  // line-search decision words (16 x 8 bits)

// The cone zone of one elliptic contact at jar values s (its dim rows):
// per-row force f and Hessian diagonal weight w, the cost c, and, in the
// middle zone, the rank-1 direction g (weight wg) and the curvature
// c2 (sum_k s_k^2 J_k J_k' - Jq Jq'), Jq = sum_k q_k s_k J_k, q_k =
// u_k / t, summed in Lagrange's form: c2 sum_{k<l} v_kl v_kl' with v_kl =
// q_l s_k J_k - q_k s_l J_l, plus c2 (1 - |q|^2) s_k^2 on the diagonal
// weights -- the same matrix without the difference of two terms that grow
// as 1/t near the apex (the plain version sums it so too).
struct Cone {
  float f[kDimMax], w[kDimMax], g[kDimMax], q[kDimMax], sc[kDimMax];
  float c, wg, c2;
  bool mid, bottom;
};

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
  __device__ bool on(int r) const { return act[at(r)] != 0.f; }

  // scalar(r) for every row outside the elliptic runs, cone(r, d, c) once
  // per elliptic contact (first row r, dim d, index c), in row order
  template <class S, class C>
  __device__ void walk(int nefc, S&& scalar, C&& cone) const {
    int r = 0, c = 0;
    for (int q = 0; q < nruns; ++q) {
      const int s0 = runs[3 * q], cnt = runs[3 * q + 1], d = runs[3 * q + 2];
      for (; r < s0; ++r) scalar(r);
      for (int i = 0; i < cnt; ++i, ++c, r += d) cone(r, d, c);
    }
    for (; r < nefc; ++r) scalar(r);
  }

  // the zone of elliptic contact ci (rows r..r+d-1, active) at jar s
  __device__ void cone(int r, int d, int ci, const float* s, Cone& z) const {
    float Dk[kDimMax], sc[kDimMax], u[kDimMax];
    const float dn = D[at(r)];
    float t2 = 0.f;
    for (int k = 0; k < d; ++k) {
      Dk[k] = D[at(r + k)];
      sc[k] = sqrtf(Dk[k] / fmaxf(dn, kMinVal));
      u[k] = s[k] * sc[k];
      if (k) t2 += u[k] * u[k];
    }
    const float m = mu[(size_t)ci * E + e];
    const float n = u[0], t = sqrtf(t2), ts = fmaxf(t, kMinVal);
    const bool top = n >= m * t;
    const bool bottom = m * n + t <= 0.f;
    z.mid = !(top || bottom);
    z.bottom = bottom;
    z.c = z.wg = z.c2 = 0.f;
    for (int k = 0; k < d; ++k) {
      z.f[k] = z.w[k] = z.g[k] = z.q[k] = 0.f;
      z.sc[k] = sc[k];
    }
    if (bottom) {
      for (int k = 0; k < d; ++k) {
        z.f[k] = -Dk[k] * s[k];
        z.w[k] = Dk[k];
        z.c += Dk[k] * s[k] * s[k];
      }
      z.c *= 0.5f;
    } else if (z.mid) {
      const float dm = dn / (1.f + m * m);
      const float nmt = n - m * t;
      const float c2 = dm * m * (m * t - n) / ts;
      z.c = 0.5f * dm * nmt * nmt;
      z.wg = dm;
      z.c2 = c2;
      z.g[0] = sc[0];
      float q2 = 0.f;
      for (int k = 1; k < d; ++k) {
        z.g[k] = -m * u[k] / ts * sc[k];
        z.q[k] = u[k] / ts;
        q2 += z.q[k] * z.q[k];
      }
      const float rest = c2 * (1.f - q2);
      for (int k = 1; k < d; ++k) z.w[k] = rest * sc[k] * sc[k];
      for (int k = 0; k < d; ++k) z.f[k] = -dm * nmt * z.g[k];
    }
  }

  __device__ float cone_cost(int r, int d, int ci, const float* s) const {
    Cone z;
    cone(r, d, ci, s, z);
    return z.c;
  }

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
// start; and, where ls_bits (kLsWords words) is given, the line search's:
// bit it * ls_iterations + j, phi' < 0 at trial j of step it; and, where
// row_bits ((iterations, (nefc + 31) / 32) words) is given, each step's
// Hessian decision of every row (ops/hopper_newton.py row_bits): bit r of
// step it's words where scalar row r took its Hessian weight, and, for an
// elliptic contact from row r, bit r in the middle zone and bit r + 1 in
// the sticking zone.
// Not inlined: inlined into the one-thread mega kernels of an earlier
// version, whose FK, collision and smooth stage kept much state live, its
// loops spilled and slowed the megastep by a third (the same H100, parent
// against change).
template <int NVM, class MatFn>
__device__ __noinline__ void newton_solve(const float* __restrict__ J,
                                          const Rows& rows,
                             MatFn Mat, const float* asm_, const float* ws,
                             float* x, float* __restrict__ jar,
                             float* __restrict__ jv, int nv, int nefc,
                             int iterations, int ls_iterations, float scale,
                             float tol, int& iters, unsigned& taken,
                             unsigned* ls_bits = nullptr,
                             unsigned* row_bits = nullptr) {
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
    rows.walk(
        nefc,
        [&](int r) {
          if (!rows.on(r)) return;
          load_row(r);
          c += rows.cost(r, row_dot(v) - rows.aref[rows.at(r)]);
        },
        [&](int r, int d, int ci) {
          if (!rows.on(r)) return;
          float sv[kDimMax];
          for (int k = 0; k < d; ++k) {
            load_row(r + k);
            sv[k] = row_dot(v) - rows.aref[rows.at(r + k)];
          }
          c += rows.cone_cost(r, d, ci, sv);
        });
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
  if (ls_bits)
    for (int w = 0; w < kLsWords; ++w) ls_bits[w] = 0u;
  const int nrw = (nefc + 31) >> 5;  // row_bits words per step
  if (row_bits)
    for (int w = 0; w < iterations * nrw; ++w) row_bits[w] = 0u;
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
    // one pass over the rows: jar, grad -= J'f, H += J' diag(w) J (and an
    // elliptic contact's rank-1 terms); the rows' Hessian decisions, one
    // word at a time (rows come in increasing order)
    unsigned word = 0u;
    int wi = 0;
    auto mark = [&](int r) {
      if ((r >> 5) != wi) {
        if (word) row_bits[it * nrw + wi] = word;
        word = 0u;
        wi = r >> 5;
      }
      word |= 1u << (r & 31);
    };
    auto add_row = [&](const float* j, float f, float w) {
      if (f != 0.f)
        for (int k = 0; k < nv; ++k) g[k] -= j[k] * f;
      if (w != 0.f)
        for (int a = 0; a < nv; ++a) {
          const float wa = w * j[a];
          if (wa != 0.f)
            for (int b = 0; b <= a; ++b) H[a * NVM + b] += wa * j[b];
        }
    };
    rows.walk(
        nefc,
        [&](int r) {
          if (!rows.on(r)) return;
          load_row(r);
          const float s = row_dot(x) - rows.aref[rows.at(r)];
          jar[rows.at(r)] = s;
          float f, w, c;
          rows.fwc(r, s, f, w, c);
          add_row(jr, f, w);
          if (row_bits && w != 0.f) mark(r);
        },
        [&](int r, int d, int ci) {
          if (!rows.on(r)) return;
          float jc[kDimMax][NVM], sv[kDimMax];
          for (int k = 0; k < d; ++k) {
            load_row(r + k);
            for (int v = 0; v < nv; ++v) jc[k][v] = jr[v];
            sv[k] = row_dot(x) - rows.aref[rows.at(r + k)];
            jar[rows.at(r + k)] = sv[k];
          }
          Cone z;
          rows.cone(r, d, ci, sv, z);
          if (row_bits && z.mid) mark(r);
          if (row_bits && z.bottom) mark(r + 1);
          for (int k = 0; k < d; ++k) add_row(jc[k], z.f[k], z.w[k]);
          if (z.mid) {  // wg Jg Jg' + c2 sum_{k<l} v_kl v_kl'
            float jg[NVM];
            for (int v = 0; v < nv; ++v) {
              jg[v] = 0.f;
              for (int k = 0; k < d; ++k) jg[v] += z.g[k] * jc[k][v];
            }
            add_row(jg, 0.f, z.wg);
            for (int k = 1; k < d; ++k)
              for (int l = k + 1; l < d; ++l) {
                const float ak = z.q[l] * z.sc[k], al = z.q[k] * z.sc[l];
                for (int v = 0; v < nv; ++v)
                  jg[v] = ak * jc[k][v] - al * jc[l][v];
                add_row(jg, 0.f, z.c2);
              }
          }
        });
    if (row_bits && word) row_bits[it * nrw + wi] = word;
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
    rows.walk(
        nefc,
        [&](int r) {
          if (!rows.on(r)) return;
          load_row(r);
          const float v = row_dot(dx);
          jv[rows.at(r)] = v;
          fjv += rows.force(r, jar[rows.at(r)]) * v;
        },
        [&](int r, int d, int ci) {
          if (!rows.on(r)) return;
          float sv[kDimMax], vv[kDimMax];
          for (int k = 0; k < d; ++k) {
            load_row(r + k);
            vv[k] = row_dot(dx);
            jv[rows.at(r + k)] = vv[k];
            sv[k] = jar[rows.at(r + k)];
          }
          Cone z;
          rows.cone(r, d, ci, sv, z);
          for (int k = 0; k < d; ++k) fjv += z.f[k] * vv[k];
        });
    mat_vec(dx, mdx);
    float g0 = 0.f, h0 = 0.f;
    for (int k = 0; k < nv; ++k) {
      g0 += dx[k] * mdx0[k];
      h0 += dx[k] * mdx[k];
    }
    // safeguarded secant on phi'(a) = g0 + a h0 - f(jar + a jv)' jv
    float lo = 0.f, dlo = g0 - fjv, hi = 0.f, dhi = 1.f, a = 1.f;
    bool has_hi = false;
    // the rows' force . jv at jar + a jv
    auto force_jv = [&](float a) {
      float t = 0.f;
      rows.walk(
          nefc,
          [&](int r) {
            if (!rows.on(r)) return;
            const size_t o = rows.at(r);
            t += rows.force(r, jar[o] + a * jv[o]) * jv[o];
          },
          [&](int r, int dd, int ci) {
            if (!rows.on(r)) return;
            float sv[kDimMax];
            for (int k = 0; k < dd; ++k) {
              const size_t o = rows.at(r + k);
              sv[k] = jar[o] + a * jv[o];
            }
            Cone z;
            rows.cone(r, dd, ci, sv, z);
            for (int k = 0; k < dd; ++k) t += z.f[k] * jv[rows.at(r + k)];
          });
      return t;
    };
    for (int ls = 0; ls < ls_iterations; ++ls) {
      const float d = g0 + a * h0 - force_jv(a);
      if (d < 0.f) {
        lo = a;
        dlo = d;
        const int bit = it * ls_iterations + ls;
        if (ls_bits && bit < 32 * kLsWords)
          ls_bits[bit >> 5] |= 1u << (bit & 31);
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
    rows.walk(
        nefc,
        [&](int r) {
          if (!rows.on(r)) return;
          const size_t o = rows.at(r);
          cost_new += rows.cost(r, jar[o] + alpha * jv[o]);
        },
        [&](int r, int d, int ci) {
          if (!rows.on(r)) return;
          float sv[kDimMax];
          for (int k = 0; k < d; ++k) {
            const size_t o = rows.at(r + k);
            sv[k] = jar[o] + alpha * jv[o];
          }
          cost_new += rows.cone_cost(r, d, ci, sv);
        });
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

// J_r x - aref_r of row r at the solution x, accumulated in double: the
// returned forces are D times this difference of two nearly equal terms
// (stiff rows, impratio 100 on elliptic friction rows), so it is rounded
// once, at the end (the plain version does the same).
__device__ __forceinline__ float jar_exact(const float* jr, const float* x,
                                           int nv, float aref) {
  double s = 0.0;
  for (int k = 0; k < nv; ++k) s += (double)jr[k] * (double)x[k];
  return (float)(s - (double)aref);
}

// The force of row r at the solution x (0 for an inactive row); jr is
// scratch for the row. Rows outside the elliptic runs only.
template <int NVM>
__device__ float row_force(const float* __restrict__ J, const Rows& rows,
                           const float* x, float* jr, int nv, int r) {
  if (!rows.on(r)) return 0.f;
  const size_t sE = rows.E;
  for (int k = 0; k < nv; ++k) jr[k] = J[((size_t)r * nv + k) * sE + rows.e];
  return rows.force(r, jar_exact(jr, x, nv, rows.aref[rows.at(r)]));
}

// Every row's force at the solution x: put(r, f, J row) in row order (f 0
// and the row unread for an inactive row); jr, jc: scratch.
template <int NVM, class Put>
__device__ void row_forces(const float* __restrict__ J, const Rows& rows,
                           const float* x, int nv, int nefc, Put&& put) {
  const size_t sE = rows.E;
  float jc[kDimMax][NVM];
  rows.walk(
      nefc,
      [&](int r) {
        const float f = row_force<NVM>(J, rows, x, jc[0], nv, r);
        put(r, f, jc[0]);
      },
      [&](int r, int d, int ci) {
        if (!rows.on(r)) {
          for (int k = 0; k < d; ++k) put(r + k, 0.f, jc[k]);
          return;
        }
        float sv[kDimMax];
        for (int k = 0; k < d; ++k) {
          for (int v = 0; v < nv; ++v)
            jc[k][v] = J[((size_t)(r + k) * nv + v) * sE + rows.e];
          sv[k] = jar_exact(jc[k], x, nv, rows.aref[rows.at(r + k)]);
        }
        Cone z;
        rows.cone(r, d, ci, sv, z);
        for (int k = 0; k < d; ++k) put(r + k, z.f[k], jc[k]);
      });
}

}  // namespace lmt
