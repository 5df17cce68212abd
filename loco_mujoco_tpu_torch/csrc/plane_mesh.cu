// Plane-mesh contact slots: one kernel from a plane-mesh group's geom poses
// to its k contact slots.
//
// mesh_slots_kernel replaces, behind one boundary, the two Pallas kernels
// that loco_mujoco_tpu/ops/pallas_collision.py chains in make_group_topk
// (:556): the manifold select _make_kernel(D) (:63), launched by
// _select_batched_raw (:230), and the group top-K _topk_kernel_builder
// (:448). Per env, for every pair of the group, it computes the plane in the
// mesh frame, a_j = (R_0j n_0 + R_1j n_1) + R_2j n_2 and
// b = (n_0 d_0 + n_1 d_1) + n_2 d_2 (n the plane's normal, R the mesh's
// rotation, d the mesh origin less the plane's point: the order of
// hopper_collision.plane_in_mesh_frame and of csrc/mega.cu mesh_group, so
// that a support-vertex tie resolves as it does there), a conservative
// directed-extent bound lb <= min_v (a.v + b) and, where lb reaches the
// margin, the support depth d0 = min_v (a.v + b), first index on ties. The
// ranking key is d0 - margin, or lb - margin for a pair that cannot reach
// the margin: both are at or past 0, so such a pair ranks after every
// active one and its rank is inactive whichever pair it holds. Then the k
// smallest keys (first index on ties) and, for the k selected pairs only,
// mjc_PlaneConvex's manifold (the support vertex and the first two
// hull-graph neighbours of it, in stored edge order, below the margin and
// outside the dedupe radius), the world positions w = p + R v - n d / 2, the
// mju_makeFrame frame of the normal and the pair's statics. A rank whose
// key is not below 0 is inactive: depth 1e10, zero position, the canonical
// frame and pair 0's statics.
//
// Bound: bytes. Per env the kernel must read the poses of the geoms the
// group uses (12 floats each) and write k x 36 floats and 2 ids of slots;
// its operations (every pair's pose and bound, 7 per vertex of the near
// pairs' height maps, the selected pairs' manifolds; chip_smoke._mesh_flops)
// take a fraction of the bytes' time at the card's float32 rate.
//
// Design. The one-thread pair before it (a select over a grid of (pair,
// block of 256 envs), then a top-K with a thread per env) ran the top-K on
// 64 blocks of 2 warps with k x P dependent loads per thread, restaged each
// pair's whole table in shared memory for every block of envs, wrote 12
// floats per (pair, env) that the top-K read back for k of the P pairs, and
// needed env-last operands, so two relayout launches ran around it. Here:
// - a warp owns an env (4096 envs are 4096 warps, resident in one pass);
//   a lane per pair computes the poses and bounds from the env's own
//   contiguous rows of geom_xpos and geom_xmat, read in place;
// - each near pair's height map is walked by the whole warp, a lane per
//   vertex (coalesced rows, no lane waiting on another's large hull), its
//   first-index argmin by two warp reductions (__reduce_min_sync over the
//   keys' order-preserving unsigned images, then over the indices holding
//   the least: 9-11% faster than five shuffle rounds); the top-K is k
//   rounds of that argmin (or, up to a warp of pairs, one rank count per
//   lane), in mega.cu's wtopk order;
// - the env's scratch (per pair key, support depth and vertex; per rank its
//   pair and key: 3P + 2k words) lives in shared memory, and nothing per
//   (pair, env) reaches device memory unless the caller asks for the keys;
// - no table is staged: the hull tables are read through the read-only
//   path and stay in L1 and L2 (160.5 KB of vertex rows for the humanoid's
//   75 hulls, 20-27 KB for H1 and G1), and only the k selected pairs'
//   neighbour rows are read; the bounds and the near pairs' walks take
//   most of a warp's cycles at 4096 envs (PERF.md, Findings PR 16);
// - the slots are written env-major, as collision.collision concatenates
//   them, the geom ids as int64, so no relayout or cast runs around it.
// No tensor cores, TMA or cp.async: nothing here is a matrix tile or a
// large contiguous copy.
//
// csrc/mega.cu's mesh_group and wtopk compute the same function inside the
// mega kernels, over poses from their own FK state in shared memory and
// with a lane per pair's vertex walk; they stay as they are, so the mega
// libraries keep their code (tools/kernel_code.py).
//
// Stacked model variants (the 4-ages scalings: meshes scaled per variant,
// one hull graph) give the kernel K hull tables, one after another in tbl
// (tstride floats each), pf and st: env e reads variant env_id[e]'s, so
// the plane-mesh stage of a batch of mixed variants stays one launch. That
// is a template instance of its own (kVariants): the variant's three table
// offsets took the instance from 64 to 72 registers per thread, past the
// 64 that keep 16 blocks of 4 warps resident per SM, and cost the one-table
// launch 19-35% (tools/mesh_time.py, PERF.md Findings PR 17). A null
// env_id launches the one-table instance, every other path's code.
//
// Compiled with --fmad=false, so that its products and sums round as the
// plain PyTorch version's do and both pick the same support vertex. A
// compile-time variant, -DLMT_PHASES (tools/mesh_time.py --phases, never
// built for a path), overwrites the first three key words of each env with
// lane 0's clock64() cycles in the bounds and walks, the top-K and the
// slots.

#include <cuda_runtime.h>
#include <math.h>

#ifdef LMT_PHASES
#define LMT_CLOCK(t) const long long t = clock64()
#else
#define LMT_CLOCK(t)
#endif

namespace {

constexpr float kBig = 1e10f;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEnvs = 4;  // envs (warps) per block
constexpr int kNone = 0x7fffffff;
constexpr int kMaxPairs = 1024;
constexpr int kPairInts = 5;  // offset into the table, V, D, geom1, geom2
constexpr int kPairFloats = 8;  // margin, dedupe^2, extents lo (3), hi (3)
constexpr int kStatics = 16;  // key margin, geom1, geom2, then kMeta
constexpr int kMeta = 13;  // friction (5), solref (2), solimp (5), margin - gap

// The order-preserving unsigned image of a float (-0 taken as +0), and
// back: an unsigned warp minimum of the images is the floats' minimum.
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x == 0.f ? 0.f : x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// The first-index argmin of (key, idx) across the warp: two warp
// reductions, the least key, then the least index holding it.
__device__ __forceinline__ void wargmin(float& key, int& idx) {
  const unsigned o = ordered(key);
  const unsigned least = __reduce_min_sync(kFull, o);
  idx = (int)__reduce_min_sync(kFull, o == least ? (unsigned)idx : ~0u);
  key = from_ordered(least);
}

// A pair's poses in the env's rows: the plane's normal n (its z axis), the
// mesh's origin q and rotation R, and the plane in the mesh frame (a, b).
struct Pose {
  float n[3], q[3], R[9], a[3], b;
};

__device__ __forceinline__ void pose_of(const float* xp, const float* xm,
                                        int g1, int g2, Pose& s) {
  const float* p1 = xp + 3 * g1;
  const float* m1 = xm + 9 * g1;
  for (int i = 0; i < 3; ++i) {
    s.n[i] = m1[3 * i + 2];
    s.q[i] = xp[3 * g2 + i];
  }
  for (int i = 0; i < 9; ++i) s.R[i] = xm[9 * g2 + i];
  for (int j = 0; j < 3; ++j)
    s.a[j] = s.R[j] * s.n[0] + s.R[3 + j] * s.n[1] + s.R[6 + j] * s.n[2];
  s.b = s.n[0] * (s.q[0] - p1[0]) + s.n[1] * (s.q[1] - p1[1]) +
        s.n[2] * (s.q[2] - p1[2]);
}

template <bool kVariants>
__global__ void __launch_bounds__(kWarp * kEnvs) mesh_slots_kernel(
    const float* __restrict__ gxp, const float* __restrict__ gxm,
    const float* __restrict__ tbl, const int* __restrict__ pk,
    const float* __restrict__ pf, const float* __restrict__ st,
    const int* __restrict__ env_id, float* __restrict__ dist,
    float* __restrict__ pos, float* __restrict__ frame,
    long long* __restrict__ ids, float* __restrict__ meta,
    float* __restrict__ key_out, int P, int k, int E, int G,
    int tstride) {
  extern __shared__ float s_mem[];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int e = blockIdx.x * kEnvs + w;
  if (e >= E) return;  // the whole warp
  float* key = s_mem + (size_t)w * (3 * P + 2 * k);
  float* d0s = key + P;
  int* i0s = (int*)(d0s + P);
  int* sel = i0s + P;
  float* mk = (float*)(sel + k);
  const float* xp = gxp + (size_t)e * G * 3;
  const float* xm = gxm + (size_t)e * G * 9;
  if constexpr (kVariants) {  // this env's variant's tables and statics
    const size_t v = (size_t)env_id[e];
    tbl += v * (size_t)tstride;
    pf += v * (size_t)P * kPairFloats;
    st += v * (size_t)P * kStatics;
  }
  LMT_CLOCK(t0);

  // every pair's bound, a lane per pair, a warp's worth at a time; then the
  // support depth of each near pair of them, a lane per vertex
  for (int c = 0; c < P; c += kWarp) {
    const int p = c + lane;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, b = 0.f, margin = 0.f;
    bool near = false;
    if (p < P) {
      Pose s;
      pose_of(xp, xm, pk[kPairInts * p + 3], pk[kPairInts * p + 4], s);
      const float* f = pf + kPairFloats * p;
      margin = f[0];
      float lb = s.b - 1e-6f;
      lb = lb + fminf(s.a[0] * f[2], s.a[0] * f[5]);
      lb = lb + fminf(s.a[1] * f[3], s.a[1] * f[6]);
      lb = lb + fminf(s.a[2] * f[4], s.a[2] * f[7]);
      near = lb < margin;
      if (!near) {
        key[p] = lb - margin;
        d0s[p] = lb;
        i0s[p] = 0;
      }
      a0 = s.a[0];
      a1 = s.a[1];
      a2 = s.a[2];
      b = s.b;
    }
    for (unsigned todo = __ballot_sync(kFull, near); todo;
         todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const float qa0 = __shfl_sync(kFull, a0, src);
      const float qa1 = __shfl_sync(kFull, a1, src);
      const float qa2 = __shfl_sync(kFull, a2, src);
      const float qb = __shfl_sync(kFull, b, src);
      const float qm = __shfl_sync(kFull, margin, src);
      const int q = c + src;
      const int V = pk[kPairInts * q + 1];
      const float* tb = tbl + pk[kPairInts * q];
      float m = INFINITY;
      int idx = kNone;
      for (int v = lane; v < V; v += kWarp) {
        const float h = __ldg(tb + v) * qa0 + __ldg(tb + V + v) * qa1 +
                        __ldg(tb + 2 * V + v) * qa2 + qb;
        if (h < m) {
          m = h;
          idx = v;
        }
      }
      wargmin(m, idx);
      if (lane == 0) {
        key[q] = m - qm;
        d0s[q] = m;
        i0s[q] = idx == kNone ? 0 : idx;
      }
    }
  }
  __syncwarp();
  LMT_CLOCK(t1);
  if (key_out)
    for (int p = lane; p < P; p += kWarp) key_out[(size_t)e * P + p] = key[p];
  __syncwarp();

  // the top k by (key, index): past a warp of pairs k rounds of a warp
  // argmin, each marking its pair taken (kBig, above every finite key);
  // else each pair counts the keys before it
  if (P > kWarp) {
    for (int r = 0; r < k; ++r) {
      float m = INFINITY;
      int best = kNone;
      for (int p = lane; p < P; p += kWarp)
        if (best == kNone || key[p] < m) {
          m = key[p];
          best = p;
        }
      wargmin(m, best);
      __syncwarp();
      if (lane == 0) {
        sel[r] = best < P ? best : 0;
        mk[r] = m;
        key[sel[r]] = kBig;
      }
      __syncwarp();
    }
  } else {
    for (int r = lane; r < k; r += kWarp) {
      sel[r] = r;
      mk[r] = key[r];
    }
    __syncwarp();
    if (lane < P) {
      const float kp = key[lane];
      int rank = 0;
      for (int q = 0; q < P; ++q) {
        const float kq = key[q];
        rank += kq < kp || (kq == kp && q < lane);
      }
      if (rank < k) {
        sel[rank] = lane;
        mk[rank] = kp;
      }
    }
  }
  __syncwarp();
  LMT_CLOCK(t2);

  // the slots of each rank, a lane per rank
  for (int r = lane; r < k; r += kWarp) {
    const size_t o = (size_t)e * k + r;
    float* dd = dist + 3 * o;
    float* pp = pos + 9 * o;
    float* fr = frame + 9 * o;
    float* mt = meta + kMeta * o;
    if (!(mk[r] < 0.f)) {  // inactive: pair 0's statics
      const float canon[9] = {0.f, 0.f, 1.f, 0.f, 1.f, 0.f, -1.f, 0.f, 0.f};
      for (int f = 0; f < 3; ++f) dd[f] = kBig;
      for (int i = 0; i < 9; ++i) {
        pp[i] = 0.f;
        fr[i] = canon[i];
      }
      ids[2 * o] = pk[3];
      ids[2 * o + 1] = pk[4];
      for (int i = 0; i < kMeta; ++i) mt[i] = st[3 + i];
      continue;
    }
    const int best = sel[r];
    const int* pi = pk + kPairInts * best;
    Pose s;
    pose_of(xp, xm, pi[3], pi[4], s);
    const float margin = pf[kPairFloats * best];
    const float dedupe2 = pf[kPairFloats * best + 1];
    const int V = pi[1], D = pi[2], v0 = i0s[best];
    const float* tb = tbl + pi[0];
    const float d0 = d0s[best];
    // the support vertex and the first two neighbours below the margin and
    // outside the dedupe radius; the owner's own coordinates mark an unused
    // neighbour slot, skipped as the XLA narrowphase skips unused ids (the
    // dedupe test alone would take it once the depth passes 0.6 x the
    // hull's bounding radius)
    float d[3] = {d0, kBig, kBig};
    float vs[9] = {__ldg(tb + v0), __ldg(tb + V + v0), __ldg(tb + 2 * V + v0),
                   0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float half = 0.5f * d0;
    int cnt = 0;
    for (int c = 0; c < D && cnt < 2; ++c) {
      const float cx = __ldg(tb + (3 + c) * V + v0);
      const float cy = __ldg(tb + (3 + D + c) * V + v0);
      const float cz = __ldg(tb + (3 + 2 * D + c) * V + v0);
      if (cx == vs[0] && cy == vs[1] && cz == vs[2]) continue;
      const float hc = cx * s.a[0] + cy * s.a[1] + cz * s.a[2] + s.b;
      const float ex = (cx - vs[0]) + half * s.a[0];
      const float ey = (cy - vs[1]) + half * s.a[1];
      const float ez = (cz - vs[2]) + half * s.a[2];
      if (hc < margin && ex * ex + ey * ey + ez * ez >= dedupe2) {
        if (cnt == 0) {  // constant indices: d and vs stay in registers
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
    for (int f = 0; f < 3; ++f) {
      const float hf = 0.5f * d[f];
      for (int i = 0; i < 3; ++i) {
        const float wi = s.q[i] + s.R[3 * i] * vs[3 * f] +
                         s.R[3 * i + 1] * vs[3 * f + 1] +
                         s.R[3 * i + 2] * vs[3 * f + 2];
        pp[3 * f + i] = wi - s.n[i] * hf;
      }
      dd[f] = d[f];
    }
    // mju_makeFrame: tangent 1 from the y axis unless |n_y| >= 0.5
    const bool use_y = fabsf(s.n[1]) < 0.5f;
    const float ax[3] = {0.f, use_y ? 1.f : 0.f, use_y ? 0.f : 1.f};
    const float ndot = s.n[0] * ax[0] + s.n[1] * ax[1] + s.n[2] * ax[2];
    float t1[3];
    for (int i = 0; i < 3; ++i) t1[i] = ax[i] - s.n[i] * ndot;
    const float t1n =
        fmaxf(sqrtf(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), 1e-15f);
    for (int i = 0; i < 3; ++i) t1[i] = t1[i] / t1n;
    fr[0] = s.n[0];
    fr[1] = s.n[1];
    fr[2] = s.n[2];
    fr[3] = t1[0];
    fr[4] = t1[1];
    fr[5] = t1[2];
    fr[6] = s.n[1] * t1[2] - s.n[2] * t1[1];
    fr[7] = s.n[2] * t1[0] - s.n[0] * t1[2];
    fr[8] = s.n[0] * t1[1] - s.n[1] * t1[0];
    ids[2 * o] = pi[3];
    ids[2 * o + 1] = pi[4];
    for (int i = 0; i < kMeta; ++i) mt[i] = st[kStatics * best + 3 + i];
  }
#ifdef LMT_PHASES
  __syncwarp();
  LMT_CLOCK(t3);
  if (key_out && lane == 0 && P >= 3) {
    key_out[(size_t)e * P] = (float)(t1 - t0);
    key_out[(size_t)e * P + 1] = (float)(t2 - t1);
    key_out[(size_t)e * P + 2] = (float)(t3 - t2);
  }
#endif
}

size_t shared_bytes(int P, int k) {
  return sizeof(float) * kEnvs * (3 * (size_t)P + 2 * (size_t)k);
}

template <bool kVariants>
int set_shared(size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      mesh_slots_kernel<kVariants>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <bool kVariants>
int launch(const void* gxp, const void* gxm, const void* tbl, const void* pk,
           const void* pf, const void* st, const void* env_id, void* dist,
           void* pos, void* frame, void* ids, void* meta, void* key_out,
           int P, int k, int E, int G, int tstride, void* stream) {
  const size_t smem = shared_bytes(P, k);
  const int rc = set_shared<kVariants>(smem);
  if (rc) return rc;
  mesh_slots_kernel<kVariants><<<(E + kEnvs - 1) / kEnvs, kWarp * kEnvs,
                                 smem, (cudaStream_t)stream>>>(
      (const float*)gxp, (const float*)gxm, (const float*)tbl,
      (const int*)pk, (const float*)pf, (const float*)st,
      (const int*)env_id, (float*)dist, (float*)pos, (float*)frame,
      (long long*)ids, (float*)meta, (float*)key_out, P, k, E, G, tstride);
  return (int)cudaGetLastError();
}

}  // namespace

// gxp (E, G, 3), gxm (E, G, 9) geom poses; tbl every pair's (3 + 3D, V)
// hull table [vertex x, y, z rows, then the neighbours' x (D), y (D), z (D)
// rows], concatenated; pk (P, 5) int [offset into tbl, V, D, geom1, geom2];
// pf (P, 8) [margin, dedupe^2, extents lo (3), hi (3)]; st (P, 16) [key
// margin, geom1, geom2, friction (5), solref (2), solimp (5), margin - gap];
// with K variants, tbl, pf and st hold K of these one after another
// (tstride floats of tbl each) and env_id (E,) int each env's variant, or
// null for the first alone -> dist (E, k, 3), pos (E, k, 3, 3), frame
// (E, k, 3, 3), ids (E, k, 2) int64, meta (E, k, 13) = st[:, 3:] of each
// rank's pair; key_out (E, P), or null, every pair's ranking key.
extern "C" int lmt_mesh_slots(const void* gxp, const void* gxm,
                              const void* tbl, const void* pk, const void* pf,
                              const void* st, const void* env_id, void* dist,
                              void* pos, void* frame, void* ids, void* meta,
                              void* key_out, int P, int k, int E, int G,
                              int tstride, void* stream) {
  if (P <= 0 || P > kMaxPairs || k <= 0 || k > P)
    return (int)cudaErrorInvalidValue;
  if (E <= 0) return 0;
  return env_id ? launch<true>(gxp, gxm, tbl, pk, pf, st, env_id, dist, pos,
                               frame, ids, meta, key_out, P, k, E, G,
                               tstride, stream)
                : launch<false>(gxp, gxm, tbl, pk, pf, st, nullptr, dist,
                                pos, frame, ids, meta, key_out, P, k, E, G,
                                tstride, stream);
}

// The resident warps (envs) per SM of a launch at P pairs and k ranks, of
// the one-table instance, or with `variants` the K-table one.
extern "C" int lmt_mesh_slots_occupancy(int P, int k, int variants,
                                        int* warps) {
  if (P <= 0 || P > kMaxPairs || k <= 0 || k > P)
    return (int)cudaErrorInvalidValue;
  const size_t smem = shared_bytes(P, k);
  int rc = variants ? set_shared<true>(smem) : set_shared<false>(smem);
  if (rc) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks,
      variants ? mesh_slots_kernel<true> : mesh_slots_kernel<false>,
      kWarp * kEnvs, smem);
  *warps = blocks * kEnvs;
  return rc;
}
