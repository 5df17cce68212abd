// Env-major <-> env-last relayout: a list of up to kMaxArrays float32
// arrays, each (R, C) row-major, relaid to its (C, R) transpose in one
// launch.
//
// Replaces the Pallas relayout kernels of loco_mujoco_tpu/ops/pallas_layout.py:
// _t2d_kernel (moveaxis0_last / moveaxis_last0), _tg_kernel (to_grouped) and
// _fg_kernel (from_grouped). On the TPU the grouped (K, R, 128) layout put 8
// env rows in the sublanes of every vector tile. On Hopper that split has no
// purpose: the port's env-last layout is simply (K, E), which the
// one-thread-per-env kernels (newton.cu, plane_mesh.cu) read with coalesced
// loads, neighbouring threads on neighbouring addresses. So to_grouped and
// from_grouped map onto this same kernel with the (R, 128) split dropped.
//
// One launch per call site. The staged step relays 4 arrays into and 4 out
// of the plane-mesh select and top-K per mesh group, and 8-9 into and 2 out
// of the Newton kernel; a launch per array cost more host time than the
// copies take on the card. lmt_transpose_many takes a call site's arrays
// as (x, y, R, C) quadruples, builds a descriptor of each (pointers, R, C,
// tile shape, first tile, whether 16-byte accesses are allowed) and passes
// them by value, a __grid_constant__ parameter of under 1 KB; each block
// finds its array from the first-tile offsets (a uniform scan of at most 16
// entries) and transposes one tile of it.
//
// Bound: bytes. Every element moves once in and once out with no arithmetic:
// 2 * 4 * sum(R_i C_i) bytes over the memory rate. Arrays that the kernel
// or torch operation before the relayout has just written (the select and
// top-K operands and results, a few MB each at 4096 envs) may still sit in
// the 50 MB L2; their reads then come from L2 and the kernel can run under
// the HBM bound, while the written outputs still reach HBM once evicted.
// The Newton kernel's J (142 MB at 456 rows) streams from HBM, and nothing
// in the design depends on L2: reads and writes are coalesced either way.
//
// Design. A block of 256 threads moves one 32 x 32 logical tile through
// shared memory padded to 33 columns. Thread t reads 4 consecutive elements
// of an input row (logical row t / 8, columns 4 (t % 8) .. + 3: one float4)
// and writes 4 consecutive elements of an output row (logical column t / 8,
// rows 4 (t % 8) .. + 3: one float4), so 8 threads cover a 128-byte row
// segment on either side; with the 33-float stride a warp's shared writes
// (along a row) and reads (down a column) hit 32 different banks. A float4
// access needs the row length (C for loads, R for stores) a multiple of 4
// and a 16-byte aligned base (the wrapper cuts the outputs at 16-byte
// offsets); then a tile's ragged edge falls between whole float4s. A side
// without them (the top-K results' 102-510 rows at k = 34, the Newton
// solve's nv 19 and the mass matrix's 361) takes the same kernel's scalar
// path: a warp per logical row or column, a lane per element, each warp
// access 32 consecutive floats and the banks again distinct.
//
// Narrow arrays. A square tile over an array with C = 2 would leave 30 of
// its 32 columns idle. The logical tile packs strips of the array instead:
// with C < 32 it holds 32 / w strips of 32 rows x w columns (w the power of
// two >= C, at least 4) stacked down the array, with R < 32 it holds 32 / h
// strips of h rows x 32 columns side by side. Logical (i, j) is the tile's
// row 32 (j / w) + i % h, column 32 (i / h) + j % w (h = w = 32: the square
// tile). The shared-memory pattern, and so the bank mapping, stays the
// square tile's, at least half of every tile's lanes carry data, and a
// warp's accesses stay in runs of 4 whole rows (C <= 4) or longer.
//
// Bit-exact: a pure copy.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // the logical tile: kTile x kTile elements
constexpr int kThreads = 256;    // 4 elements (16 bytes) per thread each way
constexpr int kMaxArrays = 16;   // hopper_layout.MAX_ARRAYS

struct Array {
  const float* x;  // (R, C) row-major
  float* y;        // (C, R) row-major
  int R, C;
  int first;       // this array's first block
  int tiles_c;     // tiles across C
  int lh, lw;      // log2 of a strip's rows and columns (5, 5: square)
  int vec_x, vec_y;  // float4 loads from x, float4 stores to y
};

struct Batch {
  Array a[kMaxArrays];
  int n;
};

__global__ void __launch_bounds__(kThreads)
    transpose_many_kernel(const __grid_constant__ Batch b) {
  __shared__ float tile[kTile][kTile + 1];
  const int blk = blockIdx.x;
  int k = 0;
  while (k + 1 < b.n && blk >= b.a[k + 1].first) ++k;
  const Array& A = b.a[k];
  const int R = A.R, C = A.C, lh = A.lh, lw = A.lw;
  const int hm = (1 << lh) - 1, wm = (1 << lw) - 1;
  const int t = blk - A.first;
  const int r0 = (t / A.tiles_c) * ((kTile << lh) >> lw);  // tile rows
  const int c0 = (t % A.tiles_c) * ((kTile << lw) >> lh);  // tile columns

  // load. float4: thread t takes logical row t / 8, columns 4 (t % 8) ..
  // + 3, consecutive in one input row (C % 4 == 0, so a float4 that starts
  // inside a row ends inside it); scalar: a warp takes a logical row, a
  // lane a column, 32 consecutive elements of an input row
  if (A.vec_x) {
    const int i = threadIdx.x >> 3, j = (threadIdx.x & 7) << 2;
    const int r = r0 + (j >> lw) * kTile + (i & hm);
    const int c = c0 + (i >> lh) * kTile + (j & wm);
    if (r < R && c < C) {
      const float4 v =
          *reinterpret_cast<const float4*>(A.x + (size_t)r * C + c);
      tile[i][j] = v.x;
      tile[i][j + 1] = v.y;
      tile[i][j + 2] = v.z;
      tile[i][j + 3] = v.w;
    }
  } else {
    const int j = threadIdx.x & 31;
    for (int i = threadIdx.x >> 5; i < kTile; i += kThreads / 32) {
      const int r = r0 + (j >> lw) * kTile + (i & hm);
      const int c = c0 + (i >> lh) * kTile + (j & wm);
      if (r < R && c < C) tile[i][j] = A.x[(size_t)r * C + c];
    }
  }
  __syncthreads();
  // store, the same two ways: float4, thread t takes logical column t / 8,
  // rows 4 (t % 8) .. + 3, consecutive in one output row; scalar, a warp
  // takes a logical column, a lane a row
  if (A.vec_y) {
    const int j = threadIdx.x >> 3, i = (threadIdx.x & 7) << 2;
    const int r = r0 + (j >> lw) * kTile + (i & hm);  // output column
    const int c = c0 + (i >> lh) * kTile + (j & wm);  // output row
    if (c < C && r < R) {
      *reinterpret_cast<float4*>(A.y + (size_t)c * R + r) = make_float4(
          tile[i][j], tile[i + 1][j], tile[i + 2][j], tile[i + 3][j]);
    }
  } else {
    const int i = threadIdx.x & 31;
    for (int j = threadIdx.x >> 5; j < kTile; j += kThreads / 32) {
      const int r = r0 + (j >> lw) * kTile + (i & hm);
      const int c = c0 + (i >> lh) * kTile + (j & wm);
      if (c < C && r < R) A.y[(size_t)c * R + r] = tile[i][j];
    }
  }
}

// log2 of the power of two >= n, at least 2 (a strip is 4 wide or more)
int strip_log2(int n) {
  int l = 2;
  while ((1 << l) < n) ++l;
  return l;
}

}  // namespace

// arrays: n quadruples (x, y, R, C) as 64-bit integers; x (R, C) row-major
// -> y (C, R) row-major for each, all in one launch on `stream`.
extern "C" int lmt_transpose_many(const long long* arrays, int n,
                                  void* stream) {
  if (n < 0 || n > kMaxArrays) return (int)cudaErrorInvalidValue;
  Batch b = {};
  b.n = n;
  long long blocks = 0;
  for (int k = 0; k < n; ++k) {
    const long long* q = arrays + 4 * k;
    if (q[2] < 0 || q[3] < 0 || q[2] > INT_MAX || q[3] > INT_MAX)
      return (int)cudaErrorInvalidValue;
    Array& A = b.a[k];
    A.x = reinterpret_cast<const float*>(q[0]);
    A.y = reinterpret_cast<float*>(q[1]);
    A.R = (int)q[2];
    A.C = (int)q[3];
    A.lh = A.lw = 5;
    if (A.C < kTile && A.R >= kTile) {
      A.lw = strip_log2(A.C);
    } else if (A.R < kTile && A.C >= kTile) {
      A.lh = strip_log2(A.R);
    }
    const int TR = (kTile << A.lh) >> A.lw, TC = (kTile << A.lw) >> A.lh;
    A.tiles_c = (A.C + TC - 1) / TC;
    A.first = (int)blocks;
    blocks += (long long)((A.R + TR - 1) / TR) * A.tiles_c;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    A.vec_x = A.C % 4 == 0 && (reinterpret_cast<uintptr_t>(A.x) & 15) == 0;
    A.vec_y = A.R % 4 == 0 && (reinterpret_cast<uintptr_t>(A.y) & 15) == 0;
  }
  if (blocks == 0) return 0;
  transpose_many_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(b);
  return (int)cudaGetLastError();
}
