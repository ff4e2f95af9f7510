// hdbscan's exact k-nearest-neighbour graph for Hopper (sm_90a): for every
// valid point, its k nearest valid others by the expanded-form d2, in
// (d2, column) order, and the count of rows whose k-th and (k+1)-th d2 tie.
//
// The plain version is ops/cluster.py: _knn_graph_plain (blocks of rows,
// _sq_dist_expanded, then _smallest_k). Over the m compacted valid points
// q (x, y, z, qsq = (x*x + y*y) + z*z, qsq computed by PyTorch), row r and
// column c:
// * d2 = (((p0*q0 + p1*q1) + p2*q2) * -2 + psq) + qsq, p = q[r],
//   psq = qsq[r]; d2 of the row itself is 1e9 (_BIG), so self is never a
//   neighbour unless fewer than k others exist, and then it is "none";
// * the k + 1 smallest (d2, column) of the row, ascending, the lowest
//   column first among equal d2 (lax.top_k's order);
// * vals[r, i], cols[r, i] for i < k: that list's i-th, or (1e9, m) where
//   its d2 is >= 1e9 ("none");
// * ties: the rows whose k-th and (k+1)-th d2 are equal and below 1e9 (the
//   plain version sorts those rows whole; info["tie_rows"]).
//
// Bit-equality. Every multiply and add is an explicit round-to-nearest
// intrinsic (__fmul_rn, __fadd_rn), so nvcc contracts nothing into an FMA
// and each rounds as the PyTorch elementwise kernel that the plain version
// runs for it. The exact * -2 is folded into p (-2 p0 * q0 = -2 (p0 * q0)
// and -2 a + -2 b = -2 (a + b), bit for bit, while no product or partial
// sum is subnormal: nonzero coordinates above ~1e-19 m). The list is held
// in (d2, column) order, so the order in which columns are visited does
// not change it.
// tests/test_torch_knn_graph_kernel.py holds a numpy model of this order
// to the plain version on the CPU; chip_smoke.py (--hdbscan) and that
// file's gpu case hold the kernel to it on the card, every bit.
//
// Replaces no Pallas kernel: icpflow_tpu/ops/cluster.py:
// exact_knn_mutual_reachability is jnp, its top-k XLA's lax.top_k /
// approx_min_k. In eager PyTorch it is ~750 blocks of ~299 rows a dense
// pair (m ~ 224k), each writing and re-reading a 256 MB d2 block in six
// elementwise passes, then torch.topk, two sorts, two gathers and a host
// read, and a whole-row sort of the tie rows. What bounds the work is its
// arithmetic: m (m - 1) pairs of 10 lane-operations (nine for d2 and the
// exclusion of self, one compare against the running (k+1)-th) at 33.5e12
// FP32 lane-operations/s, ~15 ms at m = 224k (benchmark/layers/
// hdbscan_bound.py); its bytes (points in, k edges a row out) are ~40 MB,
// ~12 us at 3.35 TB/s. So it is bound by operations. This kernel issues 8
// a pair (the * -2 folded, the exclusion moved into the rare insert), so
// its own floor is ~12 ms at m = 224k, four fifths of that bound.
//
// Design, so that the card spends its issue slots on that arithmetic:
// * one thread holds kRows rows: the row's p (pre-scaled by -2) and psq,
//   and its running list of the k + 1 smallest (d2, column), sorted, in
//   registers (KS slots, KS the bucket 8 / 16 / 24 / 32 above k + 1; the
//   slots below the list hold (-inf, -1) and never move, so the list's
//   worst entry is always slot KS - 1 and every index is a constant);
// * columns stream through shared memory in tiles of kTile float4s
//   (x, y, z, qsq), double-buffered with cp.async; every thread of the
//   block reads the same column, a broadcast, so one 16-byte load feeds
//   kRows rows. A test of kStep columns is 7 FP operations and one compare
//   a pair and one branch a step; the insert (a constant-index shift of
//   the list, (d2, column) compared) runs only where a d2 is at most the
//   row's current (k+1)-th;
// * so that inserts stay rare from the first tile on, a block first scans
//   its home window, the columns within kSeedPad of its rows (points that
//   lie near in memory lie near in space in a scan-ordered cloud): the
//   (k+1)-th d2 found there, T, bounds the row's true (k+1)-th from above
//   (any k + 1 columns do). The main scan starts from a list of k + 1
//   entries (T, kNone): every column with d2 <= T enters, so the list
//   ends exact, and the home window's columns are met again in their turn;
// * one launch: ceil(m / kBlockRows) blocks of kBlockRows rows (876 at
//   m = 224k, ~7 a SM), each against every column; each thread then
//   writes its rows' k edges and counts its tie rows, with one atomic a
//   warp. (A split of the columns into slices merged by a second launch,
//   to fill the SMs' last wave, was slower on an H100 on the dense cell's
//   clouds, 20.3-21.8 ms against 19.3-19.8 at one slice, and 0.15 ms
//   faster on 30,842 dedup representatives; it was taken out.)
// Nothing of size m x m exists; a block holds 16 KB of shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 2;                  // rows a thread
constexpr int kBlockRows = kThreads * kRows;
constexpr int kTile = 512;                // columns a shared-memory tile
constexpr int kStep = 16;                 // columns a test
constexpr int kSeedPad = 384;             // home window: rows +- this
constexpr int kMaxK = 30;
constexpr float kBig = 1e9f;              // ops/cluster.py: _BIG
constexpr int kNone = 0x7fffffff;         // the column of an empty slot
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

__device__ __forceinline__ float quiet_nan() {
  return __int_as_float(0x7fffffff);
}

// (d, c) comes before (v, vc) in (d2, column) order
__device__ __forceinline__ bool before(float d, int c, float v, int vc) {
  return d < v || (d == v && c < vc);
}

// (d, col) into the sorted list, its last entry dropped
template <int KS>
__device__ __forceinline__ void insert(float (&v)[KS], int (&c)[KS], float d,
                                       int col) {
#pragma unroll
  for (int i = KS - 1; i > 0; --i) {
    if (before(d, col, v[i - 1], c[i - 1])) {
      v[i] = v[i - 1];
      c[i] = c[i - 1];
    } else if (before(d, col, v[i], c[i])) {
      v[i] = d;
      c[i] = col;
    }
  }
  if (before(d, col, v[0], c[0])) {
    v[0] = d;
    c[0] = col;
  }
}

__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// columns [c0, c0 + kTile) into ``tile``, those at or past c1 as points
// whose d2 is NaN, which no test admits
__device__ __forceinline__ void load_tile(float4* tile,
                                          const float4* __restrict__ pts,
                                          int c0, int c1) {
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    if (c0 + i < c1) {
      cp_async16(tile + i, pts + c0 + i);
    } else {
      tile[i] = make_float4(0.0f, 0.0f, 0.0f, quiet_nan());
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// d2 of row p (x, y, z pre-scaled by -2; w = psq) and column q
__device__ __forceinline__ float d2(const float4& p, const float4& q) {
  float s = __fadd_rn(__fmul_rn(p.x, q.x), __fmul_rn(p.y, q.y));
  s = __fadd_rn(s, __fmul_rn(p.z, q.z));
  return __fadd_rn(__fadd_rn(s, p.w), q.w);
}

// every column of [c0, c1) into the threads' lists; called by the whole
// block
template <int KS>
__device__ __forceinline__ void scan(const float4* __restrict__ pts, int c0,
                                     int c1, float4 (*tile)[kTile],
                                     const float4 (&p)[kRows],
                                     const int (&row)[kRows],
                                     float (&v)[kRows][KS],
                                     int (&c)[kRows][KS]) {
  const int tiles = (c1 - c0 + kTile - 1) / kTile;
  if (tiles <= 0) return;
  load_tile(tile[0], pts, c0, c1);
  for (int t = 0; t < tiles; ++t) {
    const int base = c0 + t * kTile;
    if (t + 1 < tiles) {
      load_tile(tile[(t + 1) & 1], pts, base + kTile, c1);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float4* tl = tile[t & 1];
#pragma unroll 1
    for (int i = 0; i < kTile; i += kStep) {
      bool hit = false;
#pragma unroll
      for (int u = 0; u < kStep; ++u) {
        const float4 q = tl[i + u];
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          hit |= d2(p[j], q) <= v[j][KS - 1];
        }
      }
      if (hit) {
#pragma unroll 1
        for (int u = 0; u < kStep; ++u) {
          const float4 q = tl[i + u];
          const int col = base + i + u;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float d = d2(p[j], q);
            if (d <= v[j][KS - 1]) {
              insert(v[j], c[j], col == row[j] ? kBig : d, col);
            }
          }
        }
      }
    }
    __syncthreads();            // the tile is read before it is refilled
  }
}

// Rows [blockIdx.x * kBlockRows, + kBlockRows) against every column: each
// row's k smallest (d2, column) into vals, cols (m, k), (1e9, m) where
// none, and the rows whose k-th and (k+1)-th d2 tie below 1e9 added to
// ties.
template <int KS>
__global__ void __launch_bounds__(kThreads)
knn_graph_kernel(const float4* __restrict__ pts, int m, int k,
                 float* __restrict__ vals, int* __restrict__ cols,
                 int* __restrict__ ties) {
  __shared__ __align__(16) float4 tile[2][kTile];
  const int lo = KS - (k + 1);            // the list is slots [lo, KS)
  const int r0 = blockIdx.x * kBlockRows;
  float4 p[kRows];
  int row[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    row[j] = r0 + j * kThreads + threadIdx.x;
    if (row[j] < m) {
      const float4 q = pts[row[j]];
      p[j] = make_float4(__fmul_rn(-2.0f, q.x), __fmul_rn(-2.0f, q.y),
                         __fmul_rn(-2.0f, q.z), q.w);
    } else {
      p[j] = make_float4(0.0f, 0.0f, 0.0f, quiet_nan());
      row[j] = -1;
    }
  }
  float v[kRows][KS];
  int c[kRows][KS];
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      v[j][i] = i < lo ? -pos_inf() : pos_inf();
      c[j][i] = i < lo ? -1 : kNone;
    }
  }
  scan<KS>(pts, max(0, r0 - kSeedPad), min(m, r0 + kBlockRows + kSeedPad),
           tile, p, row, v, c);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const float t = v[j][KS - 1];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      if (i >= lo) {
        v[j][i] = t;
        c[j][i] = kNone;
      }
    }
  }
  scan<KS>(pts, 0, m, tile, p, row, v, c);
  int tied = 0;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (row[j] < 0) continue;
    float* out_v = vals + static_cast<long long>(row[j]) * k;
    int* out_c = cols + static_cast<long long>(row[j]) * k;
#pragma unroll
    for (int i = 0; i < KS - 1; ++i) {
      if (i >= lo) {
        const bool none = !(v[j][i] < kBig);
        out_v[i - lo] = none ? kBig : v[j][i];
        out_c[i - lo] = none ? m : c[j][i];
      }
    }
    tied += v[j][KS - 2] == v[j][KS - 1] && v[j][KS - 2] < kBig;
  }
  tied = __reduce_add_sync(kFull, tied);
  if ((threadIdx.x & 31) == 0 && tied) atomicAdd(ties, tied);
}

template <int KS>
void launch(int blocks, cudaStream_t s, const float4* pts, int m, int k,
            float* vals, int* cols, int* ties) {
  knn_graph_kernel<KS><<<blocks, kThreads, 0, s>>>(pts, m, k, vals, cols,
                                                   ties);
}

}  // namespace

// Plain C entry point for ctypes. pts (m, 4) float32 (x, y, z, qsq) of the
// compacted valid points; vals (m, k) float32, cols (m, k) int32 and ties
// (1,) int32, zeroed: contiguous on one device; 1 <= m, 1 <= k <= 30.
// Launches the kernel on ``stream`` and returns its cudaError_t.
extern "C" int icpflow_knn_graph(const void* pts, int m, int k, void* vals,
                                 void* cols, void* ties, void* stream) {
  if (m < 1 || k < 1 || k > kMaxK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (m + kBlockRows - 1) / kBlockRows;
  const auto* p = static_cast<const float4*>(pts);
  auto* v = static_cast<float*>(vals);
  auto* c = static_cast<int*>(cols);
  auto* t = static_cast<int*>(ties);
  if (k + 1 <= 8) {
    launch<8>(blocks, s, p, m, k, v, c, t);
  } else if (k + 1 <= 16) {
    launch<16>(blocks, s, p, m, k, v, c, t);
  } else if (k + 1 <= 24) {
    launch<24>(blocks, s, p, m, k, v, c, t);
  } else {
    launch<32>(blocks, s, p, m, k, v, c, t);
  }
  return static_cast<int>(cudaGetLastError());
}
