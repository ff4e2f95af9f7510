// DBSCAN's neighbour sweep for Hopper (sm_90a): steps 2-3 of
// ops/cluster.py: dbscan. For every sorted point, the candidate runs of its
// 9 (dx, dy) columns, the (weighted) neighbour count and each run's
// first-hit edge, in one launch.
//
// The plain version is ops/cluster.py: _candidates_plain. For sorted row
// i < nv and run j (in _NBR9's order, the center first), the run is the
// range [st, st + tt) of sorted positions whose cell ids lie in
// [lo, lo + 3), lo = ids[i] + (dx * span[1] + dy) * span[2] - 1; st and
// st + tt are torch.searchsorted's lower bounds of lo and lo + 3 in ids.
// The candidates are positions st + k, k < min(tt, rcap), below nv. One is
// within range when d_sq <= r * r, d = x_pos - x_i, r = min(eps_i, eps_pos)
// (adaptive radius) or eps. The kernel writes, for every row of n:
// * counts[i]: round half to even of the left-to-right fp32 sum over the 9
//   runs of hits * (tt / max(min(tt, rcap), 1)), hits being the number of
//   within-range candidates or the sum of their multiplicities; 0 for rows
//   i >= nv;
// * edges[i, j]: the lowest within-range position of run j, n where none,
//   and n for rows i >= nv.
//
// Bit-equality. A core point is round(count) >= min_points, so one rounding
// step off can flip a cluster. The kernel repeats the plain version's float
// operations in its order, each rounded as the PyTorch kernel that runs it
// rounds it: every float operation is an explicit round-to-nearest
// intrinsic (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn), so nvcc contracts
// nothing into an FMA on its own; d_sq is ((dx * dx) + (dy * dy)) + dz * dz;
// torch.minimum passes a NaN on; torch.round is rintf (half to even). The
// hits and the first hit are integers, so the order of the warp's
// reductions changes nothing. tests/test_torch_dbscan_kernel.py holds a
// numpy model of this order to the plain version on the CPU; chip_smoke.py
// (--dbscan) holds the kernel to it on the card, every value of every row.
//
// Replaces no Pallas kernel: icpflow_tpu/ops/cluster.py: dbscan is plain
// jnp, which XLA fuses. In eager PyTorch the sweep is ~35 ops a chunk of
// 7,281 rows over (rows, 9, rcap)-element temporaries: ~1,100 launches and
// ~58 GB of reads and writes for a dense joint cloud of 262,144 slots. What
// bounds the work itself is far less: its compulsory traffic is the packed
// points, the ids and the outputs, n * (16 + 8) + n * 80 bytes (~27 MB at
// n = 262,144: ~8 us at 3.35 TB/s), and its arithmetic nv * sum_j
// min(tt_j, rcap) candidate tests of ~12 operations, at most 9 * rcap
// (1,152) a row. Design: one warp a sorted row, 8 rows a block. Lanes 0-17
// find the 18 run bounds in parallel (binary searches over ids, which stay
// in L2). The lanes then stride each run's candidates, which are contiguous
// in sorted order, one 16-byte load (xyz and eps packed as a float4) a
// candidate; neighbouring rows of a cell read the same lines, which L1 and
// L2 hold. hits and the first hit are reduced with __reduce_add_sync and
// __reduce_min_sync (shuffles for the int64 weighted sum) and kept by lane
// j for run j, which scales them; lane 0 sums the 9 products in run order.
// Nothing in shared memory, no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRuns = 9;

// ops/cluster.py: _NBR9, the center column first
__constant__ int kDx[kRuns] = {0, -1, -1, -1, 0, 0, 1, 1, 1};
__constant__ int kDy[kRuns] = {0, -1, 0, 1, -1, 1, -1, 0, 1};

// torch.searchsorted(ids, v) (side "left"): the first i with ids[i] >= v
__device__ __forceinline__ int lower_bound(const long long* __restrict__ ids,
                                           int n, long long v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// torch.minimum: a NaN in either operand is the result
__device__ __forceinline__ float torch_minimum(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

template <bool kAdaptive, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
dbscan_candidates(const float4* __restrict__ pts,
                  const long long* __restrict__ ids,
                  const long long* __restrict__ span,
                  const long long* __restrict__ mult, int n, int nv, int rcap,
                  float eps, long long* __restrict__ counts,
                  long long* __restrict__ edges) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;                           // the whole warp
  if (row >= nv) {
    if (lane < kRuns) edges[9LL * row + lane] = n;
    if (lane == 0) counts[row] = 0;
    return;
  }
  // lane j < 9: the start of run j; lane 9 + j: its end
  int bound = 0;
  if (lane < 2 * kRuns) {
    const int j = lane < kRuns ? lane : lane - kRuns;
    const long long lo =
        ids[row] + (kDx[j] * span[1] + kDy[j]) * span[2] - 1;
    bound = lower_bound(ids, n, lane < kRuns ? lo : lo + 3);
  }
  const float4 me = pts[row];
  const float r_fixed = __fmul_rn(eps, eps);
  int edge = n, run_tt = 0;                       // lane j's: run j's
  float run_hits = 0.0f;
#pragma unroll 1
  for (int j = 0; j < kRuns; ++j) {
    const int st = __shfl_sync(kFull, bound, j);
    const int tt = __shfl_sync(kFull, bound, kRuns + j) - st;
    const int stop = min(st + min(tt, rcap), nv);
    unsigned hits = 0;
    long long hits_w = 0;
    int first = n;
    for (int pos = st + lane; pos < stop; pos += 32) {
      const float4 p = pts[pos];
      const float dx = __fsub_rn(p.x, me.x);
      const float dy = __fsub_rn(p.y, me.y);
      const float dz = __fsub_rn(p.z, me.z);
      const float d_sq = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
      float r2 = r_fixed;
      if (kAdaptive) {
        const float r = torch_minimum(me.w, p.w);
        r2 = __fmul_rn(r, r);
      }
      if (d_sq <= r2) {
        if (kWeighted) {
          hits_w += mult[pos];
        } else {
          ++hits;
        }
        first = min(first, pos);
      }
    }
    first = __reduce_min_sync(kFull, first);
    float hits_f;
    if (kWeighted) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        hits_w += __shfl_xor_sync(kFull, hits_w, off);
      }
      hits_f = __ll2float_rn(hits_w);
    } else {
      hits_f = static_cast<float>(__reduce_add_sync(kFull, hits));
    }
    if (lane == j) {
      edge = first;
      run_tt = tt;
      run_hits = hits_f;
    }
  }
  // lane j: run j's hits * tt / max(min(tt, rcap), 1); lane 0 sums them
  const float tot = static_cast<float>(run_tt);
  const float hs = __fmul_rn(
      run_hits,
      __fdiv_rn(tot, fmaxf(fminf(tot, static_cast<float>(rcap)), 1.0f)));
  float acc = __shfl_sync(kFull, hs, 0);
#pragma unroll
  for (int j = 1; j < kRuns; ++j) {
    acc = __fadd_rn(acc, __shfl_sync(kFull, hs, j));
  }
  if (lane < kRuns) edges[9LL * row + lane] = edge;
  if (lane == 0) counts[row] = static_cast<long long>(rintf(acc));
}

template <bool kAdaptive, bool kWeighted>
int launch(const void* pts, const void* ids, const void* span,
           const void* mult, int n, int nv, int rcap, float eps, void* counts,
           void* edges, cudaStream_t stream) {
  dbscan_candidates<kAdaptive, kWeighted>
      <<<(n + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          static_cast<const float4*>(pts), static_cast<const long long*>(ids),
          static_cast<const long long*>(span),
          static_cast<const long long*>(mult), n, nv, rcap, eps,
          static_cast<long long*>(counts), static_cast<long long*>(edges));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. pts (n, 4) float32 (x, y, z, eps) of the
// points in sorted order, ids (n,) int64 sorted, span (3,) int64, mult (n,)
// int64 or null (unweighted), counts (n,) and edges (n, 9) int64: contiguous
// on one device; 1 <= n, 0 <= nv <= n, 1 <= rcap <= n. ``adaptive`` != 0
// takes the mutual radius min(eps_i, eps_j) from pts' fourth column, else
// ``eps``. Launches on ``stream`` and returns the cudaError_t of the launch.
extern "C" int icpflow_dbscan_candidates(const void* pts, const void* ids,
                                         const void* span, const void* mult,
                                         int n, int nv, int rcap, float eps,
                                         int adaptive, void* counts,
                                         void* edges, void* stream) {
  if (n < 1 || nv < 0 || nv > n || rcap < 1 || rcap > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adaptive) {
    return mult ? launch<true, true>(pts, ids, span, mult, n, nv, rcap, eps,
                                     counts, edges, s)
                : launch<true, false>(pts, ids, span, mult, n, nv, rcap, eps,
                                      counts, edges, s);
  }
  return mult ? launch<false, true>(pts, ids, span, mult, n, nv, rcap, eps,
                                    counts, edges, s)
              : launch<false, false>(pts, ids, span, mult, n, nv, rcap, eps,
                                     counts, edges, s);
}
