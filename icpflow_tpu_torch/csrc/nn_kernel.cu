// Masked batched nearest-neighbour sweep for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of icpflow_tpu/ops/pallas/nn_kernel.py:
//   _nn_kernel          (expanded form, index output)    -> <kExpanded,    false>
//   _nn_kernel_vpu      (elementwise form, index output)  -> <kElementwise, false>
//   _nn_kernel_pts      (both forms, points output)       -> <kExpanded | kElementwise, true>
//   _nn_kernel_vpu2     (sentinel form, index output)     -> <kSentinel,    false>
//   _nn_kernel_pts_vpu2 (sentinel form, points output)    -> <kSentinel,    true>
//
// For each src point x of batch row b: the nearest dst point y of row b and
// its squared distance in one of two forms,
//   expanded:    d2 = (|x|^2 - 2<x,y>) + |y|^2
//   elementwise: d2 = (y0-x0)^2 + (y1-x1)^2 + (y2-x2)^2
// The expanded and elementwise forms never choose an invalid dst: where no
// dst is valid, idx is 0, dist is sqrt(1e30) = 1e15 and the returned point is
// (0,0,0), as in the reference. The lowest index wins ties: dst is swept in
// index order and a candidate is taken only when it is strictly smaller.
//
// The sentinel form (the TPU's "vpu2") reads no mask in the sweep: invalid
// dst points are moved to (1e6, 1e6, 1e6) while dst is staged into shared
// memory and stay candidates, with their distance computed like any other.
// A src point with no valid dst gets the sentinel's elementwise distance
// (~1.73e6), idx 0 and the sentinel as its point. Ties: the index output
// takes the lowest index; the points output takes the candidate that
// minimises (d2, j mod 8, j div 8), the winner of the TPU kernel's 8-row
// running carry (its only tile height in use). The TPU wrapper's hazard
// of a carry height that does not divide the padded length (dst rows
// skipped) has no counterpart: every dst point is swept.
//
// An optional src mask marks src points whose result nobody reads: they get
// idx 0, dist 1e15 and the point (0,0,0) in every form and for either output,
// and a block (or, with dst split, every block and every rank of a cluster)
// that holds only such points leaves at once.
//
// Bound. Each candidate is counted as 9 FP32 lane-operations: 8 for the
// distance in either form and one to fold it into the running minimum (a
// group of 8 candidates takes 7 fminf and one compare with `best`; the index
// is resolved only when the group wins). The sentinel form's points output
// is counted as 10: its tie rule asks of a candidate whether it equals the
// minimum as well as whether it beats it. A candidate costs no device-memory
// traffic: dst is read once per block into shared memory, so bytes are
// O(B * (N + M * N / points per block)), far below the O(B * N * M)
// operations. The kernel is bound by the FP32 rate of the CUDA cores (33.5e12
// lane-operations a second: nothing here contracts into an FMA), counted on
// the pairs of a valid src
// and a valid dst: the masks the callers pass are prefixes of fixed-capacity
// buffers, the odometry's map at 5-20% of 262,144 points and its source at
// ~22% of 16,384, so a sweep over every slot does ~26 times the work its
// inputs need. Tensor cores offer nothing here: they have no full-fp32 mode
// (TF32 keeps about 3 digits, too few for metre-scale coordinates under a
// 0.1 m gate) and K=3 would pad to a depth of 8.
//
// Design, and what each part does about that bound.
// * Skip padding in dst. dst streams through shared memory in chunks of
//   kChunk points. While a chunk is staged the mask is folded into the
//   coordinates: an invalid dst becomes +inf (elementwise) or gets |y|^2 =
//   +inf (expanded), so its d2 is +inf and `d2 < best` is false; the inner
//   loop reads one float4 a candidate and no mask byte. A thread stages
//   kStage points of a chunk: first their mask bytes, then, after a barrier
//   that also takes the block-wide "any valid" (__syncthreads_or), their
//   coordinates, as independent loads that cost one latency. A chunk with
//   no valid dst is skipped after the mask; an atomic split sweep never
//   loads its coordinates (a one-pass sweep and a cluster's have started the
//   loads beside the mask's, to pay one latency a chunk instead of two).
//   The sentinel forms skip nothing: the sentinel stays a candidate.
// * Skip padding in src. A block whose src points are all masked out or out
//   of range leaves before the sweep. Every caller passes the mask it reads
//   the result under, so a half-empty cluster bucket costs half the blocks.
// * Split dst across blocks when B * N alone gives too few of them (the
//   odometry's sweep has B = 1). The grid's z axis holds S slices; slice z
//   takes chunks z, z + S, z + 2S, ... so that a valid prefix spreads evenly
//   over the slices. Each block merges its (d2, j) into a (B, N) 64-bit
//   scratch buffer with atomicMin on (bits of d2) << 32 | j: d2 >= +0 in the
//   elementwise and sentinel forms, so the bit pattern orders like the
//   value, and the minimum of (d2, j) is the lowest index on a tie whatever
//   order the blocks arrive in. The result is deterministic and equal to the
//   one-pass sweep bit for bit. A small finish kernel turns the keys into
//   idx and dist. The wrapper allocates and fills the scratch; only the
//   index output of the elementwise and sentinel forms can be split this way
//   (the expanded form's d2 can be slightly negative). It costs a scratch
//   fill and a finish pass, which only a long sweep earns back (more than
//   8,192 dst slots: the odometry's map).
// * Split dst over a thread-block cluster everywhere else: either output of
//   any form at the matcher's shapes (the ICP loop's sweep: B <= 14 rows of
//   1024 src points against 4096 dst slots is 56 blocks for 132
//   multiprocessors; its scoring sweeps: 7 rows of 4096 points are 224
//   blocks, 8 rows of a 512-point bucket 32; each thread walks every
//   candidate, so the time is the length of one thread's sweep). The launch
//   asks for clusters of S = 2, 4 or 8 blocks along the grid's z axis
//   (cudaLaunchKernelEx, cudaLaunchAttributeClusterDimension): the S blocks
//   of a cluster hold the same src points, run together on
//   neighbouring multiprocessors and can read each other's shared memory.
//   Rank z sweeps chunks z, z + S, ... as above. Then every thread leaves its
//   (best, best_j) in its block's shared memory, the cluster synchronises,
//   and rank 0 reads its partners' entries through distributed shared memory
//   (map_shared_rank), keeps the lexicographic minimum of (d2, order(j)) and
//   alone writes dist and the index (clamped to m - 1) or gathers the point;
//   a second cluster barrier keeps every block alive until its shared memory
//   has been read. One launch, no
//   scratch, no atomics, no finish pass, the same result whatever order the
//   blocks run in, and the launch can be captured into a CUDA graph.
//   (Writing into rank 0's shared memory instead, behind a barrier that
//   every rank arrives at as it starts, measured no faster.) The wrapper
//   gives a cluster's sweep shorter chunks than kChunk (a multiple of 8
//   points): a dst of one chunk is cut into S parts, one a rank, and a
//   longer dst into chunks of 256, because rank r of every cluster lands on
//   the same multiprocessors: where only a prefix of dst is valid, short
//   interleaved chunks keep every rank, and so every multiprocessor, at
//   work. The wrapper takes the smallest S that gives the card 4 blocks a
//   multiprocessor: a grid of clusters is placed less evenly than one of
//   single blocks (896 blocks as clusters of 4 or 8 measured 12% slower than
//   the same blocks launched without the cluster attribute and unmerged; 448
//   blocks the same either way), which is part of what the larger sweeps
//   stay short of their bound by.
//   Why the merge leaves what the one-pass sweep in index order leaves, bit
//   for bit. The d2 of a candidate does not depend on who computes it (the
//   same separately rounded operations), and d2 is compared as a float, so
//   the expanded form's slightly negative d2 is no obstacle.
//   - expanded and elementwise forms, and the sentinel form's index output,
//     order(j) = j: the one-pass sweep takes
//     a candidate only when it is strictly smaller, so it ends on the lowest
//     index among the candidates of minimal d2 below 1e30. A rank ends on
//     the lowest such index of its own chunks, or on (1e30, 0) where it found
//     nothing; the minimum of (d2, j) over the ranks is the lowest index of
//     the global minimum, and (1e30, 0) never beats a found candidate.
//   - sentinel form, points output, order(j) = (j mod 8, j div 8): the
//     one-pass sweep also takes an equal d2 with a lower j mod 8, and among
//     equal d2 and equal j mod 8 keeps the earlier, so it ends on the minimum
//     of (d2, j mod 8, j div 8). So does each rank over its chunks, and the
//     minimum of minima under one total order is the minimum of the union.
//     Here a higher index can win: j = 513 (j mod 8 = 1) beats j = 2.
//   - a NaN is never taken by a rank (`<` and fminf pass over it) nor by the
//     merge (`<` and `==` are false on it).
//   All ranks of a cluster hold the same src points, so "no wanted src
//   point" is the same decision in each: either all of them reach both
//   cluster barriers or none does, and rank 0 writes the defaults. A rank
//   whose chunks are all padding, or that has no chunk (S above the number
//   of chunks), arrives with (1e30, 0).
// * One src point per thread; a block covers kThreads consecutive src points
//   of one batch row. Every thread reads the same shared entry at the same
//   time (a broadcast, no bank conflicts). Two or four src points a thread
//   (one shared-memory read feeding several candidates) were measured twice,
//   the second time on the grids a cluster split fills: they gain 3-5% on
//   grids of 2,048 blocks and more, which no path of the port launches
//   (B <= 56 on its scenes), and tie or lose at every shape a path does
//   launch, which want the warps. They are not built.
// * No chain through `best`. Taking candidates one by one makes every
//   compare wait for the select before it, and on a small grid (one block a
//   multiprocessor) that chain is the kernel's time. Candidates go in
//   aligned groups of kGroup: their d2 are independent, a tree of fminf
//   gives the group's minimum, and only a group whose minimum beats `best`
//   looks for its index, the first occurrence of the minimum. That is what
//   the one-by-one sweep leaves behind, under strict `<` and under the
//   points form's (j mod 8) rule alike. fminf passes over a NaN, which
//   `<` never takes either; nothing carries a NaN forward.
// * The points output reads dst[b, best] once at the end instead of carrying
//   the TPU's one-hot select.
//
// Arithmetic. Every product and sum is rounded on its own (no FMA
// contraction), in the order the plain PyTorch version in ops/knn.py uses,
// so the two agree bit for bit and ties resolve the same way.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 512;          // a multiple of 8: t & 7 == j & 7
constexpr int kStage = kChunk / kThreads;   // dst points a thread stages
constexpr int kGroup = 8;            // candidates per fminf tree
static_assert((kGroup & (kGroup - 1)) == 0 && kGroup <= 8 &&
                  kChunk % kGroup == 0,
              "an aligned group lies inside one run of j mod 8");
constexpr float kBig = 1e30f;        // "none found": no candidate reaches it
constexpr float kSentinelCoord = 1e6f;

constexpr int kMaxCluster = 8;       // the portable cluster size limit

enum Form : int { kExpanded = 0, kElementwise = 1, kSentinel = 2 };
// How dst is swept: by one block; split over blocks that merge by atomicMin
// into a scratch buffer; or split over the blocks of one cluster that merge
// through distributed shared memory.
enum Mode : int { kOnePass = 0, kAtomic = 1, kCluster = 2 };

// (a0*b0 + a1*b1) + a2*b2, every product and sum rounded on its own (no
// FMA contraction): the plain PyTorch version computes the same sequence
// of separately rounded operations, so kernel and plain agree bit for bit.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// d2 of one candidate y = (y0, y1, y2, |y|^2) in the form's rounding order.
template <int kForm>
__device__ __forceinline__ float dist2(float x0, float x1, float x2, float xsq,
                                       const float4& y) {
  if (kForm == kExpanded) {
    const float cross = dot3(x0, x1, x2, y.x, y.y, y.z);
    return __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, cross)), y.w);
  }
  const float a = __fsub_rn(y.x, x0), c = __fsub_rn(y.y, x1),
              e = __fsub_rn(y.z, x2);
  return dot3(a, c, e, a, c, e);
}

// Take candidate t of the chunk at j0 if it beats (best, best_j): strictly
// smaller, or, in the sentinel form's points output, equal with a lower
// (j mod 8). kChunk is a multiple of 8, so t & 7 == j & 7.
template <int kForm, bool kPoints>
__device__ __forceinline__ void consider(float d2, int t, int j0, float& best,
                                         int& best_j) {
  bool take = d2 < best;
  if (kForm == kSentinel && kPoints) {
    take = take || (d2 == best && (t & 7) < (best_j & 7));
  }
  if (take) {
    best = d2;
    best_j = j0 + t;
  }
}

// Whether (d2, j) comes before (best, best_j) in the order the sweep leaves
// its result in: (d2, j), or (d2, j mod 8, j div 8) for the sentinel form's
// points output. d2 is compared as a float (it may be negative or -0).
template <int kForm, bool kPoints>
__device__ __forceinline__ bool before(float d2, int j, float best,
                                       int best_j) {
  if (d2 < best) return true;
  if (!(d2 == best)) return false;
  if (kForm == kSentinel && kPoints && (j & 7) != (best_j & 7)) {
    return (j & 7) < (best_j & 7);
  }
  return j < best_j;
}

// This thread's kStage points of a chunk of ``len`` dst points at ``y``.
__device__ __forceinline__ void load_chunk(const float* __restrict__ y, int len,
                                           float (&y0)[kStage],
                                           float (&y1)[kStage],
                                           float (&y2)[kStage]) {
#pragma unroll
  for (int u = 0; u < kStage; ++u) {
    const int t = min((int)threadIdx.x + u * kThreads, len - 1);
    y0[u] = y[t * 3 + 0];
    y1[u] = y[t * 3 + 1];
    y2[u] = y[t * 3 + 2];
  }
}

// (d2, j) as one integer that orders like (d2, j) for d2 >= +0.
__device__ __forceinline__ unsigned long long pack_key(float d2, int j) {
  return ((unsigned long long)__float_as_uint(d2) << 32) | (unsigned)j;
}

// kMode != kOnePass: the block sweeps only the chunks of its slice
// (blockIdx.z of gridDim.z). kAtomic merges into ``keys``, which the caller
// filled with pack_key(kBig, 0), and nn_finish_kernel writes the outputs;
// kCluster is launched with clusters of (1, 1, gridDim.z) blocks, whose rank
// 0 merges and writes the outputs.
template <int kForm, bool kPoints, int kMode>
__global__ void __launch_bounds__(kThreads)
masked_nn_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 const uint8_t* __restrict__ mask,
                 const uint8_t* __restrict__ src_mask, int n, int m,
                 int cluster_span, int32_t* __restrict__ idx_out,
                 float* __restrict__ pts_out, float* __restrict__ dist_out,
                 unsigned long long* __restrict__ keys) {
  static_assert(kMode != kAtomic || (!kPoints && kForm != kExpanded),
                "the atomic merge takes the index output of a form with "
                "d2 >= +0 only");
  constexpr bool kSplit = kMode != kOnePass;
  // the coordinates of a chunk are loaded beside its mask (one latency a
  // chunk) unless most chunks are expected to be padding
  constexpr bool kLoadEarly = kMode != kAtomic;
  __shared__ float4 ys[kChunk];      // (y0, y1, y2, |y|^2)

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < n;
  const size_t o = (size_t)b * n + (in ? i : 0);
  const bool wanted = in && (src_mask == nullptr || src_mask[o]);
  const float x0 = src[o * 3 + 0], x1 = src[o * 3 + 1], x2 = src[o * 3 + 2];
  const float xsq = dot3(x0, x1, x2, x0, x1, x2);
  float best = kBig;
  int best_j = 0;
  const float* d = dst + (size_t)b * m * 3;
  const uint8_t* mk = mask + (size_t)b * m;

  // a block with no wanted src point sweeps nothing
  const bool sweep = __syncthreads_or(wanted);
  // dst points a chunk: a cluster may cut a dst of one chunk into shorter
  // ones (a multiple of 8, so that t & 7 == j & 7 still holds), one a rank
  const int span = kMode == kCluster ? cluster_span : kChunk;
  const int chunks = sweep ? (m + span - 1) / span : 0;
  for (int c = kSplit ? blockIdx.z : 0; c < chunks;
       c += kSplit ? gridDim.z : 1) {
    const int j0 = c * span;
    const int len = min(span, m - j0);
    // stage 1: the chunk's mask, kStage independent byte loads a thread
    uint8_t v[kStage];
    bool any_valid = false;
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = threadIdx.x + u * kThreads;
      v[u] = t < len ? mk[j0 + t] : 0;
      any_valid |= v[u] != 0;
    }
    // stage 2: the coordinates, whatever the mask says: independent loads
    // that cost one latency. A one-pass sweep starts them before the
    // barrier, beside the mask's, and so does a cluster's; an atomic split
    // sweep, most of whose chunks are padding, after it, for the chunks
    // that stay.
    float y0[kStage], y1[kStage], y2[kStage];
    if (kLoadEarly) load_chunk(d + (size_t)j0 * 3, len, y0, y1, y2);
    // one barrier: the previous chunk is fully consumed, and "any valid"
    if (kForm == kSentinel) {
      __syncthreads();
    } else if (!__syncthreads_or(any_valid)) {
      continue;
    }
    if (!kLoadEarly) load_chunk(d + (size_t)j0 * 3, len, y0, y1, y2);
    // the mask is folded in: an invalid dst is the sentinel (a candidate
    // like any other) or lies at +inf (never taken)
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int t = threadIdx.x + u * kThreads;
      float4 yv;
      if (kForm == kSentinel) {
        yv = v[u] ? make_float4(y0[u], y1[u], y2[u], 0.0f)
                  : make_float4(kSentinelCoord, kSentinelCoord,
                                kSentinelCoord, 0.0f);
      } else if (kForm == kExpanded) {
        yv = v[u] ? make_float4(y0[u], y1[u], y2[u],
                                dot3(y0[u], y1[u], y2[u], y0[u], y1[u], y2[u]))
                  : make_float4(0.0f, 0.0f, 0.0f, CUDART_INF_F);
      } else {
        yv = v[u] ? make_float4(y0[u], y1[u], y2[u], 0.0f)
                  : make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                                0.0f);
      }
      if (t < len) ys[t] = yv;
    }
    __syncthreads();
    // groups of kGroup candidates: their d2 are independent, a tree of
    // fminf gives the group's minimum, and only a group that can change
    // the result looks for the index of that minimum
    // Two groups an iteration: the second group's shared-memory reads and
    // distances overlap the first's fminf tree, which pays on the small
    // grids (one block a multiprocessor) that the matcher launches.
    const int grouped = len - len % kGroup;
#pragma unroll 2
    for (int t = 0; t < grouped; t += kGroup) {
      float4 y[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) y[g] = ys[t + g];
      float dd[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        dd[g] = dist2<kForm>(x0, x1, x2, xsq, y[g]);
      }
      float lo[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) lo[g] = dd[g];
#pragma unroll
      for (int w = kGroup / 2; w >= 1; w /= 2) {
#pragma unroll
        for (int g = 0; g < w; ++g) lo[g] = fminf(lo[g], lo[g + w]);
      }
      // fminf passes over a NaN, which `<` never takes either
      constexpr bool kTies = kForm == kSentinel && kPoints;
      if (!(kTies ? lo[0] <= best : lo[0] < best)) continue;
      // the sweep in index order would leave the group's minimum at its
      // first occurrence: under strict `<`, and under the points form's
      // tie rule too, since j mod 8 grows with g inside an aligned group
      int first = kGroup - 1;
#pragma unroll
      for (int g = kGroup - 2; g >= 0; --g) {
        if (dd[g] == lo[0]) first = g;
      }
      if (kTies && lo[0] == best && ((t + first) & 7) >= (best_j & 7)) {
        continue;                    // the carry keeps the lower j mod 8
      }
      best = lo[0];
      best_j = j0 + t + first;
    }
    for (int t = grouped; t < len; ++t) {      // the ragged end of dst
      consider<kForm, kPoints>(dist2<kForm>(x0, x1, x2, xsq, ys[t]), t, j0,
                               best, best_j);
    }
  }

  if constexpr (kMode == kCluster) {
    // ``sweep`` is the same in every rank of a cluster (the same src
    // points): all of them take both cluster barriers or none does
    cooperative_groups::cluster_group cluster =
        cooperative_groups::this_cluster();
    const unsigned rank = cluster.block_rank();
    if (sweep) {
      __shared__ int2 mine[kThreads];          // (bits of best, best_j)
      if (rank != 0) {
        mine[threadIdx.x] = make_int2(__float_as_int(best), best_j);
      }
      cluster.sync();          // every rank's entries are written
      if (rank == 0) {
        const unsigned ranks = cluster.num_blocks();
        int2 theirs[kMaxCluster - 1];
#pragma unroll
        for (unsigned r = 1; r < kMaxCluster; ++r) {   // independent loads
          theirs[r - 1] = r < ranks
                              ? cluster.map_shared_rank(mine, r)[threadIdx.x]
                              : make_int2(__float_as_int(kBig), 0);
        }
#pragma unroll
        for (unsigned r = 1; r < kMaxCluster; ++r) {   // (kBig, 0): never
          const float d2 = __int_as_float(theirs[r - 1].x);
          if (before<kForm, kPoints>(d2, theirs[r - 1].y, best, best_j)) {
            best = d2;
            best_j = theirs[r - 1].y;
          }
        }
      }
      cluster.sync();          // nobody leaves before its entries were read
    }
    if (rank != 0) return;
  }
  if (!in) return;
  const bool found = wanted && best < kBig;
  if (kMode == kAtomic) {
    if (found) atomicMin(&keys[o], pack_key(best, best_j));
    return;
  }
  const int j = found ? best_j : 0;
  dist_out[o] = sqrtf(fmaxf(found ? best : kBig, 0.0f));
  if (kPoints) {
    float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
    if (found) {
      const float* y = d + (size_t)j * 3;
      const bool v = kForm != kSentinel || mk[j];
      p0 = v ? y[0] : kSentinelCoord;
      p1 = v ? y[1] : kSentinelCoord;
      p2 = v ? y[2] : kSentinelCoord;
    }
    pts_out[o * 3 + 0] = p0;
    pts_out[o * 3 + 1] = p1;
    pts_out[o * 3 + 2] = p2;
  } else {
    idx_out[o] = min(j, m - 1);
  }
}

// The second pass of an atomic split sweep: keys -> idx, dist. A key nobody lowered
// is pack_key(kBig, 0): idx 0, dist 1e15.
__global__ void nn_finish_kernel(const unsigned long long* __restrict__ keys,
                                 int total, int m, int32_t* __restrict__ idx_out,
                                 float* __restrict__ dist_out) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= total) return;
  const unsigned long long key = keys[o];
  const float best = __uint_as_float((unsigned)(key >> 32));
  dist_out[o] = sqrtf(fmaxf(best, 0.0f));
  idx_out[o] = min((int)(unsigned)(key & 0xffffffffu), m - 1);
}

struct Args {
  const float* src;
  const float* dst;
  const uint8_t* mask;
  const uint8_t* src_mask;
  int b, n, m, points, mode, slices, span;
  int32_t* idx;
  float* pts;
  float* dist;
  unsigned long long* keys;
  cudaStream_t stream;
};

// An empty kernel: what any launch costs (see icpflow_launch_floor).
__global__ void empty_kernel() {}

template <int kForm, bool kPoints, int kMode>
cudaError_t launch_as(const Args& a) {
  const dim3 grid((a.n + kThreads - 1) / kThreads, a.b, a.slices);
  if constexpr (kMode == kCluster) {
    // one cluster of ``slices`` blocks per kThreads src points of a row
    if (a.slices > kMaxCluster || a.span < 8 || a.span > kChunk ||
        a.span % 8 != 0) {
      return cudaErrorInvalidValue;
    }
    cudaLaunchConfig_t config = {};
    config.gridDim = grid;
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = 0;
    config.stream = a.stream;
    cudaLaunchAttribute attribute;
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = 1;
    attribute.val.clusterDim.y = 1;
    attribute.val.clusterDim.z = a.slices;
    config.attrs = &attribute;
    config.numAttrs = 1;
    return cudaLaunchKernelEx(
        &config, masked_nn_kernel<kForm, kPoints, kCluster>, a.src, a.dst,
        a.mask, a.src_mask, a.n, a.m, a.span, a.idx, a.pts, a.dist,
        static_cast<unsigned long long*>(nullptr));
  } else {
    if (kMode == kAtomic && a.keys == nullptr) return cudaErrorInvalidValue;
    masked_nn_kernel<kForm, kPoints, kMode><<<grid, kThreads, 0, a.stream>>>(
        a.src, a.dst, a.mask, a.src_mask, a.n, a.m, kChunk, a.idx, a.pts,
        a.dist, kMode == kAtomic ? a.keys : nullptr);
    cudaError_t err = cudaGetLastError();
    if (kMode != kAtomic || err != cudaSuccess) return err;
    const int total = a.b * a.n;
    nn_finish_kernel<<<(total + 255) / 256, 256, 0, a.stream>>>(
        a.keys, total, a.m, a.idx, a.dist);
    return cudaGetLastError();
  }
}

// The instantiations a launch can reach: either output of any form in one
// pass or over a cluster and, where d2 >= +0, the index output over an atomic
// split.
template <int kForm, bool kPoints>
cudaError_t launch_output(const Args& a) {
  if (a.mode == kOnePass) return launch_as<kForm, kPoints, kOnePass>(a);
  if (a.mode == kCluster) return launch_as<kForm, kPoints, kCluster>(a);
  // the expanded form's d2 can be negative: its bits do not order
  if constexpr (!kPoints && kForm != kExpanded) {
    return launch_as<kForm, false, kAtomic>(a);
  }
  return cudaErrorInvalidValue;
}

template <int kForm>
cudaError_t launch_form(const Args& a) {
  return a.points ? launch_output<kForm, true>(a)
                  : launch_output<kForm, false>(a);
}

}  // namespace

// Plain C entry point for ctypes. ``form`` is 0 (expanded), 1 (elementwise)
// or 2 (sentinel). ``out`` is the (B,N) int32 index buffer when points == 0,
// else the (B,N,3) float32 points buffer. ``src_mask`` is a (B,N) byte mask
// or null (every src point wanted). ``split`` says how dst is swept: 0, by
// one block (``slices`` == 1); 1, over ``slices`` > 1 blocks merged by
// atomicMin, for the index output of the elementwise and sentinel forms
// only, and ``keys`` is then a (B,N) 64-bit buffer filled with the bits of
// 1e30f in the upper half and 0 in the lower; 2, over a thread-block cluster
// of ``slices`` = 2..8 blocks in chunks of ``span`` dst points (a multiple of
// 8, at most 512; read by this split only), for either output of any form,
// with no ``keys``. Returns the cudaError_t of the launch (0 on success;
// cudaErrorInvalidValue for an unknown form or a combination that has no
// instantiation).
extern "C" int icpflow_masked_nn(const void* src, const void* dst,
                                 const void* mask, const void* src_mask,
                                 int b, int n, int m, int form, int points,
                                 int split, int slices, int span, void* out,
                                 void* dist, void* keys, void* stream) {
  const bool known = split == kOnePass || split == kAtomic || split == kCluster;
  if (!known || slices < 1 || slices > 65535 ||
      (split == kOnePass) != (slices == 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.src = static_cast<const float*>(src);
  a.dst = static_cast<const float*>(dst);
  a.mask = static_cast<const uint8_t*>(mask);
  a.src_mask = static_cast<const uint8_t*>(src_mask);
  a.b = b;
  a.n = n;
  a.m = m;
  a.points = points;
  a.mode = split;
  a.slices = slices;
  a.span = span;
  a.idx = points ? nullptr : static_cast<int32_t*>(out);
  a.pts = points ? static_cast<float*>(out) : nullptr;
  a.dist = static_cast<float*>(dist);
  a.keys = static_cast<unsigned long long*>(keys);
  a.stream = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kExpanded: return static_cast<int>(launch_form<kExpanded>(a));
    case kElementwise: return static_cast<int>(launch_form<kElementwise>(a));
    case kSentinel: return static_cast<int>(launch_form<kSentinel>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches an empty kernel of one thread on ``stream``: the least any launch
// costs on this card, to read the sweeps of tiny inputs against. Returns the
// cudaError_t of the launch.
extern "C" int icpflow_launch_floor(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
