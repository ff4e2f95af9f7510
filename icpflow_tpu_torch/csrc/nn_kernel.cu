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
// (0,0,0), as in the reference. The lowest index wins ties: each thread
// sweeps dst in index order and takes a candidate only when it is strictly
// smaller.
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
// Design. One thread owns one src point; a block of kThreads threads covers
// kThreads consecutive src points of one batch row, grid (ceil(N/kThreads),
// B). dst (with |y|^2 and the mask, or with the sentinel folded in) streams
// through shared memory in chunks of kChunk points; every thread reads the
// same shared entry at the same time (a broadcast, no bank conflicts). The
// points output reads dst[b, best] once at the end instead of carrying the
// TPU's one-hot select.
//
// Arithmetic. Every product and sum is rounded on its own (no FMA
// contraction), in the order the plain PyTorch version in ops/knn.py uses,
// so the two agree bit for bit and ties resolve the same way.
//
// Bound. Each candidate costs about 11 FP32 operations (8 for the distance
// in either form, a compare and 2 selects; the sentinel form drops the mask
// test and its points output adds a tie compare) and no device-memory
// traffic: dst is read once per block, so bytes are O(B * (N + M * N /
// kThreads)), small beside the O(B * N * M) operations. The kernel is bound
// by FP32 issue on the CUDA cores. Tensor cores offer nothing here: they
// have no full-fp32 mode (TF32 keeps about 3 digits, too few for metre-scale
// coordinates under a 0.1 m gate) and K=3 would pad to a depth of 8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;         // a multiple of 8: t & 7 == j & 7
constexpr float kBig = 1e30f;
constexpr float kSentinelCoord = 1e6f;

enum Form : int { kExpanded = 0, kElementwise = 1, kSentinel = 2 };

// (a0*b0 + a1*b1) + a2*b2, every product and sum rounded on its own (no
// FMA contraction): the plain PyTorch version computes the same sequence
// of separately rounded operations, so kernel and plain agree bit for bit.
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

template <int kForm, bool kPoints>
__global__ void __launch_bounds__(kThreads)
masked_nn_kernel(const float* __restrict__ src, const float* __restrict__ dst,
                 const uint8_t* __restrict__ mask, int n, int m,
                 int32_t* __restrict__ idx_out, float* __restrict__ pts_out,
                 float* __restrict__ dist_out) {
  __shared__ float4 ys[kChunk];      // (y0, y1, y2, |y|^2)
  __shared__ uint8_t ok[kChunk];

  const int b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float* s = src + ((size_t)b * n + (live ? i : 0)) * 3;
  const float x0 = s[0], x1 = s[1], x2 = s[2];
  const float xsq = dot3(x0, x1, x2, x0, x1, x2);
  const float* d = dst + (size_t)b * m * 3;
  const uint8_t* mk = mask + (size_t)b * m;

  float best = kBig;
  int best_j = 0;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    const int len = min(kChunk, m - j0);
    __syncthreads();                 // previous chunk fully consumed
    for (int t = threadIdx.x; t < len; t += kThreads) {
      const float* y = d + (size_t)(j0 + t) * 3;
      if (kForm == kSentinel) {      // fold the mask into the coordinates
        ys[t] = mk[j0 + t] ? make_float4(y[0], y[1], y[2], 0.0f)
                           : make_float4(kSentinelCoord, kSentinelCoord,
                                         kSentinelCoord, 0.0f);
      } else {
        const float y0 = y[0], y1 = y[1], y2 = y[2];
        ys[t] = make_float4(y0, y1, y2, dot3(y0, y1, y2, y0, y1, y2));
        ok[t] = mk[j0 + t];
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < len; ++t) {
      const float4 y = ys[t];
      float d2;
      if (kForm == kExpanded) {
        const float cross = dot3(x0, x1, x2, y.x, y.y, y.z);
        d2 = __fadd_rn(__fsub_rn(xsq, __fmul_rn(2.0f, cross)), y.w);
      } else {
        const float a = __fsub_rn(y.x, x0), c = __fsub_rn(y.y, x1),
                    e = __fsub_rn(y.z, x2);
        d2 = dot3(a, c, e, a, c, e);
      }
      bool take;
      if (kForm != kSentinel) {
        take = ok[t] && d2 < best;
      } else if (kPoints) {          // ties: lowest (j mod 8), then lowest j
        take = d2 < best || (d2 == best && (t & 7) < (best_j & 7));
      } else {
        take = d2 < best;
      }
      if (take) {
        best = d2;
        best_j = j0 + t;
      }
    }
  }
  if (!live) return;

  const size_t o = (size_t)b * n + i;
  dist_out[o] = sqrtf(fmaxf(best, 0.0f));
  if (kPoints) {
    const float* y = d + (size_t)best_j * 3;
    float p0, p1, p2;
    if (kForm == kSentinel) {
      const bool v = mk[best_j];
      p0 = v ? y[0] : kSentinelCoord;
      p1 = v ? y[1] : kSentinelCoord;
      p2 = v ? y[2] : kSentinelCoord;
    } else {
      const bool found = best < kBig;
      p0 = found ? y[0] : 0.0f;
      p1 = found ? y[1] : 0.0f;
      p2 = found ? y[2] : 0.0f;
    }
    pts_out[o * 3 + 0] = p0;
    pts_out[o * 3 + 1] = p1;
    pts_out[o * 3 + 2] = p2;
  } else {
    idx_out[o] = min(best_j, m - 1);
  }
}

template <int kForm, bool kPoints>
void launch(const float* src, const float* dst, const uint8_t* mask, int b,
            int n, int m, int32_t* idx, float* pts, float* dist,
            cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  masked_nn_kernel<kForm, kPoints>
      <<<grid, kThreads, 0, stream>>>(src, dst, mask, n, m, idx, pts, dist);
}

template <int kForm>
void launch_form(const float* src, const float* dst, const uint8_t* mask,
                 int b, int n, int m, int points, int32_t* idx, float* pts,
                 float* dist, cudaStream_t stream) {
  if (points) launch<kForm, true>(src, dst, mask, b, n, m, idx, pts, dist, stream);
  else        launch<kForm, false>(src, dst, mask, b, n, m, idx, pts, dist, stream);
}

}  // namespace

// Plain C entry point for ctypes. ``form`` is 0 (expanded), 1 (elementwise)
// or 2 (sentinel). ``out`` is the (B,N) int32 index buffer when points == 0,
// else the (B,N,3) float32 points buffer. Returns the cudaError_t of the
// launch (0 on success; cudaErrorInvalidValue for an unknown form).
extern "C" int icpflow_masked_nn(const void* src, const void* dst,
                                 const void* mask, int b, int n, int m,
                                 int form, int points, void* out,
                                 void* dist, void* stream) {
  const float* s = static_cast<const float*>(src);
  const float* d = static_cast<const float*>(dst);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  float* dd = static_cast<float*>(dist);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* idx = points ? nullptr : static_cast<int32_t*>(out);
  float* pts = points ? static_cast<float*>(out) : nullptr;
  switch (form) {
    case kExpanded:
      launch_form<kExpanded>(s, d, mk, b, n, m, points, idx, pts, dd, st);
      break;
    case kElementwise:
      launch_form<kElementwise>(s, d, mk, b, n, m, points, idx, pts, dd, st);
      break;
    case kSentinel:
      launch_form<kSentinel>(s, d, mk, b, n, m, points, idx, pts, dd, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
