// Kabsch's 3x3 solve for Hopper (sm_90a): from the weighted covariance H
// (B,3,3) of a batch of correspondences and its weight total, the two
// factors whose product is the rotation, R = Vp Up^T.
//
// The middle of ops/geometry.py: kabsch, whose plain version is
// _kabsch_solve_plain there: a one-sided Jacobi SVD (6 sweeps of 3 column
// rotations, a 3-comparator sort network), then the reflection fix folded
// into the factors (the two leading left columns re-orthonormalised, the
// third columns of both completed by cross products) and the degenerate
// test. The kernel writes Vp and Up, and for a degenerate row the identity
// twice, so that R = Vp Up^T is the identity there as the plain version's
// fallback makes it (each entry of I I^T is a sum of products 1 * 1 and
// 0 * 0 and so exact, in any order). The two 3x3 products, R = Vp Up^T and
// t = mu_d - R mu_s, and t's finite guard stay in PyTorch on both paths:
// cuBLAS computes them, and on the card the order in which it rounds them
// changes with the batch size (R = Vp Up^T is an FMA chain over j = 0, 1, 2
// at B >= 2 but separately rounded at B = 1; R mu_s matches neither from
// B = 5 on), so no one order in a kernel would match it everywhere.
//
// Replaces no Pallas kernel: icpflow_tpu/ops/geometry.py: kabsch is plain
// jnp, which XLA fuses. In eager PyTorch the same work is ~1,250 launches
// of elementwise and reduction kernels on (B,3)- and (B,3,3)-sized tensors
// and two synchronizing host copies a call, for B of one (the odometry) to
// a few hundred rows (the ICP buckets): ~2,000 FP32 operations a row. So on
// this card it is bound by launches, not by operations or bytes: the least
// it can take is one launch. This kernel is that launch: one thread a row,
// 128 threads a block, every intermediate in registers (W, V and S: 9 + 9 +
// 3 floats), nothing in shared memory, one read of H and the total and one
// write of Vp and Up.
//
// Bit-equality. The kernel repeats the plain version's operations one by
// one, in its order, each rounded as the PyTorch CUDA kernel that runs it
// rounds it, so the two agree bit for bit and no ICP stall test, gate or
// rollback downstream can tell them apart:
// * every elementwise operation is one explicit round-to-nearest intrinsic
//   (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), so nvcc
//   contracts nothing into an FMA on its own; a Python scalar operand is the
//   float that PyTorch converts it to (static_cast<float> of the double);
// * 1.0 / x is PyTorch's x.reciprocal() * 1.0 (Tensor.__rdiv__);
// * torch.sign is (0 < x) - (x < 0), so sign(+-0) = sign(NaN) = +0;
//   clamp(min=) passes a NaN through and is fmaxf otherwise;
// * torch.sum over a dim of 3 starts from +0 and adds in the order of
//   PyTorch's reduction kernel: (x0 + x2) + x1 over the innermost dim of a
//   (B,3), whose three entries two threads share; (x0 + x1) + x2 over the
//   middle dim of a (B,3,3), which one thread walks;
// * torch.linalg.cross's kernel computes a*b - c*d as fma(a, b, -(c*d)).
// The card showed each of these against PyTorch on 10^5 random rows, and
// every other order or contraction of them to differ from the plain
// version; chip_smoke.py ([kabsch]) and the GPU case of
// tests/test_torch_kabsch_kernel.py hold the kernel to the plain version
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSweeps = 6;
// the plain version's Python constants as PyTorch hands them to its kernels
constexpr float kEps = static_cast<float>(1e-9);      // geometry._EPS
constexpr float kTinyNorm = static_cast<float>(1e-6);
constexpr float kTinyS = static_cast<float>(1e-12);

// torch.sum(x, dim=1) of a (B,3): the innermost dim
__device__ __forceinline__ float sum_row(float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(x0, x2), x1), 0.0f);   // never -0
}

// torch.sum(x, dim=1) of a (B,3,3): the middle dim
__device__ __forceinline__ float sum_col(float x0, float x1, float x2) {
  return __fadd_rn(__fadd_rn(__fadd_rn(x0, x1), x2), 0.0f);
}

// torch.linalg.cross(x, y)
__device__ __forceinline__ void cross3(const float* x, const float* y,
                                       float* out) {
  out[0] = __fmaf_rn(x[1], y[2], -__fmul_rn(x[2], y[1]));
  out[1] = __fmaf_rn(x[2], y[0], -__fmul_rn(x[0], y[2]));
  out[2] = __fmaf_rn(x[0], y[1], -__fmul_rn(x[1], y[0]));
}

__device__ __forceinline__ float sign(float x) {
  return static_cast<float>((0.0f < x) - (x < 0.0f));
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float rsqrt_div(float x) {   // 1.0 / sqrt(x)
  return __fmul_rn(__fdiv_rn(1.0f, __fsqrt_rn(x)), 1.0f);
}

__device__ __forceinline__ float norm3(const float* x) {
  return __fsqrt_rn(sum_row(__fmul_rn(x[0], x[0]), __fmul_rn(x[1], x[1]),
                            __fmul_rn(x[2], x[2])));
}

// One Jacobi rotation of columns p and q of W (and V), m[i][j] = m[3i + j].
__device__ __forceinline__ void rotate(float* W, float* V, int p, int q) {
  const float wp[3] = {W[p], W[3 + p], W[6 + p]};
  const float wq[3] = {W[q], W[3 + q], W[6 + q]};
  const float a = sum_row(__fmul_rn(wp[0], wp[0]), __fmul_rn(wp[1], wp[1]),
                          __fmul_rn(wp[2], wp[2]));
  const float b = sum_row(__fmul_rn(wq[0], wq[0]), __fmul_rn(wq[1], wq[1]),
                          __fmul_rn(wq[2], wq[2]));
  const float c = sum_row(__fmul_rn(wp[0], wq[0]), __fmul_rn(wp[1], wq[1]),
                          __fmul_rn(wp[2], wq[2]));
  const bool small =
      fabsf(c) <= __fmul_rn(kEps, __fsqrt_rn(__fadd_rn(__fmul_rn(a, b), kEps)));
  const float tau =
      __fdiv_rn(__fsub_rn(b, a), __fmul_rn(2.0f, small ? 1.0f : c));
  const float root = __fsqrt_rn(__fadd_rn(__fmul_rn(tau, tau), 1.0f));
  float t = __fdiv_rn(sign(tau), __fadd_rn(fabsf(tau), root));
  t = small ? 0.0f : t;
  const float cs = rsqrt_div(__fadd_rn(__fmul_rn(t, t), 1.0f));
  const float sn = __fmul_rn(cs, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    W[3 * i + p] = __fsub_rn(__fmul_rn(cs, wp[i]), __fmul_rn(sn, wq[i]));
    W[3 * i + q] = __fadd_rn(__fmul_rn(sn, wp[i]), __fmul_rn(cs, wq[i]));
  }
  const float vp[3] = {V[p], V[3 + p], V[6 + p]};
  const float vq[3] = {V[q], V[3 + q], V[6 + q]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    V[3 * i + p] = __fsub_rn(__fmul_rn(cs, vp[i]), __fmul_rn(sn, vq[i]));
    V[3 * i + q] = __fadd_rn(__fmul_rn(sn, vp[i]), __fmul_rn(cs, vq[i]));
  }
}

// The sort network's comparator: S[p] >= S[q] after it.
__device__ __forceinline__ void order(float* W, float* V, float* S, int p,
                                      int q) {
  if (!(S[q] > S[p])) return;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float x = W[3 * i + p];
    W[3 * i + p] = W[3 * i + q];
    W[3 * i + q] = x;
    x = V[3 * i + p];
    V[3 * i + p] = V[3 * i + q];
    V[3 * i + q] = x;
  }
  const float x = S[p];
  S[p] = S[q];
  S[q] = x;
}

__global__ void __launch_bounds__(kThreads)
kabsch_solve(const float* __restrict__ H, const float* __restrict__ total,
             int b, float* __restrict__ Vp, float* __restrict__ Up) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= b) return;
  float W[9], V[9], S[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    W[k] = H[9 * row + k];
    V[k] = (k % 4 == 0) ? 1.0f : 0.0f;
  }
#pragma unroll 1
  for (int sweep = 0; sweep < kSweeps; ++sweep) {
    rotate(W, V, 0, 1);
    rotate(W, V, 0, 2);
    rotate(W, V, 1, 2);
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    S[j] = __fsqrt_rn(sum_col(__fmul_rn(W[j], W[j]),
                              __fmul_rn(W[3 + j], W[3 + j]),
                              __fmul_rn(W[6 + j], W[6 + j])));
  }
  order(W, V, S, 0, 1);
  order(W, V, S, 1, 2);
  order(W, V, S, 0, 1);

  // U = W / clamp(S): only its first two columns are read
  float u1[3], u2[3], u3[3];
  const float s0 = clamp_min(S[0], kEps), s1 = clamp_min(S[1], kEps);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u1[i] = __fdiv_rn(W[3 * i], s0);
    u2[i] = __fdiv_rn(W[3 * i + 1], s1);
  }
  const float n1 = norm3(u1);
  const float n1c = clamp_min(n1, kEps);
#pragma unroll
  for (int i = 0; i < 3; ++i) u1[i] = __fdiv_rn(u1[i], n1c);
  const float d = sum_row(__fmul_rn(u2[0], u1[0]), __fmul_rn(u2[1], u1[1]),
                          __fmul_rn(u2[2], u1[2]));
#pragma unroll
  for (int i = 0; i < 3; ++i) u2[i] = __fsub_rn(u2[i], __fmul_rn(d, u1[i]));
  const float n2 = norm3(u2);
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ez[3] = {0.0f, 0.0f, 1.0f};
  float alt[3], alt2[3];
  cross3(u1, ex, alt);
  cross3(u1, ez, alt2);
  if (!(norm3(alt) >= norm3(alt2))) {
#pragma unroll
    for (int i = 0; i < 3; ++i) alt[i] = alt2[i];
  }
  if (n2 > kTinyNorm) {
    const float n2c = clamp_min(n2, kEps);
#pragma unroll
    for (int i = 0; i < 3; ++i) u2[i] = __fdiv_rn(u2[i], n2c);
  } else {
    const float na = clamp_min(norm3(alt), kEps);
#pragma unroll
    for (int i = 0; i < 3; ++i) u2[i] = __fdiv_rn(alt[i], na);
  }
  cross3(u1, u2, u3);
  const float v1[3] = {V[0], V[3], V[6]}, v2[3] = {V[1], V[4], V[7]};
  float v3[3];
  cross3(v1, v2, v3);

  const bool degenerate =
      total[row] < 1.0f ||
      !(isfinite(S[0]) && isfinite(S[1]) && isfinite(S[2])) ||
      S[0] <= kTinyS || n1 <= kTinyNorm;
  // Vp = [v1 v2 v3], Up = [u1 u2 u3] (columns); the identity if degenerate
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float v[3] = {v1[i], v2[i], v3[i]}, u[3] = {u1[i], u2[i], u3[i]};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.0f : 0.0f;
      Vp[9 * row + 3 * i + j] = degenerate ? e : v[j];
      Up[9 * row + 3 * i + j] = degenerate ? e : u[j];
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. H (b,3,3), total (b,), Vp and Up (b,3,3):
// contiguous float32 on one device; b >= 1. Launches on ``stream`` and
// returns the cudaError_t of the launch.
extern "C" int icpflow_kabsch_solve(const void* H, const void* total, int b,
                                    void* Vp, void* Up, void* stream) {
  if (b < 1) return static_cast<int>(cudaErrorInvalidValue);
  kabsch_solve<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H), static_cast<const float*>(total), b,
      static_cast<float*>(Vp), static_cast<float*>(Up));
  return static_cast<int>(cudaGetLastError());
}
