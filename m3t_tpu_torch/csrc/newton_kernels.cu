// Hopper kernel of the rigid cycle's Newton step, with a plain C interface (loaded through
// ctypes by m3t_tpu_torch/ops/_cuda.py, which links every csrc/*.cu into one library).
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC \
//        -o newton_kernels.o newton_kernels.cu
// The entry point launches on the caller's stream, never synchronizes, allocates nothing,
// and returns cudaGetLastError() (0 on success).
//
// ---------------------------------------------------------------------------------------
// newton_step  (replaces no Pallas kernel: the JAX package leaves the step,
//               m3t_tpu/pipeline.py::_solve_and_update, to XLA, which fuses it into the
//               jitted cycle; the port's plain step, ops/newton.py::newton_step_plain, is
//               some 236 elementwise kernels over the batch, each a node of the graph)
//   The Tikhonov-regularized Newton step of every body (optimizer.cpp:144-167, one link):
//     a     = -H + diag(rot, rot, rot, trans, trans, trans)
//     theta = a^-1 g by the unrolled LDLT of newton.py::_ldlt_solve_6x6, in its order
//     theta = 0 where any of its six entries is NaN
//     pose' = pose @ [[so3_exp(theta[:3]), theta[3:]], [0, 0, 0, 1]]
//   Bound on this card: bytes.  A body reads 232 B (g, H, pose) and writes 64 B with
//   about 600 flops: at B=512 152 KB, 0.05 us at 3.35 TB/s.  The kernel is launch-latency
//   bound by nature; its design is one thread per body that keeps the factorization in
//   registers, so a step is one graph node where the plain step is hundreds of launch
//   floors of about 1.3 us each.
//   Numerics: every product, sum and quotient rounds on its own, as the plain step's
//   kernels do (one PyTorch kernel per operation): __fmul_rn, __fadd_rn, __fsub_rn and
//   __fdiv_rn keep the compiler from contracting them into fused multiply-adds, which
//   COMPILE_FLAGS leave on.  sqrtf, sinf and cosf are the IEEE ones (no fast-math), as
//   PyTorch's sqrt, sin and cos kernels call them.  A division by a Python number in the
//   plain step (theta2 / 6.0, theta2 / 24.0) is, on a CUDA tensor, a product with the
//   float32 reciprocal, and so it is here.  Only the final pose @ variation differs in
//   its order: a chain of fused multiply-adds, where the plain step's batched matmul sums
//   in its own order (a few ulps in a pose entry).
// ---------------------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    newton_step_kernel(const float* __restrict__ gradient, const float* __restrict__ hessian,
                       const float* __restrict__ pose, float* __restrict__ out, int b,
                       float tikhonov_rotation, float tikhonov_translation) {
  const int body = blockIdx.x * blockDim.x + threadIdx.x;
  if (body >= b) return;
  const float* g = gradient + static_cast<size_t>(body) * 6;
  const float* h = hessian + static_cast<size_t>(body) * 36;
  const float* p = pose + static_cast<size_t>(body) * 16;

  // LDLT of a = -H + diag(...): only a's diagonal and lower triangle are read.
  // (-h + 0 as the plain step adds the diagonal matrix's zeros: +0 where h is +0.)
  float low[6][6];
  float diag[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = __fadd_rn(-h[j * 7], j < 3 ? tikhonov_rotation : tikhonov_translation);
#pragma unroll
    for (int k = 0; k < j; ++k) {
      s = __fsub_rn(s, __fmul_rn(__fmul_rn(low[j][k], low[j][k]), diag[k]));
    }
    diag[j] = s;
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = __fadd_rn(-h[i * 6 + j], 0.0f);
#pragma unroll
      for (int k = 0; k < j; ++k) {
        t = __fsub_rn(t, __fmul_rn(__fmul_rn(low[i][k], low[j][k]), diag[k]));
      }
      low[i][j] = __fdiv_rn(t, s);
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float t = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) t = __fsub_rn(t, __fmul_rn(low[i][k], y[k]));
    y[i] = t;
  }
  float x[6];
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float t = __fdiv_rn(y[i], diag[i]);
#pragma unroll
    for (int k = i + 1; k < 6; ++k) t = __fsub_rn(t, __fmul_rn(low[k][i], x[k]));
    x[i] = t;
  }
  bool any_nan = false;
#pragma unroll
  for (int i = 0; i < 6; ++i) any_nan |= isnan(x[i]);
  if (any_nan) {
#pragma unroll
    for (int i = 0; i < 6; ++i) x[i] = 0.0f;
  }

  // so3_exp(w) (common.py): Rodrigues' formula with its Taylor branch at w -> 0,
  // eye + s * skew(w) + c * (w w^T - theta2 * eye).
  const float w[3] = {x[0], x[1], x[2]};
  const float theta2 =
      __fadd_rn(__fadd_rn(__fmul_rn(w[0], w[0]), __fmul_rn(w[1], w[1])), __fmul_rn(w[2], w[2]));
  const bool small = theta2 < 1e-12f;
  const float safe_theta2 = small ? 1.0f : theta2;
  const float theta = sqrtf(safe_theta2);
  float s, c;
  if (small) {
    s = __fsub_rn(1.0f, __fmul_rn(theta2, 1.0f / 6.0f));
    c = __fsub_rn(0.5f, __fmul_rn(theta2, 1.0f / 24.0f));
  } else {
    s = __fdiv_rn(sinf(theta), theta);
    c = __fdiv_rn(__fsub_rn(1.0f, cosf(theta)), safe_theta2);
  }
  const float skew[3][3] = {{0.0f, -w[2], w[1]}, {w[2], 0.0f, -w[0]}, {-w[1], w[0], 0.0f}};
  // pose_from_rt: the variation [[R, t], [0, 0, 0, 1]].
  float v[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const float k2 = __fsub_rn(__fmul_rn(w[i], w[j]), __fmul_rn(theta2, eye));
      v[i][j] = __fadd_rn(__fadd_rn(eye, __fmul_rn(s, skew[i][j])), __fmul_rn(c, k2));
    }
    v[i][3] = x[3 + i];
    v[3][i] = 0.0f;
  }
  v[3][3] = 1.0f;

  // pose' = pose @ variation.
  float* o = out + static_cast<size_t>(body) * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = __fmul_rn(p[i * 4], v[0][j]);
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = fmaf(p[i * 4 + k], v[k][j], acc);
      o[i * 4 + j] = acc;
    }
  }
}

}  // namespace

extern "C" {

int m3t_newton_step(const void* gradient, const void* hessian, const void* pose, void* out,
                    int b, float tikhonov_rotation, float tikhonov_translation, void* stream) {
  newton_step_kernel<<<(b + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gradient), static_cast<const float*>(hessian),
      static_cast<const float*>(pose), static_cast<float*>(out), b, tikhonov_rotation,
      tikhonov_translation);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
