// Hopper kernel of the depth modality, with a plain C interface (loaded through ctypes by
// m3t_tpu_torch/ops/_cuda.py, which links every csrc/*.cu into one library).  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC \
//        -o depth_kernels.o depth_kernels.cu
// The entry point launches on the caller's stream, never synchronizes, allocates
// nothing, and returns cudaGetLastError() (0 on success).
//
// ---------------------------------------------------------------------------------------
// sample_windows  (replaces the Pallas kernel m3t_tpu/ops/depth_fast.py::sample_windows,
//                  pallas_call at :98, body _window_kernel :44)
//   out[b, k, l] = crop[b][r][col],
//   r   = clamp(int(row_l), 0, C-1)                       (fixed crop row of line l)
//   col = clamp(int(u0_l + stride_l * k), 0, C-1)         (k-th strided sample along u)
//   Every (model point, window row) pair is one line l; the depth modality's
//   correspondence-search and measured-occlusion windows are K samples of K such lines.
//   Bound on this card: bytes.  At the flagship shapes (B=512, C=256, LP=2304 and
//   kp=16 for the widest window) one call writes 75.5 MB of output and reads 14.2 MB of
//   params (rows U0, ROW and STRIDE; row 3 is padding that nothing reads) plus the
//   crop words the windows touch; one float multiply-add, two clamps
//   and a load per output element are far below the H100's rates.  Design: the TPU
//   version needed two composed lane gathers over 128-lane stripes and a transposed
//   crop because Mosaic gathers only within a vreg; here one thread computes one
//   output element with l fastest, so param loads and output stores coalesce, and the
//   crop is read directly from global memory (a 256x256 int32 crop is 256 KB, more
//   than a block's shared memory).  The threads of a warp read up to 32 neighbouring
//   window samples of one or a few rows, which the L1/L2 caches serve.
//   Numerics: the column is __fadd_rn(u0, __fmul_rn(stride, k)), so nvcc cannot
//   contract it into an FMA, and values are clamped in float before the conversion to
//   int (NaN -> 0), as the plain PyTorch twin does.  The inputs are integer-valued f32,
//   so the result equals the twin's exactly.
// ---------------------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowU0 = 0;
constexpr int kRowRow = 1;
constexpr int kRowStride = 2;
constexpr int kNParam = 4;

constexpr int kLinesPerBlock = 128;
constexpr int kStepRowsPerBlock = 4;

// Clamp to [0, hi] in float (NaN -> 0: fmaxf returns the non-NaN operand), then truncate.
__device__ __forceinline__ int clamp_to_index(float x, int hi) {
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(hi));
  return static_cast<int>(x);
}

__global__ void sample_windows_kernel(const float* __restrict__ params,
                                      const int32_t* __restrict__ crop,
                                      int32_t* __restrict__ out, int lp, int kp, int c) {
  const int b = blockIdx.y;
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lp) return;

  const float* p = params + static_cast<size_t>(b) * kNParam * lp + l;
  const float u0 = p[kRowU0 * lp];
  const float stride = p[kRowStride * lp];
  const int r = clamp_to_index(p[kRowRow * lp], c - 1);
  const int32_t* row = crop + (static_cast<size_t>(b) * c + r) * c;

  for (int k = threadIdx.y; k < kp; k += blockDim.y) {
    const int col =
        clamp_to_index(__fadd_rn(u0, __fmul_rn(stride, static_cast<float>(k))), c - 1);
    out[(static_cast<size_t>(b) * kp + k) * lp + l] = row[col];
  }
}

}  // namespace

extern "C" {

int m3t_sample_windows(const void* params, const void* crop, void* out, int b, int lp,
                       int kp, int c, void* stream) {
  const dim3 block(kLinesPerBlock, kStepRowsPerBlock);
  const dim3 grid((lp + kLinesPerBlock - 1) / kLinesPerBlock, b);
  sample_windows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(params), static_cast<const int32_t*>(crop),
      static_cast<int32_t*>(out), lp, kp, c);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
