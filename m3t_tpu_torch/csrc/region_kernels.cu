// Hopper kernels of the region tracking cycle, with a plain C interface (loaded through
// ctypes by m3t_tpu_torch/ops/_cuda.py, which links every csrc/*.cu into one library).
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC \
//        -o region_kernels.o region_kernels.cu
// Every entry point launches on the caller's stream, never synchronizes, allocates
// nothing, and returns cudaGetLastError() (0 on success).
//
// ---------------------------------------------------------------------------------------
// sample_lines  (replaces the Pallas kernel m3t_tpu/ops/region_fast.py::sample_lines,
//                pallas_call at :232, body _sample_kernel :182 / _staircase_bins :116 /
//                _table_lookup :166)
//   out[b, k, l] = crop[b][col][i] (u-dominant line) or crop[b][i][col] (v-dominant),
//   i   = clamp(int(r0 + dir*k), 0, C-1)                       (dominant axis)
//   col = clamp(int(floor(s0 + (i - r0) * (step*dir))), 0, C-1) (secondary axis at row i)
//   and in "ratio" mode the value table[b, bin] instead of the bin.
//   Bound on this card: bytes.  At the flagship shape (B=512, LP=256, kp=120, C=256) the
//   output is 63 MB, the gathered crop words at most as much again, the tables 8 MB and
//   the params 4 MB; a few integer/float operations per output element are far below
//   the H100's rates.  What holds it back in practice is the crop gather: the 32 lanes
//   of a warp read 32 different lines, so each gather instruction asks the L1 for about
//   27 distinct 128-byte lines (0.85 per sample at the flagship shapes), one line per
//   cycle; in bins mode (no table) the kernel runs within 10 % of that rate.  Design:
//   the TPU version needed two composed lane gathers, 128-lane stripes and a transposed
//   crop copy because Mosaic gathers only within a vreg; here one thread computes
//   kUnroll consecutive samples of one line, with l fastest across the warp, so params
//   loads and output stores coalesce, and the crop is read directly from global memory
//   (a 256x256 int32 crop is 256 KB, more than a block's shared memory).
//   - The body's ratio table (16 KB for 16^3 bins, 128 KB for 32^3 as dynamic shared
//     memory) arrives by one bulk asynchronous copy (cp.async.bulk, the TMA's
//     non-tensor form) that completes on an mbarrier.  Thread 0 issues it first; while
//     it is in flight every thread computes its indices and issues its first kUnroll
//     crop gathers, and waits on the barrier only before its first table lookup.  A copy
//     by all threads behind a __syncthreads() before any gather cost 37 % of a kp=24
//     call on the H100.
//   - The kUnroll gathers of a thread are independent and issued together, and
//     consecutive samples of a line often share a cache line (a u-dominant line walks
//     along a row).  With 4 blocks of 512 threads per SM that is 4096 gathers in flight
//     per SM; measured on the H100, 2 steps per thread beat 1, 4 and 8 (4 and 8
//     split kp = 24 into fewer, uneven pieces over the 4 step rows, and 8 needs 48
//     registers, which halves the blocks per SM).
//   - Blocks are (128 lines) x (kStepRowsPerBlock rows of kUnroll steps), one body each;
//     a body's line tiles run next to each other, so its crop and table stay in L2.
//
// bin_counts    (replaces the Pallas kernel m3t_tpu/ops/region_fast.py::bin_counts,
//                pallas_call at :723, body _bin_counts_kernel :667)
//   counts[b, j] = #{n : mask[b, n] and bins[b, n] == j}, 0 <= j < n_total, as float.
//   Bound on this card: bytes.  Per flagship call (B=512, N=6144, 16^3 bins) 12.6 MB of
//   bins, 3.1 MB of mask and 8.4 MB of counts.  Design: the TPU built one-hot operands for
//   the MXU; here one block per body keeps an int32 histogram in shared memory, its
//   threads stride over N with shared-memory atomicAdd, then the counts are written once
//   as float.  Integer counts make the result exact and deterministic.
// ---------------------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowR0 = 0;
constexpr int kRowS0 = 1;
constexpr int kRowStep = 2;
constexpr int kRowUdom = 3;
constexpr int kRowDir = 4;
constexpr int kNParam = 8;

constexpr int kLinesPerBlock = 128;
constexpr int kStepRowsPerBlock = 4;
constexpr int kUnroll = 2;  // consecutive steps per thread, gathered together
constexpr int kBlocksPerSM = 4;  // 2048 threads: at most 32 registers each
constexpr int kCountThreads = 512;
constexpr int kStaticSharedLimit = 48 * 1024;
constexpr int kMaxGridY = 65535;  // the largest grid y of a launch

// Clamp to [0, hi] in float (NaN -> 0: fmaxf returns the non-NaN operand), then truncate.
__device__ __forceinline__ int clamp_to_index(float x, int hi) {
  x = fminf(fmaxf(x, 0.0f), static_cast<float>(hi));
  return static_cast<int>(x);
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbarrier_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

template <bool kRatio>
__global__ void __launch_bounds__(kLinesPerBlock * kStepRowsPerBlock, kBlocksPerSM)
sample_lines_kernel(const float* __restrict__ params, const int32_t* __restrict__ crop,
                    const float* __restrict__ table, void* __restrict__ out, int lp, int kp,
                    int c, int n_table, int b0) {
  extern __shared__ __align__(16) float s_table[];
  __shared__ __align__(8) uint64_t s_table_ready;
  const int b = b0 + blockIdx.y;
  const uint32_t ready = shared_address(&s_table_ready);
  if (kRatio) {
    const bool issuer = threadIdx.x == 0 && threadIdx.y == 0;
    if (issuer) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(ready) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    if (issuer) {
      const uint32_t bytes = static_cast<uint32_t>(n_table) * sizeof(float);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(ready),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(shared_address(s_table)),
          "l"(reinterpret_cast<uint64_t>(table + static_cast<size_t>(b) * n_table)),
          "r"(bytes), "r"(ready)
          : "memory");
    }
  }
  // Thread (0, 0) always has work below, so the block never ends with the copy in flight.
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= lp) return;

  const float* p = params + static_cast<size_t>(b) * kNParam * lp + l;
  const float r0 = p[kRowR0 * lp];
  const float s0 = p[kRowS0 * lp];
  const float step = p[kRowStep * lp];
  const bool udom = p[kRowUdom * lp] > 0.5f;
  const float dir = p[kRowDir * lp];
  const float stp = __fmul_rn(step, dir);
  const int32_t* cb = crop + static_cast<size_t>(b) * c * c;

  bool table_ready = false;
  for (int k0 = threadIdx.y * kUnroll; k0 < kp; k0 += kStepRowsPerBlock * kUnroll) {
    int32_t bin[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int k = k0 + j;
      const int i =
          clamp_to_index(__fadd_rn(r0, __fmul_rn(dir, static_cast<float>(k))), c - 1);
      const float col_f =
          floorf(__fadd_rn(s0, __fmul_rn(__fsub_rn(static_cast<float>(i), r0), stp)));
      const int col = clamp_to_index(col_f, c - 1);
      bin[j] = __ldg(udom ? cb + col * c + i : cb + i * c + col);  // clamped: in range
    }
    if (kRatio && !table_ready) {
      while (!mbarrier_try_wait(ready, 0)) {
      }
      table_ready = true;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int k = k0 + j;
      if (k >= kp) break;
      const size_t o = (static_cast<size_t>(b) * kp + k) * lp + l;
      if (kRatio) {
        static_cast<float*>(out)[o] = (bin[j] >= 0 && bin[j] < n_table)
                                          ? s_table[bin[j]]
                                          : __int_as_float(0x7fc00000);
      } else {
        static_cast<int32_t*>(out)[o] = bin[j];
      }
    }
  }
}

__global__ void bin_counts_kernel(const int32_t* __restrict__ bins,
                                  const uint8_t* __restrict__ mask,
                                  float* __restrict__ out, int n, int n_total) {
  extern __shared__ int s_hist[];
  for (int j = threadIdx.x; j < n_total; j += blockDim.x) s_hist[j] = 0;
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int32_t bin = bins[base + i];
    if (mask[base + i] && bin >= 0 && bin < n_total) atomicAdd(&s_hist[bin], 1);
  }
  __syncthreads();
  float* ob = out + static_cast<size_t>(blockIdx.x) * n_total;
  for (int j = threadIdx.x; j < n_total; j += blockDim.x) ob[j] = static_cast<float>(s_hist[j]);
}

template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= kStaticSharedLimit) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

int m3t_sample_lines(const void* params, const void* crop, const void* table, void* out,
                     int b, int lp, int kp, int c, int n_table, int ratio, void* stream) {
  const dim3 block(kLinesPerBlock, kStepRowsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = ratio ? static_cast<size_t>(n_table) * sizeof(float) : 0;
  if (ratio) {
    cudaError_t err = allow_shared(sample_lines_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // The batch is grid y, which holds at most kMaxGridY bodies: one launch per slice.
  for (int b0 = 0; b0 < b; b0 += kMaxGridY) {
    const dim3 grid((lp + kLinesPerBlock - 1) / kLinesPerBlock,
                    b - b0 < kMaxGridY ? b - b0 : kMaxGridY);
    if (ratio) {
      sample_lines_kernel<true><<<grid, block, smem, s>>>(
          static_cast<const float*>(params), static_cast<const int32_t*>(crop),
          static_cast<const float*>(table), out, lp, kp, c, n_table, b0);
    } else {
      sample_lines_kernel<false><<<grid, block, 0, s>>>(
          static_cast<const float*>(params), static_cast<const int32_t*>(crop), nullptr,
          out, lp, kp, c, 0, b0);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

int m3t_bin_counts(const void* bins, const void* mask, void* out, int b, int n, int n_total,
                   void* stream) {
  const size_t smem = static_cast<size_t>(n_total) * sizeof(int);
  cudaError_t err = allow_shared(bin_counts_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bin_counts_kernel<<<b, kCountThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bins), static_cast<const uint8_t*>(mask),
      static_cast<float*>(out), n, n_total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
