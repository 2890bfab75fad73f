// Hopper kernel of the depth modality, with a plain C interface (loaded through ctypes by
// m3t_tpu_torch/ops/_cuda.py, which links every csrc/*.cu into one library).  Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC \
//        -o depth_kernels.o depth_kernels.cu
// The entry point launches on the caller's stream, never synchronizes, allocates
// nothing, and returns cudaGetLastError() (0 on success).
//
// ---------------------------------------------------------------------------------------
// sample_windows  (replaces the Pallas kernel m3t_tpu/ops/depth_fast.py::sample_windows,
//                  pallas_call at :98, body _window_kernel :44, together with the crop
//                  that depth_fast.depth_crops gathers for it and the layout change that
//                  _fetch_strided_windows applies to its output)
//   For body b, window p and sample (kv, ku) of a K x K window:
//     r = clamp(v_min[b,p] - corner_v[b] + kv * stride[b,p], 0, C-1)
//     c = clamp(u_min[b,p] - corner_u[b] + ku * stride[b,p], 0, C-1)
//     d[b, p, kv, ku] = float(image[b, corner_v[b] + r, corner_u[b] + c]),
//   and 0 where that pixel lies outside the (H, W) frame (what zero-padding a frame
//   smaller than the (C, C) crop gives).  All of it is int32 arithmetic, wrapping as the
//   plain PyTorch twin's does; the operands are integers, so the result equals the old
//   float formula (integer-valued f32 below 2^24) exactly.
//
//   Bound on this card: bytes.  At the flagship (B=512 bodies sharing one 640x512 uint16
//   frame, P=200 windows, K = 11, 5, 3 per RGB-D cycle) the function must write its
//   (B, P, K, K) f32 output (70.9 MB per cycle), read the (B, P) geometry (3 x 410 KB
//   per call) and the frame pixels the windows touch (at most the 655 KB frame): about
//   0.023 ms per cycle at 3.35 TB/s.
//
//   Design.  The TPU kernel gathered from a transposed int32 crop per body, because
//   Mosaic gathers only within a vreg, and wrote the TPU's padded (B, kp, LP) int32
//   layout (kp = K rounded up to 8, LP = P*K rounded up to 128), which a permute and a
//   cast then turned into (B, P, K, K) f32.  Neither constraint exists here:
//   - No crop.  The 512 (256, 256) int32 crops of the flagship are 134 MB, more than the
//     50 MB L2, so a gather from them went to HBM; the shared uint16 frame they were cut
//     from is 655 KB and stays in L2.  The kernel reads the frame directly with read-only
//     16-bit loads (the image may be an expanded view with batch stride 0).
//   - The consumer's layout.  One thread writes kElemsPerThread consecutive outputs of
//     the flattened (B, P, K, K) order, ku fastest, as one 16-byte store where the four
//     lie inside the body's output (a ragged head and tail are stored one by one), so a
//     warp writes 512 contiguous bytes; the stores are evict-first (__stcs) so that the
//     output, 49.6 MB at K=11, does not push the frame out of L2.  A warp's 128 samples
//     cover about one K=11 window: 11 rows of 11 samples a stride apart, a few 128-byte
//     lines each, where the old kernel's warp read 32 different crop rows.
//   - K is a template parameter for the sizes the pipeline uses (3, 5, 11 for the
//     correspondence windows, 6 for the measured-occlusion windows), so the index
//     decomposition divides by constants; any other K takes the runtime instantiation.
// ---------------------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kElemsPerThread = 4;  // consecutive outputs per thread, a multiple of 4
                                    // (16-byte stores)
constexpr int kThreads = 256;
// Blocks per SM that the register budget must allow: 2048 threads at 32 registers each.
// Left to itself nvcc takes 39-40, 6 blocks fit, and an RGB-D cycle's calls take 6-9 %
// longer on an H100.
constexpr int kBlocksPerSM = 2048 / kThreads;
constexpr int kMaxGridY = 65535;  // the largest grid y of a launch

// a + k * s in int32 with two's-complement wrapping (the twin's int32 tensor arithmetic).
__device__ __forceinline__ int wrap_madd(int a, int k, int s) {
  return static_cast<int>(static_cast<unsigned>(a) +
                          static_cast<unsigned>(k) * static_cast<unsigned>(s));
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int clamp_crop(int x, int c) { return min(max(x, 0), c - 1); }

// The sampling state of one window row: where its pixels are read from.
struct Row {
  const uint16_t* ptr;  // the frame row
  bool ok;              // the row lies inside the frame
};

struct Body {
  const uint16_t* plane;  // this body's (H, W) frame
  const int32_t* u_min;
  const int32_t* v_min;
  const int32_t* stride;
  int cu, cv, h, w, c;

  __device__ __forceinline__ Row row(int v0, int kv, int s) const {
    const int y = wrap_add(cv, clamp_crop(wrap_madd(v0, kv, s), c));
    return Row{plane + static_cast<size_t>(static_cast<unsigned>(y)) * w,
               static_cast<unsigned>(y) < static_cast<unsigned>(h)};
  }

  __device__ __forceinline__ float sample(const Row& row, int u0, int ku, int s) const {
    const int x = wrap_add(cu, clamp_crop(wrap_madd(u0, ku, s), c));
    const bool ok = row.ok && static_cast<unsigned>(x) < static_cast<unsigned>(w);
    return ok ? static_cast<float>(__ldg(row.ptr + x)) : 0.0f;
  }

  // Output j of this body (window j / K^2, sample (j / K) % K, j % K), from scratch.
  __device__ __forceinline__ float sample_at(int j, int k, int kk) const {
    const int pi = j / kk;
    const int rem = j - pi * kk;
    const int kv = rem / k;
    const int u0 = wrap_sub(__ldg(u_min + pi), cu);
    const int v0 = wrap_sub(__ldg(v_min + pi), cv);
    const int s = __ldg(stride + pi);
    return sample(row(v0, kv, s), u0, rem - kv * k, s);
  }
};

template <int K>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    sample_windows_kernel(const uint16_t* __restrict__ image, long long batch_stride, int h,
                          int w, const int32_t* __restrict__ u_min,
                          const int32_t* __restrict__ v_min,
                          const int32_t* __restrict__ stride,
                          const int32_t* __restrict__ corner_u,
                          const int32_t* __restrict__ corner_v, float* __restrict__ out,
                          int p, int k_runtime, int c, int b0) {
  const int k = K > 0 ? K : k_runtime;
  const int kk = k * k;
  const int b = b0 + blockIdx.y;
  const int n = p * kk;                                   // this body's outputs
  const size_t first = static_cast<size_t>(b) * n;        // ... from here in `out`
  // Groups are aligned to kElemsPerThread outputs of the whole output, so a body whose
  // first output is not aligned starts with a partial group.
  const int lead = static_cast<int>(first % kElemsPerThread);
  const size_t offset = static_cast<size_t>(b) * p;
  const Body body{image + static_cast<size_t>(b) * static_cast<size_t>(batch_stride),
                  u_min + offset, v_min + offset, stride + offset,
                  __ldg(corner_u + b), __ldg(corner_v + b), h, w, c};

  const int n_groups = (n + lead + kElemsPerThread - 1) / kElemsPerThread;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < n_groups;
       g += gridDim.x * blockDim.x) {
    const int j0 = g * kElemsPerThread - lead;
    float* dst = out + first + j0;
    if (j0 >= 0 && j0 + kElemsPerThread <= n) {
      // A whole group: walk (p, kv, ku) from its first output, reloading the window's
      // geometry and the row only when they change.
      int pi = j0 / kk;
      const int rem = j0 - pi * kk;
      int kv = rem / k;
      int ku = rem - kv * k;
      int u0 = wrap_sub(__ldg(body.u_min + pi), body.cu);
      int v0 = wrap_sub(__ldg(body.v_min + pi), body.cv);
      int s = __ldg(body.stride + pi);
      Row row = body.row(v0, kv, s);
      float vals[kElemsPerThread];
#pragma unroll
      for (int e = 0; e < kElemsPerThread; ++e) {
        vals[e] = body.sample(row, u0, ku, s);
        if (e + 1 < kElemsPerThread && ++ku == k) {
          ku = 0;
          if (++kv == k) {
            kv = 0;
            ++pi;
            u0 = wrap_sub(__ldg(body.u_min + pi), body.cu);
            v0 = wrap_sub(__ldg(body.v_min + pi), body.cv);
            s = __ldg(body.stride + pi);
          }
          row = body.row(v0, kv, s);
        }
      }
#pragma unroll
      for (int e = 0; e < kElemsPerThread; e += 4) {
        __stcs(reinterpret_cast<float4*>(dst + e),
               make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]));
      }
    } else {
      // The ragged head or tail of a body's output: one output at a time.
      for (int e = 0; e < kElemsPerThread; ++e) {
        const int j = j0 + e;
        if (j >= 0 && j < n) __stcs(dst + e, body.sample_at(j, k, kk));
      }
    }
  }
}

struct Args {
  const uint16_t* image;
  long long batch_stride;
  int h, w;
  const int32_t *u_min, *v_min, *stride, *corner_u, *corner_v;
  float* out;
  int b, p, k, c;
};

template <int K>
int launch(const Args& a, cudaStream_t stream) {
  const long long n_groups =
      (static_cast<long long>(a.p) * a.k * a.k + 2 * kElemsPerThread - 1) / kElemsPerThread;
  // The batch is grid y, which holds at most kMaxGridY bodies: one launch per slice.
  for (int b0 = 0; b0 < a.b; b0 += kMaxGridY) {
    const dim3 grid(static_cast<unsigned>((n_groups + kThreads - 1) / kThreads),
                    a.b - b0 < kMaxGridY ? a.b - b0 : kMaxGridY);
    sample_windows_kernel<K><<<grid, kThreads, 0, stream>>>(
        a.image, a.batch_stride, a.h, a.w, a.u_min, a.v_min, a.stride, a.corner_u,
        a.corner_v, a.out, a.p, a.k, a.c, b0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int m3t_sample_windows(const void* image, long long batch_stride, int h, int w,
                       const void* u_min, const void* v_min, const void* stride,
                       const void* corner_u, const void* corner_v, void* out, int b, int p,
                       int k, int c, void* stream) {
  const Args a{static_cast<const uint16_t*>(image), batch_stride, h, w,
               static_cast<const int32_t*>(u_min), static_cast<const int32_t*>(v_min),
               static_cast<const int32_t*>(stride), static_cast<const int32_t*>(corner_u),
               static_cast<const int32_t*>(corner_v), static_cast<float*>(out), b, p, k, c};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return launch<3>(a, s);
    case 5: return launch<5>(a, s);
    case 6: return launch<6>(a, s);
    case 11: return launch<11>(a, s);
    default: return launch<0>(a, s);
  }
}

}  // extern "C"
