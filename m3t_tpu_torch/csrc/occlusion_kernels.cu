// Hopper kernel of the scene-occlusion queries, with a plain C interface (loaded through
// ctypes by m3t_tpu_torch/ops/_cuda.py, which links every csrc/*.cu into one library).
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC \
//        -o occlusion_kernels.o occlusion_kernels.cu
// The entry point launches on the caller's stream, never synchronizes, allocates
// nothing, and returns cudaGetLastError() (0 on success).
//
// ---------------------------------------------------------------------------------------
// query_points  (replaces the Pallas kernel m3t_tpu/ops/occlusion.py::_query_eval,
//                pallas_call at :347, body _pq_kernel :272)
//   For scene b and query q at focused pixel (u, v), over the triangles t < nvalid[b]:
//     e_k = (c[3k]*u + c[3k+1]*v) + c[3k+2]   (k = 0, 1, 2: edge planes)
//     inv = (c[9]*u + c[10]*v) + c[11]        (inverse-depth plane)
//     s   = (min(e0, e1, e2) >= 0 && inv > 1e-12) ? inv : 0
//   Even t run on chain 0 and odd t on chain 1; a triangle replaces its chain's best
//   (value, silhouette id) only if s is strictly greater; both chains start at (0, 0)
//   and chain 1 wins the merge only if strictly greater.  Invalid triangles count as
//   zero coefficients (s = 0).  Out: inv_out[b, q] (0 = no hit), id_out[b, q].
//   Bound on this card: operations.  Per (query, triangle) pair the kernel does 8
//   multiplies and 8 adds for the four planes, 4 compares and 3 ands for the coverage
//   test, a select for s, a compare and two selects for the chain update: 27 scalar
//   operations, against 8 bytes read and 8 written per query.  At the flagship
//   occlusion path (B=512, Q=9600, about 38 valid of 98 triangles per scene) that is
//   about 5 G operations and 79 MB per call.  The multiplies and adds are not fused (see
//   Numerics), so the kernel can reach at most about half of the FMA rate that the
//   operations bound assumes.  Design: one thread per query, with its two chains in
//   registers; the block stages scene b's first nvalid coefficient rows and ids in
//   shared memory, in tiles of kTileTriangles (512 x 52 B = 26 KB of static shared
//   memory) for larger scenes, so every thread of the block reads the same
//   coefficient at once (a broadcast).  The loop bound per scene comes from the
//   wrapper (front-compacted triangles: the valid count).
//   Numerics: every plane is __fadd_rn(__fadd_rn(__fmul_rn(a, u), __fmul_rn(b, v)), c),
//   so nvcc cannot contract it into FMAs, which would move an edge value across 0 and
//   flip coverage and ids.  The coverage test is e0 >= 0 && e1 >= 0 && e2 >= 0, which
//   equals the twin's NaN-propagating min(e0, e1, e2) >= 0 for every input.  The
//   result equals the plain PyTorch twin bit for bit.
// ---------------------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQueriesPerBlock = 256;
constexpr int kTileTriangles = 512;  // even, so a tile's local parity is the global one
constexpr int kNCoeff = 12;

__device__ __forceinline__ float plane(const float* c, float u, float v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(c[0], u), __fmul_rn(c[1], v)), c[2]);
}

__global__ void __launch_bounds__(kQueriesPerBlock)
query_points_kernel(const float* __restrict__ coeffs, const bool* __restrict__ tri_valid,
                    const int32_t* __restrict__ sil_id, const int32_t* __restrict__ nvalid,
                    const float* __restrict__ u_in, const float* __restrict__ v_in,
                    float* __restrict__ inv_out, int32_t* __restrict__ id_out, int n_tri,
                    int n_query) {
  __shared__ float s_coeff[kTileTriangles * kNCoeff];
  __shared__ int32_t s_sil[kTileTriangles];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kQueriesPerBlock + threadIdx.x;
  const bool active = q < n_query;
  const size_t query_index = static_cast<size_t>(b) * n_query + q;
  const float u = active ? u_in[query_index] : 0.0f;
  const float v = active ? v_in[query_index] : 0.0f;

  const float* scene_coeffs = coeffs + static_cast<size_t>(b) * n_tri * kNCoeff;
  const bool* scene_valid = tri_valid + static_cast<size_t>(b) * n_tri;
  const int32_t* scene_sil = sil_id + static_cast<size_t>(b) * n_tri;
  const int n = min(nvalid[b], n_tri);

  float best0 = 0.0f, best1 = 0.0f;
  int32_t id0 = 0, id1 = 0;
  for (int base = 0; base < n; base += kTileTriangles) {
    const int count = min(kTileTriangles, n - base);
    const int staged = (count + 1) & ~1;  // a zero row pads an odd tile
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < staged * kNCoeff; i += kQueriesPerBlock) {
      const int t = i / kNCoeff;
      const bool use = t < count && scene_valid[base + t];
      s_coeff[i] = use ? scene_coeffs[static_cast<size_t>(base) * kNCoeff + i] : 0.0f;
    }
    for (int t = threadIdx.x; t < staged; t += kQueriesPerBlock) {
      s_sil[t] = t < count ? scene_sil[base + t] : 0;
    }
    __syncthreads();
    for (int t = 0; t < staged; t += 2) {
      // Chain 0: even triangle t.
      const float* c = s_coeff + t * kNCoeff;
      float e0 = plane(c, u, v), e1 = plane(c + 3, u, v), e2 = plane(c + 6, u, v);
      float inv = plane(c + 9, u, v);
      float s = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && inv > 1e-12f) ? inv : 0.0f;
      if (s > best0) {
        best0 = s;
        id0 = s_sil[t];
      }
      // Chain 1: odd triangle t + 1.
      c += kNCoeff;
      e0 = plane(c, u, v);
      e1 = plane(c + 3, u, v);
      e2 = plane(c + 6, u, v);
      inv = plane(c + 9, u, v);
      s = (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && inv > 1e-12f) ? inv : 0.0f;
      if (s > best1) {
        best1 = s;
        id1 = s_sil[t + 1];
      }
    }
  }
  if (active) {
    const bool sel = best1 > best0;
    inv_out[query_index] = sel ? best1 : best0;
    id_out[query_index] = sel ? id1 : id0;
  }
}

}  // namespace

extern "C" {

int m3t_query_eval(const void* coeffs, const void* tri_valid, const void* sil_id,
                   const void* nvalid, const void* u, const void* v, void* inv_out,
                   void* id_out, int b, int n_tri, int n_query, void* stream) {
  const dim3 grid((n_query + kQueriesPerBlock - 1) / kQueriesPerBlock, b);
  query_points_kernel<<<grid, kQueriesPerBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const bool*>(tri_valid),
      static_cast<const int32_t*>(sil_id), static_cast<const int32_t*>(nvalid),
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<float*>(inv_out), static_cast<int32_t*>(id_out), n_tri, n_query);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
