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
//   For scene b and query q at focused pixel (u, v), over the triangles t < n_b (n_b =
//   index of scene b's last valid triangle + 1):
//     e_k = (c[3k]*u + c[3k+1]*v) + c[3k+2]   (k = 0, 1, 2: edge planes)
//     inv = (c[9]*u + c[10]*v) + c[11]        (inverse-depth plane)
//     s   = (min(e0, e1, e2) >= 0 && inv > 1e-12) ? inv : 0
//   Even t run on chain 0 and odd t on chain 1; a triangle replaces its chain's best
//   (value, silhouette id) only if s is strictly greater; both chains start at (0, 0)
//   and chain 1 wins the merge only if strictly greater.  Invalid triangles give s = 0.
//   Out: inv_out[b, q] (0 = no hit), id_out[b, q].
//
//   Bound on this card: 27 scalar operations per (query, triangle) pair that has to be
//   evaluated, against 8 bytes read and 8 written per query.  Evaluating every pair makes
//   it operations-bound: at the flagship occlusion path (B=512, Q=9600, about 38 valid
//   triangles per scene) 5 G operations per call.  But the queries are local (each
//   line's 48 window and stride pixels are neighbours) and a scene's ~38 triangles
//   spread over a 128x128 crop, so only ~2.5 % of the pairs lie in a triangle's box.
//
//   Design: one thread per query; a block takes one scene and kTilesPerBlock tiles of
//   256 queries, one after the other.
//   - The block finds its scene's loop bound n_b from tri_valid itself, and stages the
//     first n_b coefficient rows and ids in shared memory in tiles of kTileTriangles
//     (512 x 52 B = 26 KB of static shared memory); when one tile holds them all, the
//     block's query tiles share it.  An invalid row is staged as the edge plane
//     (0, 0, -1), which no query covers: s = 0, as for the zero row that the plain twin
//     gives it, and the cull below drops it.
//   - Cull (kCull): each half-warp (kBoxLanes queries) reduces its non-NaN queries to one
//     box [u_lo, u_hi] x [v_lo, v_hi] (a NaN query never covers).  Lane j of the warp
//     then tests triangle j of the next 32 against both boxes: triangle t cannot cover
//     any query of a box if one of its edge planes, evaluated at the box corner where
//     that plane is largest (u_hi where a >= 0, else u_lo; v likewise), is < 0.  A
//     ballot gives the warp the triangles that survive for either half, and the warp
//     evaluates only those, in increasing t, so both chains see their triangles in
//     order.  The branch is warp-uniform.  The test costs one lane per (warp, triangle);
//     on the occlusion path 15 % of the (half-warp, triangle) tests and 22 % of the
//     (warp, triangle) pairs survive.
//   - A surviving triangle's inverse-depth plane is evaluated only when one lane of the
//     warp is covered (every s is 0 otherwise).
//   - Why the cull is exact, with no margin: a plane is evaluated in float as
//     fadd(fadd(fmul(a, u), fmul(b, v)), c), and each of these correctly rounded
//     operations is monotone in each argument (non-decreasing, or non-increasing for a
//     negative factor), so the computed e_k over the box is largest at that corner.  If
//     the corner value is < 0, every query of the box gets e_k < 0 or NaN, fails the
//     coverage test, and has s = 0 in the twin; s = 0 never replaces a chain's best (the
//     test is a strict > and the best is never below 0), so skipping the pair changes
//     no result.  A NaN at the corner (an infinite query or coefficient) is not < 0 and
//     keeps the triangle.
//   - Without the cull the warp evaluates every staged triangle: the comparison for
//     the cull's gain.
//   Numerics: every plane is __fadd_rn(__fadd_rn(__fmul_rn(a, u), __fmul_rn(b, v)), c),
//   so nvcc cannot contract it into FMAs, which would move an edge value across 0 and
//   flip coverage and ids.  The coverage test is e0 >= 0 && e1 >= 0 && e2 >= 0, which
//   equals the twin's NaN-propagating min(e0, e1, e2) >= 0 for every input.  int32 query
//   pixels are converted with __int2float_rn, as the twin's cast does.  The result
//   equals the plain PyTorch twin bit for bit.
// ---------------------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueriesPerTile = 256;  // one thread per query of a tile
constexpr int kTilesPerBlock = 4;     // query tiles per block, sharing its staged triangles
constexpr int kMinBlocksPerSM = 6;
constexpr int kTileTriangles = 512;  // even, so a tile's local parity is the global one
constexpr int kNCoeff = 12;
constexpr int kWarp = 32;
constexpr int kBoxLanes = 16;  // queries per cull box: two boxes per warp
constexpr int kBoxes = kWarp / kBoxLanes;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxGridY = 65535;  // the largest grid y of a launch

__device__ __forceinline__ float plane(float a, float b, float c, float u, float v) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, u), __fmul_rn(b, v)), c);
}

__device__ __forceinline__ float as_float(float x) { return x; }
__device__ __forceinline__ float as_float(int32_t x) { return __int2float_rn(x); }

struct Box {
  float u_lo, u_hi, v_lo, v_hi;
};

// True if one edge plane of c is < 0 at the box corner where it is largest: then no
// query in the box is covered (see "Why the cull is exact").  Branch-free: the lanes of a
// warp test different triangles.
__device__ __forceinline__ bool outside(const float4& p0, const float4& p1, const float4& p2,
                                        const Box& box) {
  const float e0 = plane(p0.x, p0.y, p0.z, p0.x >= 0.0f ? box.u_hi : box.u_lo,
                         p0.y >= 0.0f ? box.v_hi : box.v_lo);
  const float e1 = plane(p0.w, p1.x, p1.y, p0.w >= 0.0f ? box.u_hi : box.u_lo,
                         p1.x >= 0.0f ? box.v_hi : box.v_lo);
  const float e2 = plane(p1.z, p1.w, p2.x, p1.z >= 0.0f ? box.u_hi : box.u_lo,
                         p1.w >= 0.0f ? box.v_hi : box.v_lo);
  return (e0 < 0.0f) | (e1 < 0.0f) | (e2 < 0.0f);
}

// Min and max over the kBoxLanes lanes of a query group (every lane gets the result).
__device__ __forceinline__ float group_min(float x) {
#pragma unroll
  for (int off = kBoxLanes / 2; off > 0; off >>= 1) x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = kBoxLanes / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// The box of query group g of the warp, from the lanes whose query counts: float
// queries by shuffles within each group, int32 queries by one warp reduction per bound,
// converted as the queries are (the conversion is monotone, so it commutes with min and
// max).
__device__ __forceinline__ Box group_box(float u, float v, bool counted, int g) {
  const Box mine = {group_min(counted ? u : INFINITY), group_max(counted ? u : -INFINITY),
                    group_min(counted ? v : INFINITY), group_max(counted ? v : -INFINITY)};
  const int first = g * kBoxLanes;
  return {__shfl_sync(kFull, mine.u_lo, first), __shfl_sync(kFull, mine.u_hi, first),
          __shfl_sync(kFull, mine.v_lo, first), __shfl_sync(kFull, mine.v_hi, first)};
}

__device__ __forceinline__ Box group_box(int32_t u, int32_t v, bool counted, int g) {
  const bool in_group = counted && (threadIdx.x % kWarp) / kBoxLanes == g;
  return {__int2float_rn(__reduce_min_sync(kFull, in_group ? u : INT_MAX)),
          __int2float_rn(__reduce_max_sync(kFull, in_group ? u : INT_MIN)),
          __int2float_rn(__reduce_min_sync(kFull, in_group ? v : INT_MAX)),
          __int2float_rn(__reduce_max_sync(kFull, in_group ? v : INT_MIN))};
}

// Rows [base, base + count) of the scene into shared memory: valid rows as they are,
// invalid rows as the edge plane (0, 0, -1), which covers nothing.
__device__ __forceinline__ void stage_tile(float* s_coeff, int32_t* s_sil,
                                           const float* scene_coeffs, const bool* scene_valid,
                                           const int32_t* scene_sil, int base, int count) {
  for (int i = threadIdx.x; i < count * kNCoeff; i += kQueriesPerTile) {
    const int t = i / kNCoeff;
    const int k = i - t * kNCoeff;
    s_coeff[i] = scene_valid[base + t] ? scene_coeffs[static_cast<size_t>(base) * kNCoeff + i]
                                       : (k == 2 ? -1.0f : 0.0f);
  }
  for (int t = threadIdx.x; t < count; t += kQueriesPerTile) s_sil[t] = scene_sil[base + t];
}

template <typename Query, bool kCull>
__global__ void __launch_bounds__(kQueriesPerTile, kMinBlocksPerSM)
query_points_kernel(const float* __restrict__ coeffs, const bool* __restrict__ tri_valid,
                    const int32_t* __restrict__ sil_id, const Query* __restrict__ u_in,
                    const Query* __restrict__ v_in, float* __restrict__ inv_out,
                    int32_t* __restrict__ id_out, int n_tri, int n_query, int b0) {
  __shared__ __align__(16) float s_coeff[kTileTriangles * kNCoeff];
  __shared__ int32_t s_sil[kTileTriangles];
  __shared__ int s_warp_bound[kQueriesPerTile / kWarp];

  const int b = b0 + blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const float* scene_coeffs = coeffs + static_cast<size_t>(b) * n_tri * kNCoeff;
  const bool* scene_valid = tri_valid + static_cast<size_t>(b) * n_tri;
  const int32_t* scene_sil = sil_id + static_cast<size_t>(b) * n_tri;

  // The scene's loop bound: index of its last valid triangle + 1 (0 if none).
  int last = 0;
  for (int t = threadIdx.x; t < n_tri; t += kQueriesPerTile) {
    if (scene_valid[t]) last = t + 1;
  }
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) s_warp_bound[threadIdx.x / kWarp] = last;
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int w = 0; w < kQueriesPerTile / kWarp; ++w) n = max(n, s_warp_bound[w]);

  // The block's query tiles share its staged triangles when one tile holds them all.
  bool staged = false;
  for (int tile = 0; tile < kTilesPerBlock; ++tile) {
    const int q0 = (blockIdx.x * kTilesPerBlock + tile) * kQueriesPerTile;
    if (q0 >= n_query) break;
    const int q = q0 + threadIdx.x;
    const bool active = q < n_query;
    const size_t query_index = static_cast<size_t>(b) * n_query + q;
    const Query raw_u = active ? u_in[query_index] : Query(0);
    const Query raw_v = active ? v_in[query_index] : Query(0);
    const float u = active ? as_float(raw_u) : __int_as_float(0x7fc00000);
    const float v = active ? as_float(raw_v) : __int_as_float(0x7fc00000);

    // The warp's kBoxes query boxes; a NaN query never covers a triangle.
    Box box[kBoxes];
    bool has[kBoxes];
    if (kCull) {
      const bool counted = !(isnan(u) || isnan(v));
      const unsigned counted_mask = __ballot_sync(kFull, counted);
#pragma unroll
      for (int g = 0; g < kBoxes; ++g) {
        box[g] = group_box(raw_u, raw_v, counted, g);
        has[g] = ((counted_mask >> (g * kBoxLanes)) & (kFull >> (kWarp - kBoxLanes))) != 0;
      }
    }

    float best0 = 0.0f, best1 = 0.0f;
    int32_t id0 = 0, id1 = 0;
    for (int base = 0; base < n; base += kTileTriangles) {
      const int count = min(kTileTriangles, n - base);
      if (!staged || n > kTileTriangles) {
        __syncthreads();  // the previous tile is consumed
        stage_tile(s_coeff, s_sil, scene_coeffs, scene_valid, scene_sil, base, count);
        __syncthreads();
        staged = true;
      }
      for (int chunk = 0; chunk < count; chunk += kWarp) {
        // todo: the triangles of this chunk that the warp evaluates.
        const int t_lane = chunk + lane;
        bool keep = t_lane < count;
        if (kCull) {
          const float4* c4 =
              reinterpret_cast<const float4*>(s_coeff + min(t_lane, count - 1) * kNCoeff);
          const float4 p0 = c4[0], p1 = c4[1], p2 = c4[2];
          bool any = false;
#pragma unroll
          for (int g = 0; g < kBoxes; ++g) any |= has[g] & !outside(p0, p1, p2, box[g]);
          keep &= any;
        }
        unsigned todo = __ballot_sync(kFull, keep);
        while (todo != 0) {
          const int t = chunk + __ffs(todo) - 1;
          todo &= todo - 1;
          const float4* c4 = reinterpret_cast<const float4*>(s_coeff + t * kNCoeff);
          const float4 p0 = c4[0], p1 = c4[1], p2 = c4[2];
          const float e0 = plane(p0.x, p0.y, p0.z, u, v);
          const float e1 = plane(p0.w, p1.x, p1.y, u, v);
          const float e2 = plane(p1.z, p1.w, p2.x, u, v);
          const bool covered = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f);
          // Where no lane is covered every s is 0, which changes no chain.
          if (!__any_sync(kFull, covered)) continue;
          const float inv = plane(p2.y, p2.z, p2.w, u, v);
          const float s = (covered && inv > 1e-12f) ? inv : 0.0f;
          if (t & 1) {
            if (s > best1) {
              best1 = s;
              id1 = s_sil[t];
            }
          } else if (s > best0) {
            best0 = s;
            id0 = s_sil[t];
          }
        }
      }
    }
    if (active) {
      const bool sel = best1 > best0;
      inv_out[query_index] = sel ? best1 : best0;
      id_out[query_index] = sel ? id1 : id0;
    }
  }
}

template <typename Query, bool kCull>
void launch(const void* coeffs, const void* tri_valid, const void* sil_id, const void* u,
            const void* v, void* inv_out, void* id_out, int b, int n_tri, int n_query,
            cudaStream_t stream) {
  const int per_block = kQueriesPerTile * kTilesPerBlock;
  // The batch is grid y, which holds at most kMaxGridY scenes: one launch per slice.
  for (int b0 = 0; b0 < b; b0 += kMaxGridY) {
    const dim3 grid((n_query + per_block - 1) / per_block,
                    b - b0 < kMaxGridY ? b - b0 : kMaxGridY);
    query_points_kernel<Query, kCull><<<grid, kQueriesPerTile, 0, stream>>>(
        static_cast<const float*>(coeffs), static_cast<const bool*>(tri_valid),
        static_cast<const int32_t*>(sil_id), static_cast<const Query*>(u),
        static_cast<const Query*>(v), static_cast<float*>(inv_out),
        static_cast<int32_t*>(id_out), n_tri, n_query, b0);
  }
}

}  // namespace

extern "C" {

// u, v: (B, n_query) float32, or int32 when int_queries is nonzero.  cull = 0 evaluates
// every (query, triangle) pair.
int m3t_query_eval(const void* coeffs, const void* tri_valid, const void* sil_id,
                   const void* u, const void* v, void* inv_out, void* id_out, int b,
                   int n_tri, int n_query, int int_queries, int cull, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int_queries) {
    (cull ? launch<int32_t, true> : launch<int32_t, false>)(
        coeffs, tri_valid, sil_id, u, v, inv_out, id_out, b, n_tri, n_query, s);
  } else {
    (cull ? launch<float, true> : launch<float, false>)(
        coeffs, tri_valid, sil_id, u, v, inv_out, id_out, b, n_tri, n_query, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
