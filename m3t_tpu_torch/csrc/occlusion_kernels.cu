// Hopper kernels of the scene occlusions, the focused scenes' coefficients and the point
// queries, with a plain C interface (loaded through ctypes by m3t_tpu_torch/ops/_cuda.py,
// which links every csrc/*.cu into one library).
// Build:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -c -Xcompiler -fPIC \
//        -o occlusion_kernels.o occlusion_kernels.cu
// The entry points launch on the caller's stream, never synchronize, allocate nothing,
// and return cudaGetLastError() (0 on success).
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
//   256 queries.  The block finds its scene's loop bound n_b from tri_valid itself, and
//   its tiles evaluate a list of rows in shared memory (kTileTriangles = 512 rows of 12
//   coefficients, an id and a parity: 27 KB of static shared memory).  The list takes one
//   of two layouts, chosen from the scenes' row count T (n_tri), which bounds every n_b:
//   - Whole (T <= kTileTriangles): the block stages its scene's first n_b rows once, as
//     they stand, and its tiles share them; a row's place in the list is its t.  An
//     invalid row is staged as the edge plane (0, 0, -1), which no query covers: s = 0,
//     as for the zero row that the plain twin gives it.  6 blocks an SM.  Such scenes
//     are small enough that most of their rows reach the block's queries (the occlusion
//     path's sphere of at most 256 triangles: every row), so a block cull would cost
//     its box and its list and drop nothing (13 % slower there; PERF.md section 6).
//   - Block cull (T > kTileTriangles).  The block reads every query of its tiles up
//     front and reduces the non-NaN ones to one box over the block (warp reductions, then
//     shared memory; int32 queries converted first, which is monotone and so commutes
//     with min and max).  It then walks the scene's first n_b rows, one row a thread, 256
//     rows a pass, and keeps a row only if it is valid and the corner test below does not
//     rule it out for the block's box.  The kept rows go to the list in increasing t,
//     each with its 12 coefficients, its id and the parity of its t (the chain it runs on
//     is t & 1 of the scene's order, not of the list), placed by a ballot and popcount
//     within the warp and an exclusive scan of the warps' counts.  When the list holds
//     every kept row it is built once and shared by the block's query tiles.  Otherwise
//     it ends at the first kept row that does not fit, and each tile walks the kept rows
//     in rounds: evaluate the list, build the next one from that row on, and so on, its
//     chains carried from round to round.  A block with no non-NaN query keeps no row.
//     4 blocks an SM.  At the kinematic cell's scenes (n_b about 1,080 of T = 2240) the
//     blocks keep 26 % of the rows they scan, about 290 a block, so one list of five
//     passes replaces the restaging of every row for every tile, and each warp tests
//     about 9 chunks of rows in place of 34.
//   - Warp level (the list): each half-warp (kBoxLanes queries) reduces its non-NaN
//     queries to one box [u_lo, u_hi] x [v_lo, v_hi] (a NaN query never covers).  Lane j
//     of the warp then tests row j of the next 32 of the list against both boxes: a
//     triangle cannot cover any query of a box if one of its edge planes, evaluated at
//     the box corner where that plane is largest (u_hi where a >= 0, else u_lo; v
//     likewise), is < 0.  A ballot gives the warp the rows that survive for either half,
//     and the warp evaluates only those, in list order, so both chains see their
//     triangles in increasing t.  The branch is warp-uniform.
//   - A surviving triangle's inverse-depth plane is evaluated only when one lane of the
//     warp is covered (every s is 0 otherwise).
//   - Why the cull is exact, with no margin: a plane is evaluated in float as
//     fadd(fadd(fmul(a, u), fmul(b, v)), c), and each of these correctly rounded
//     operations is monotone in each argument (non-decreasing, or non-increasing for a
//     negative factor), so the computed e_k over a box is largest at that corner.  If
//     the corner value is < 0, every query of the box gets e_k < 0 or NaN, fails the
//     coverage test, and has s = 0 in the twin; s = 0 never replaces a chain's best (the
//     test is a strict > and the best is never below 0), so skipping the pair changes
//     no result.  A NaN at the corner (an infinite query or coefficient) is not < 0 and
//     keeps the triangle.  The block's box holds every query of its half-warps' boxes,
//     so a row it rules out gives s = 0 at every query of the block, and dropping the
//     row from the list changes no result either; an invalid row gives s = 0 in the twin
//     (its zero row covers nothing), so it is dropped too.  The list keeps the rows in
//     increasing t and each row's parity, so every chain sees its triangles in the
//     twin's order, whatever the rounds.
//   - Engagement (tally, null unless the wrapper asks for it): each block adds n_b to
//     tally[0] and the rows of its lists, over every round, to tally[1] (n_b where it
//     stages the scene whole).
//   Numerics: every plane is __fadd_rn(__fadd_rn(__fmul_rn(a, u), __fmul_rn(b, v)), c),
//   so nvcc cannot contract it into FMAs, which would move an edge value across 0 and
//   flip coverage and ids.  The coverage test is e0 >= 0 && e1 >= 0 && e2 >= 0, which
//   equals the twin's NaN-propagating min(e0, e1, e2) >= 0 for every input.  int32 query
//   pixels are converted with __int2float_rn, as the twin's cast does.  The result
//   equals the plain PyTorch twin bit for bit.
// ---------------------------------------------------------------------------------------
//
// ---------------------------------------------------------------------------------------
// scene_coeffs  (replaces no Pallas kernel: the JAX package leaves
//                m3t_tpu/ops/occlusion.py::focused_scene_coeffs to XLA, which fuses it
//                into the jitted cycle; the port's plain form, ops/occlusion.py::
//                scene_coeffs_plain, writes every intermediate to device memory: a
//                (B, T, 4, 4) pose per triangle, batched 3x3 products, some 60
//                elementwise passes, stacks, a stable argsort and four gathers)
//   For scene b and triangle t, with P = poses[b, owner[b, t]] and vertices (x, y, z):
//     camera frame, row i:  c_i = ((P[i][0]*x + P[i][1]*y) + P[i][2]*z) + P[i][3]
//     vertex k:  front_k = c_z > z_min,  z_k = front_k ? c_z : 1,
//                u_k = (c_x*fu)/z_k + pu,  v_k = (c_y*fv)/z_k + pv,  iz_k = 1/z_k
//     edge e (vertex e to n = e+1 mod 3):  dv = v_n - v_e,  du = u_n - u_e,
//                a_e = -dv,  b_e = du,  c_e = dv*u_e - du*v_e
//     area = (a0*u2 + b0*v2) + c0,  big = |area| > 1e-12,  sign = area >= 0 ? 1 : -1
//     valid = front_0 && front_1 && front_2 && big && (area < 0 || !cull) && tri_valid
//     az = ((a1*iz0 + a2*iz1) + a0*iz2) / (big ? area : 1);  bz, cz alike with b, c
//     row = (a0, b0, c0, a1, b1, c1, a2, b2, c2) * sign, az, bz, cz
//     box = (min u, max u, min v, max v)
//   The row, box, id and flag of t go to row n_before(t) of the scene if t is valid, else
//   to n_valid + (t - n_before(t)), where n_before(t) counts the valid triangles before
//   t: the permutation of a stable argsort of !valid.  The query kernel's loop bound and
//   its tie rule (chains by the parity of t) rest on that order.
//
//   Bound on this card: bytes.  A triangle reads 46 B (its vertices, owner, id and two
//   flags) and writes 69 B (row, box, id, flag), with about 110 scalar operations: the
//   kinematic cell's B = 1792 scenes of T = 2240 triangles are 462 MB a call, 0.138 ms
//   at 3.35 TB/s.
//
//   Design: one block a scene, kThreads wide (T rounded up to a warp for scenes of up to
//   128 triangles, else 256: ops/occlusion.py::_block_width), walking the scene in tiles
//   of one triangle a thread.
//   - Pass 1 evaluates each triangle's validity and counts the scene's valid ones
//     (__syncthreads_count, tile by tile).
//   - Pass 2 evaluates each triangle again and finds its row by a block-wide exclusive
//     scan of the flags (a ballot and popcount within the warp, the warps' counts through
//     shared memory), carried from tile to tile.  The tile's valid rows and its invalid
//     rows are two runs of consecutive output rows: the threads stage their results in
//     shared memory in that order, and the block then stores the runs as 16-byte words,
//     neighbouring threads on neighbouring words.
//   - A triangle reads its owner's pose (12 floats, through L1: a warp's triangles mostly
//     share one owner); no pose per triangle is written anywhere.
//   - Pass 2 reads the scene's inputs again, from L2 where they still are.  Holding a
//     scene's results until its count is known would take 69 B x T of shared memory
//     (155 KB at T = 2240) and leave one block on an SM.
//   Numerics: every product, sum and quotient is one __fmul_rn, __fadd_rn, __fsub_rn or
//   __fdiv_rn in the plain twin's order (one PyTorch kernel per operation there), so
//   nvcc contracts nothing into a fused multiply-add; z_min and 1e-12 are compared as
//   float32, as PyTorch compares a float32 tensor with a Python number; min and max
//   propagate NaN, as PyTorch's amin and amax do.  The result equals the plain twin on
//   the same inputs bit for bit.
// ---------------------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQueriesPerTile = 256;  // one thread per query of a tile
constexpr int kTilesPerBlock = 4;     // query tiles per block, sharing its list of rows
constexpr int kTileTriangles = 512;   // rows of the block's list
// Blocks an SM: 64 registers where the block culls (faster than 5, 6 or 8 blocks), 40
// where it stages its scene's rows whole (PERF.md section 6).
constexpr int kMinBlocksPerSMCull = 4;
constexpr int kMinBlocksPerSMWhole = 6;
constexpr int kNCoeff = 12;
constexpr int kWarp = 32;
constexpr int kWarps = kQueriesPerTile / kWarp;
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

__device__ __forceinline__ Box box_union(const Box& a, const Box& b) {
  return {fminf(a.u_lo, b.u_lo), fmaxf(a.u_hi, b.u_hi), fminf(a.v_lo, b.v_lo),
          fmaxf(a.v_hi, b.v_hi)};
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

// The union of a box over the warp's lanes (every lane gets the result).
__device__ __forceinline__ Box warp_box(Box box) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    box = box_union(box, {__shfl_xor_sync(kFull, box.u_lo, off),
                          __shfl_xor_sync(kFull, box.u_hi, off),
                          __shfl_xor_sync(kFull, box.v_lo, off),
                          __shfl_xor_sync(kFull, box.v_hi, off)});
  }
  return box;
}

// The scene's first rows rows (at most kTileTriangles) into the list as they stand:
// valid rows as they are, invalid rows as the edge plane (0, 0, -1), which covers nothing.
__device__ __forceinline__ void stage_whole(float* s_coeff, int32_t* s_sil,
                                            const float* scene_coeffs, const bool* scene_valid,
                                            const int32_t* scene_sil, int rows) {
  for (int i = threadIdx.x; i < rows * kNCoeff; i += kQueriesPerTile) {
    const int t = i / kNCoeff;
    const int k = i - t * kNCoeff;
    s_coeff[i] = scene_valid[t] ? scene_coeffs[i] : (k == 2 ? -1.0f : 0.0f);
  }
  for (int t = threadIdx.x; t < rows; t += kQueriesPerTile) s_sil[t] = scene_sil[t];
}

// Block level, one round: from scene row cursor on, the rows that can reach the block's
// box go to the list in increasing t, until the list is full or the rows run out.
// Advances cursor past the last row tested (or to the first kept row that did not fit);
// returns the rows listed.  Every thread of the block calls it with the same arguments.
__device__ __forceinline__ int build_list(const float* __restrict__ scene_coeffs,
                                          const bool* __restrict__ scene_valid,
                                          const int32_t* __restrict__ scene_sil, int rows,
                                          const Box& block_box, int& cursor, float* s_coeff,
                                          int32_t* s_sil, uint8_t* s_odd, int* s_warp_count,
                                          int* s_cut) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  int count = 0;
  while (cursor < rows && count < kTileTriangles) {
    const int t = cursor + threadIdx.x;
    bool keep = false;
    float4 p0, p1, p2;
    if (t < rows && scene_valid[t]) {
      const float4* c4 =
          reinterpret_cast<const float4*>(scene_coeffs + static_cast<size_t>(t) * kNCoeff);
      p0 = c4[0];
      p1 = c4[1];
      p2 = c4[2];
      keep = !outside(p0, p1, p2, block_box);
    }
    // The last pass read its counts before its last barrier.
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) s_warp_count[warp] = __popc(ballot);
    __syncthreads();  // the counts are in, and the last list is consumed
    int slot = count + __popc(ballot & ((1u << lane) - 1u));
    int pass_kept = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_warp_count[w];
      slot += w < warp ? c : 0;
      pass_kept += c;
    }
    if (keep && slot < kTileTriangles) {
      float4* row = reinterpret_cast<float4*>(s_coeff + slot * kNCoeff);
      row[0] = p0;
      row[1] = p1;
      row[2] = p2;
      s_sil[slot] = scene_sil[t];
      s_odd[slot] = static_cast<uint8_t>(t & 1);
    }
    if (keep && slot == kTileTriangles) *s_cut = t;  // the first row that does not fit
    __syncthreads();
    if (count + pass_kept > kTileTriangles) {
      cursor = *s_cut;
      count = kTileTriangles;
    } else {
      cursor += kQueriesPerTile;
      count += pass_kept;
    }
  }
  return count;
}

// kCull: the scenes hold more rows than one list (n_tri > kTileTriangles), and each block
// lists the rows that can reach its queries; otherwise each block stages its scene's
// first n rows whole, once, for all of its tiles.
template <typename Query, bool kCull>
__global__ void __launch_bounds__(kQueriesPerTile,
                                  kCull ? kMinBlocksPerSMCull : kMinBlocksPerSMWhole)
query_points_kernel(const float* __restrict__ coeffs, const bool* __restrict__ tri_valid,
                    const int32_t* __restrict__ sil_id, const Query* __restrict__ u_in,
                    const Query* __restrict__ v_in, float* __restrict__ inv_out,
                    int32_t* __restrict__ id_out, unsigned long long* __restrict__ tally,
                    int n_tri, int n_query, int b0) {
  __shared__ __align__(16) float s_coeff[kTileTriangles * kNCoeff];  // the list's rows
  __shared__ int32_t s_sil[kTileTriangles];
  __shared__ uint8_t s_odd[kTileTriangles];  // t & 1 of a listed row's place in the scene
  __shared__ Box s_warp_box[kWarps];
  __shared__ int s_warp_bound[kWarps];
  __shared__ int s_warp_count[kWarps];
  __shared__ int s_cut;

  const int b = b0 + blockIdx.y;
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const float* scene_coeffs = coeffs + static_cast<size_t>(b) * n_tri * kNCoeff;
  const bool* scene_valid = tri_valid + static_cast<size_t>(b) * n_tri;
  const int32_t* scene_sil = sil_id + static_cast<size_t>(b) * n_tri;
  const size_t scene_queries = static_cast<size_t>(b) * n_query;
  const int q_block = blockIdx.x * kTilesPerBlock * kQueriesPerTile;

  // The scene's loop bound: index of its last valid triangle + 1 (0 if none).
  int last = 0;
  for (int t = threadIdx.x; t < n_tri; t += kQueriesPerTile) {
    if (scene_valid[t]) last = t + 1;
  }
  last = __reduce_max_sync(kFull, last);
  if (lane == 0) s_warp_bound[warp] = last;

  int count = 0;       // rows in the list
  int cursor = 0;      // the next scene row to test
  bool whole = false;  // the list holds every row the block keeps: the tiles share it
  int kept = 0;        // rows the block kept
  int n = 0;           // the scene's loop bound
  int rows = 0;        // the rows the block scans: n, or 0 where it keeps none
  Box block_box = {};
  if constexpr (kCull) {
    // The block's box: every non-NaN query of its tiles.
    Box mine = {INFINITY, -INFINITY, INFINITY, -INFINITY};
#pragma unroll
    for (int tile = 0; tile < kTilesPerBlock; ++tile) {
      const int q = q_block + tile * kQueriesPerTile + threadIdx.x;
      if (q < n_query) {
        const float u = as_float(u_in[scene_queries + q]);
        const float v = as_float(v_in[scene_queries + q]);
        if (!(isnan(u) || isnan(v))) mine = box_union(mine, {u, u, v, v});
      }
    }
    mine = warp_box(mine);
    if (lane == 0) s_warp_box[warp] = mine;
    const bool any_counted = __syncthreads_or(mine.u_lo <= mine.u_hi);
    block_box = s_warp_box[0];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      n = max(n, s_warp_bound[w]);
      block_box = box_union(block_box, s_warp_box[w]);
    }
    rows = any_counted ? n : 0;  // a block with no non-NaN query keeps no row
  } else {
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n = max(n, s_warp_bound[w]);
    rows = n;
    stage_whole(s_coeff, s_sil, scene_coeffs, scene_valid, scene_sil, rows);
    __syncthreads();
    count = kept = rows;
    whole = true;
  }

  for (int tile = 0; tile < kTilesPerBlock; ++tile) {
    const int q0 = q_block + tile * kQueriesPerTile;
    if (q0 >= n_query) break;
    const int q = q0 + threadIdx.x;
    const bool active = q < n_query;
    const Query raw_u = active ? u_in[scene_queries + q] : Query(0);
    const Query raw_v = active ? v_in[scene_queries + q] : Query(0);
    const float u = active ? as_float(raw_u) : __int_as_float(0x7fc00000);
    const float v = active ? as_float(raw_v) : __int_as_float(0x7fc00000);

    // Warp level: the warp's kBoxes query boxes; a NaN query never covers a triangle.
    const bool counted = !(isnan(u) || isnan(v));
    const unsigned counted_mask = __ballot_sync(kFull, counted);
    Box box[kBoxes];
    bool has[kBoxes];
#pragma unroll
    for (int g = 0; g < kBoxes; ++g) {
      box[g] = group_box(raw_u, raw_v, counted, g);
      has[g] = ((counted_mask >> (g * kBoxLanes)) & (kFull >> (kWarp - kBoxLanes))) != 0;
    }

    float best0 = 0.0f, best1 = 0.0f;
    int32_t id0 = 0, id1 = 0;
    if (!whole) cursor = 0;
    do {
      if constexpr (kCull) {
        if (!whole) {  // a round: the list from cursor on
          const bool first = cursor == 0;
          count = build_list(scene_coeffs, scene_valid, scene_sil, rows, block_box, cursor,
                             s_coeff, s_sil, s_odd, s_warp_count, &s_cut);
          if (tile == 0) kept += count;
          whole = first && cursor >= rows;
        }
      }
      if (counted_mask == 0) continue;  // no query of the warp can be covered
      for (int chunk = 0; chunk < count; chunk += kWarp) {
        // todo: the rows of this chunk that the warp evaluates.
        const int j_lane = chunk + lane;
        const float4* c4 =
            reinterpret_cast<const float4*>(s_coeff + min(j_lane, count - 1) * kNCoeff);
        const float4 p0 = c4[0], p1 = c4[1], p2 = c4[2];
        bool any = false;
#pragma unroll
        for (int g = 0; g < kBoxes; ++g) any |= has[g] & !outside(p0, p1, p2, box[g]);
        unsigned todo = __ballot_sync(kFull, j_lane < count && any);
        while (todo != 0) {
          const int j = chunk + __ffs(todo) - 1;
          todo &= todo - 1;
          const float4* r4 = reinterpret_cast<const float4*>(s_coeff + j * kNCoeff);
          const float4 r0 = r4[0], r1 = r4[1], r2 = r4[2];
          const float e0 = plane(r0.x, r0.y, r0.z, u, v);
          const float e1 = plane(r0.w, r1.x, r1.y, u, v);
          const float e2 = plane(r1.z, r1.w, r2.x, u, v);
          const bool covered = (e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f);
          // Where no lane is covered every s is 0, which changes no chain.
          if (!__any_sync(kFull, covered)) continue;
          const float inv = plane(r2.y, r2.z, r2.w, u, v);
          const float s = (covered && inv > 1e-12f) ? inv : 0.0f;
          if (kCull ? s_odd[j] != 0 : (j & 1) != 0) {  // the row's chain: t & 1
            if (s > best1) {
              best1 = s;
              id1 = s_sil[j];
            }
          } else if (s > best0) {
            best0 = s;
            id0 = s_sil[j];
          }
        }
      }
    } while (!whole && cursor < rows);
    if (active) {
      const bool sel = best1 > best0;
      inv_out[scene_queries + q] = sel ? best1 : best0;
      id_out[scene_queries + q] = sel ? id1 : id0;
    }
  }
  if (tally != nullptr && threadIdx.x == 0) {
    atomicAdd(tally, static_cast<unsigned long long>(n));
    atomicAdd(tally + 1, static_cast<unsigned long long>(kept));
  }
}

template <typename Query>
void launch(const void* coeffs, const void* tri_valid, const void* sil_id, const void* u,
            const void* v, void* inv_out, void* id_out, void* tally, int b, int n_tri,
            int n_query, cudaStream_t stream) {
  const int per_block = kQueriesPerTile * kTilesPerBlock;
  // The layout by the scenes' rows: a scene that one list holds is staged whole.
  const auto kernel = n_tri > kTileTriangles ? query_points_kernel<Query, true>
                                             : query_points_kernel<Query, false>;
  // The batch is grid y, which holds at most kMaxGridY scenes: one launch per slice.
  for (int b0 = 0; b0 < b; b0 += kMaxGridY) {
    const dim3 grid((n_query + per_block - 1) / per_block,
                    b - b0 < kMaxGridY ? b - b0 : kMaxGridY);
    kernel<<<grid, kQueriesPerTile, 0, stream>>>(
        static_cast<const float*>(coeffs), static_cast<const bool*>(tri_valid),
        static_cast<const int32_t*>(sil_id), static_cast<const Query*>(u),
        static_cast<const Query*>(v), static_cast<float*>(inv_out),
        static_cast<int32_t*>(id_out), static_cast<unsigned long long*>(tally), n_tri,
        n_query, b0);
  }
}


// ---------------------------------------------------------------------------------------
// scene_coeffs
// ---------------------------------------------------------------------------------------

constexpr int kTriangleFloats = 9;
constexpr int kPoseFloats = 16;
constexpr int kBoxFloats = 4;

struct Posed {
  float row[kNCoeff];
  float box[kBoxFloats];
  bool valid;
};

__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || isnan(a)) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || isnan(a)) ? a : b; }

// One triangle's focused-space row, box and validity (see "scene_coeffs" above).
__device__ __forceinline__ Posed pose_triangle(const float* __restrict__ tri,
                                               const float* __restrict__ pose, float fu,
                                               float fv, float pu, float pv, float z_min,
                                               bool cull, bool listed) {
  float u[3], v[3], iz[3];
  bool in_front = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = tri[3 * k], y = tri[3 * k + 1], z = tri[3 * k + 2];
    float c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* r = pose + 4 * i;
      c[i] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)), __fmul_rn(r[2], z)),
          r[3]);
    }
    const bool front = c[2] > z_min;
    in_front &= front;
    const float zs = front ? c[2] : 1.0f;
    u[k] = __fadd_rn(__fdiv_rn(__fmul_rn(c[0], fu), zs), pu);
    v[k] = __fadd_rn(__fdiv_rn(__fmul_rn(c[1], fv), zs), pv);
    iz[k] = __fdiv_rn(1.0f, zs);
  }
  float a[3], b[3], c[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int n = (e + 1) % 3;
    const float dv = __fsub_rn(v[n], v[e]);
    const float du = __fsub_rn(u[n], u[e]);
    a[e] = -dv;
    b[e] = du;
    c[e] = __fsub_rn(__fmul_rn(dv, u[e]), __fmul_rn(du, v[e]));
  }
  const float area = __fadd_rn(__fadd_rn(__fmul_rn(a[0], u[2]), __fmul_rn(b[0], v[2])), c[0]);
  const bool big = fabsf(area) > 1e-12f;
  const float sign = area >= 0.0f ? 1.0f : -1.0f;
  const float safe = big ? area : 1.0f;
  Posed p;
  p.valid = in_front && big && (area < 0.0f || !cull) && listed;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    p.row[3 * e] = __fmul_rn(a[e], sign);
    p.row[3 * e + 1] = __fmul_rn(b[e], sign);
    p.row[3 * e + 2] = __fmul_rn(c[e], sign);
  }
  p.row[9] = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(a[1], iz[0]), __fmul_rn(a[2], iz[1])), __fmul_rn(a[0], iz[2])),
      safe);
  p.row[10] = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(b[1], iz[0]), __fmul_rn(b[2], iz[1])), __fmul_rn(b[0], iz[2])),
      safe);
  p.row[11] = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(c[1], iz[0]), __fmul_rn(c[2], iz[1])), __fmul_rn(c[0], iz[2])),
      safe);
  p.box[0] = nan_min(nan_min(u[0], u[1]), u[2]);
  p.box[1] = nan_max(nan_max(u[0], u[1]), u[2]);
  p.box[2] = nan_min(nan_min(v[0], v[1]), v[2]);
  p.box[3] = nan_max(nan_max(v[0], v[1]), v[2]);
  return p;
}

// The inputs of one scene: its rows of each (B, T, ...) input (a scene stride of 0 for a
// batch expanded from one scene), its poses and its focused intrinsics.
struct Scene {
  const float* tri;
  const int32_t* owner;
  const int32_t* sil;
  const bool* listed;
  const bool* cull;
  const float* poses;
  float fu, fv, pu, pv;

  __device__ __forceinline__ Posed evaluate(int t, float z_min) const {
    return pose_triangle(tri + static_cast<size_t>(t) * kTriangleFloats,
                         poses + static_cast<size_t>(owner[t]) * kPoseFloats, fu, fv, pu, pv,
                         z_min, cull[t], listed[t]);
  }
};

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
scene_coeffs_kernel(const float* __restrict__ triangles, const int32_t* __restrict__ owner,
                    const int32_t* __restrict__ sil_id, const bool* __restrict__ tri_valid,
                    const bool* __restrict__ cull, long long tri_stride,
                    long long owner_stride, long long sil_stride, long long valid_stride,
                    long long cull_stride, const float* __restrict__ poses,
                    const float* __restrict__ fu, const float* __restrict__ fv,
                    const float* __restrict__ pu, const float* __restrict__ pv,
                    float* __restrict__ coeffs_out, bool* __restrict__ valid_out,
                    int32_t* __restrict__ sil_out, float* __restrict__ bbox_out, int n_tri,
                    int n_poses, float z_min) {
  constexpr int kWarps = kThreads / kWarp;
  __shared__ __align__(16) float s_row[kThreads * kNCoeff];
  __shared__ __align__(16) float s_box[kThreads * kBoxFloats];
  __shared__ int32_t s_sil[kThreads];
  __shared__ bool s_valid[kThreads];
  __shared__ int s_warp_valid[kWarps];

  const int b = blockIdx.x;
  const Scene scene = {triangles + b * tri_stride,
                       owner + b * owner_stride,
                       sil_id + b * sil_stride,
                       tri_valid + b * valid_stride,
                       cull + b * cull_stride,
                       poses + static_cast<size_t>(b) * n_poses * kPoseFloats,
                       fu[b], fv[b], pu[b], pv[b]};

  // Pass 1: the scene's valid triangles.
  int n_valid = 0;
  for (int base = 0; base < n_tri; base += kThreads) {
    const int t = base + threadIdx.x;
    n_valid += __syncthreads_count(t < n_tri && scene.evaluate(t, z_min).valid);
  }

  // Pass 2: each triangle to its row, valid rows first, each run in the order of t.
  const size_t out_row0 = static_cast<size_t>(b) * n_tri;
  float4* coeffs4 = reinterpret_cast<float4*>(coeffs_out + out_row0 * kNCoeff);
  float4* bbox4 = reinterpret_cast<float4*>(bbox_out + out_row0 * kBoxFloats);
  const float4* s_row4 = reinterpret_cast<const float4*>(s_row);
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  int valid_done = 0, invalid_done = 0;  // rows of each run written by earlier tiles
  for (int base = 0; base < n_tri; base += kThreads) {
    const int t = base + threadIdx.x;
    const int count = min(kThreads, n_tri - base);
    const bool active = t < n_tri;
    Posed p;
    if (active) p = scene.evaluate(t, z_min);
    const bool valid = active && p.valid;
    const unsigned ballot = __ballot_sync(kFull, valid);
    if (lane == 0) s_warp_valid[warp] = __popc(ballot);
    __syncthreads();  // the warps' counts are in, and the last tile's rows are stored
    int before = __popc(ballot & ((1u << lane) - 1u));
    int tile_valid = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = s_warp_valid[w];
      before += w < warp ? n : 0;
      tile_valid += n;
    }
    if (active) {
      const int slot = valid ? before : tile_valid + (threadIdx.x - before);
      float4* row = reinterpret_cast<float4*>(s_row + slot * kNCoeff);
      row[0] = make_float4(p.row[0], p.row[1], p.row[2], p.row[3]);
      row[1] = make_float4(p.row[4], p.row[5], p.row[6], p.row[7]);
      row[2] = make_float4(p.row[8], p.row[9], p.row[10], p.row[11]);
      reinterpret_cast<float4*>(s_box)[slot] = make_float4(p.box[0], p.box[1], p.box[2],
                                                           p.box[3]);
      s_sil[slot] = scene.sil[t];
      s_valid[slot] = valid;
    }
    __syncthreads();
    const int invalid_row0 = n_valid + invalid_done - tile_valid;
    for (int i = threadIdx.x; i < count * 3; i += kThreads) {
      const int slot = i / 3;
      const int dest = slot < tile_valid ? valid_done + slot : invalid_row0 + slot;
      coeffs4[static_cast<size_t>(dest) * 3 + (i - 3 * slot)] = s_row4[i];
    }
    if (threadIdx.x < count) {
      const int slot = threadIdx.x;
      const int dest = slot < tile_valid ? valid_done + slot : invalid_row0 + slot;
      bbox4[dest] = reinterpret_cast<const float4*>(s_box)[slot];
      sil_out[out_row0 + dest] = s_sil[slot];
      valid_out[out_row0 + dest] = s_valid[slot];
    }
    valid_done += tile_valid;
    invalid_done += count - tile_valid;
  }
}

template <int kThreads>
void launch_scene_coeffs(const void* triangles, const void* owner, const void* sil_id,
                         const void* tri_valid, const void* cull, long long tri_stride,
                         long long owner_stride, long long sil_stride,
                         long long valid_stride, long long cull_stride, const void* poses,
                         const void* fu, const void* fv, const void* pu, const void* pv,
                         void* coeffs_out, void* valid_out, void* sil_out, void* bbox_out,
                         int b, int n_tri, int n_poses, float z_min, cudaStream_t stream) {
  scene_coeffs_kernel<kThreads><<<b, kThreads, 0, stream>>>(
      static_cast<const float*>(triangles), static_cast<const int32_t*>(owner),
      static_cast<const int32_t*>(sil_id), static_cast<const bool*>(tri_valid),
      static_cast<const bool*>(cull), tri_stride, owner_stride, sil_stride, valid_stride,
      cull_stride, static_cast<const float*>(poses), static_cast<const float*>(fu),
      static_cast<const float*>(fv), static_cast<const float*>(pu),
      static_cast<const float*>(pv), static_cast<float*>(coeffs_out),
      static_cast<bool*>(valid_out), static_cast<int32_t*>(sil_out),
      static_cast<float*>(bbox_out), n_tri, n_poses, z_min);
}

}  // namespace

extern "C" {

// u, v: (B, n_query) float32, or int32 when int_queries is nonzero.  tally: null, or
// two uint64 on the card to which the blocks add their loop bounds and kept rows.
int m3t_query_eval(const void* coeffs, const void* tri_valid, const void* sil_id,
                   const void* u, const void* v, void* inv_out, void* id_out, int b,
                   int n_tri, int n_query, int int_queries, void* tally, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int_queries) {
    launch<int32_t>(coeffs, tri_valid, sil_id, u, v, inv_out, id_out, tally, b, n_tri,
                    n_query, s);
  } else {
    launch<float>(coeffs, tri_valid, sil_id, u, v, inv_out, id_out, tally, b, n_tri,
                  n_query, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// One block a scene: threads is 32, 64, 128 or 256.  triangles (B, T, 3, 3) f32, owner
// and sil_id (B, T) int32, tri_valid and cull (B, T) bool, each scene's rows contiguous
// at the given scene stride (in elements); poses (B, n_poses, 4, 4) f32 and fu, fv, pu,
// pv (B,) f32 contiguous.  Out: coeffs (B, T, 12) f32, valid (B, T) bool, sil (B, T)
// int32 and bbox (B, T, 4) f32, contiguous.
int m3t_scene_coeffs(const void* triangles, const void* owner, const void* sil_id,
                     const void* tri_valid, const void* cull, long long tri_stride,
                     long long owner_stride, long long sil_stride, long long valid_stride,
                     long long cull_stride, const void* poses, const void* fu,
                     const void* fv, const void* pu, const void* pv, void* coeffs_out,
                     void* valid_out, void* sil_out, void* bbox_out, int b, int n_tri,
                     int n_poses, float z_min, int threads, void* stream) {
  decltype(&launch_scene_coeffs<kWarp>) launch_fn = nullptr;
  switch (threads) {
    case 32: launch_fn = launch_scene_coeffs<32>; break;
    case 64: launch_fn = launch_scene_coeffs<64>; break;
    case 128: launch_fn = launch_scene_coeffs<128>; break;
    case 256: launch_fn = launch_scene_coeffs<256>; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  launch_fn(triangles, owner, sil_id, tri_valid, cull, tri_stride, owner_stride, sil_stride,
            valid_stride, cull_stride, poses, fu, fv, pu, pv, coeffs_out, valid_out, sil_out,
            bbox_out, b, n_tri, n_poses, z_min, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
