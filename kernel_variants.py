#!/usr/bin/env python3
"""Time source variants of the port's sample_lines, query_eval and sample_windows
kernels against each other, and against a baseline copy of the kernel sources, on one
CUDA device.

Run from the repository root on a machine with one CUDA device:

    python3 kernel_variants.py [--baseline DIR] [--reps N] [--kernels NAME ...]

Each variant is the committed source of m3t_tpu_torch/csrc/region_kernels.cu,
occlusion_kernels.cu or depth_kernels.cu with the text edits listed in VARIANTS, built
with nvcc into its own library and called through ctypes on the inputs that
chip_smoke.py's phase 2 gives the kernels at the flagship shapes (B=512): sample_lines
on the region path's ratio calls (kp 120, 80, 40, 24), bins mode on the kp=120 lines and
the histogram walk (LP=512, kp=24); query_eval on the first call of an occlusion-path
cycle (Q=9600) and on the silhouette (Q=200) and depth modeled-occlusion (Q=7200) calls
of an RGB-D cycle with a cube occluder, each with its cull on and off; sample_windows
on the RGB-D path's correspondence windows (K = 11, 5, 3) and measured-occlusion
windows (K = 6) on the shared frame, and at K = 11 on 512 distinct frames.
``--baseline DIR`` adds DIR's region_kernels.cu, occlusion_kernels.cu and
depth_kernels.cu (the kernels of an earlier commit, whose query_eval takes the loop
bound from its caller and float pixels, and whose sample_windows reads a per-cycle
int32 crop through (B, 4, LP) float params) as the variant "baseline"; for
sample_windows it times that commit's whole window stage per call (its share of the
crop gather, the params, its kernel, the slice, permute and cast to (B, P, K, K) f32),
from the short copy of those steps kept here.  Every result is compared with the plain
twin first (probe variants, which skip the evaluation to time the rest, are not);
times are medians of CUDA-graph replays of 20 calls (chip_smoke.time_ms).  Each build
prints the register counts that ptxas reports for the variant.  The variants run in
turn, ``--reps`` times over, and one line per (rep, variant, case) is printed,
then sample_windows' time per RGB-D cycle (its five calls) per variant, then the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "m3t_tpu_torch" / "csrc"
K1_BOUNDS = "__launch_bounds__(kLinesPerBlock * kStepRowsPerBlock, kBlocksPerSM)"
K4_EVAL = "        unsigned todo = __ballot_sync(kFull, keep);\n"
# sample_windows variants are edits of depth_kernels.cu, which ships only the winner.
K3_BOUNDS = "__launch_bounds__(kThreads, kBlocksPerSM)"
K3_VECTOR_STORE = """\
      for (int e = 0; e < kElemsPerThread; e += 4) {
        __stcs(reinterpret_cast<float4*>(dst + e),
               make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]));
      }
"""
K3_SCALAR_STORE = "      for (int e = 0; e < kElemsPerThread; ++e) __stcs(dst + e, vals[e]);\n"
K3_INCLUDES = "#include <stdint.h>\n"
K3_PLAIN_STORES = K3_INCLUDES + "#define __stcs(ptr, value) (*(ptr) = (value))\n"
K3_GROUPS = "  const int n_groups = (n + lead"
# Lane l of a warp takes outputs l + 32 e of the warp's span of 32 * kElemsPerThread
# outputs: each gather instruction reads 32 consecutive samples, each store writes 128
# contiguous bytes.
K3_LANE_STRIPES = """\
  {
    constexpr int kSpan = 32 * kElemsPerThread;
    const int lane = threadIdx.x & 31;
    const int n_spans = (n + kSpan - 1) / kSpan;
    for (int span = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; span < n_spans;
         span += (gridDim.x * blockDim.x) >> 5) {
      float vals[kElemsPerThread];
#pragma unroll
      for (int e = 0; e < kElemsPerThread; ++e) {
        const int j = span * kSpan + lane + 32 * e;
        vals[e] = j < n ? body.sample_at(j, k, kk) : 0.0f;
      }
#pragma unroll
      for (int e = 0; e < kElemsPerThread; ++e) {
        const int j = span * kSpan + lane + 32 * e;
        if (j < n) __stcs(out + first + j, vals[e]);
      }
    }
    return;
  }
""" + K3_GROUPS
# One block of 1024 threads per body: the body's (C, C) crop (0 outside the frame) is
# staged in shared memory, 128 KB at C=256, then each thread writes one output at a time.
K3_ARGS = "struct Args {"
K3_STAGED_KERNEL = """\
template <int K>
__global__ void __launch_bounds__(1024, 1)
    sample_windows_staged(const uint16_t* __restrict__ image, long long batch_stride, int h,
                          int w, const int32_t* __restrict__ u_min,
                          const int32_t* __restrict__ v_min,
                          const int32_t* __restrict__ stride,
                          const int32_t* __restrict__ corner_u,
                          const int32_t* __restrict__ corner_v, float* __restrict__ out,
                          int p, int k_runtime, int c, int b0) {
  extern __shared__ uint16_t crop[];
  const int k = K > 0 ? K : k_runtime;
  const int kk = k * k;
  const int b = b0 + blockIdx.x;
  const uint16_t* plane = image + static_cast<size_t>(b) * static_cast<size_t>(batch_stride);
  const int cu = __ldg(corner_u + b), cv = __ldg(corner_v + b);
  for (int i = threadIdx.x; i < c * c; i += blockDim.x) {
    const int y = wrap_add(cv, i / c), x = wrap_add(cu, i % c);
    const bool ok = static_cast<unsigned>(y) < static_cast<unsigned>(h) &&
                    static_cast<unsigned>(x) < static_cast<unsigned>(w);
    crop[i] = ok ? __ldg(plane + static_cast<size_t>(y) * w + x) : 0;
  }
  __syncthreads();
  const size_t offset = static_cast<size_t>(b) * p;
  const int n = p * kk;
  float* dst = out + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int pi = j / kk, rem = j - pi * kk, kv = rem / k, ku = rem - kv * k;
    const int s = __ldg(stride + offset + pi);
    const int r = clamp_crop(wrap_madd(wrap_sub(__ldg(v_min + offset + pi), cv), kv, s), c);
    const int col = clamp_crop(wrap_madd(wrap_sub(__ldg(u_min + offset + pi), cu), ku, s), c);
    __stcs(dst + j, static_cast<float>(crop[r * c + col]));
  }
}

""" + K3_ARGS
K3_LAUNCH = "    sample_windows_kernel<K><<<grid, kThreads, 0, stream>>>(\n"
K3_STAGED_LAUNCH = """\
    const int smem = a.c * a.c * static_cast<int>(sizeof(uint16_t));
    cudaFuncSetAttribute(sample_windows_staged<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    sample_windows_staged<K><<<grid.y, 1024, smem, stream>>>(
"""
VARIANTS = {
    "sample_lines": {
        "committed": [],
        "unroll 1": [("kUnroll = 2;", "kUnroll = 1;")],
        "unroll 4": [("kUnroll = 2;", "kUnroll = 4;")],
        "unroll 8, no block bound": [("kUnroll = 2;", "kUnroll = 8;"),
                                     (K1_BOUNDS, K1_BOUNDS.replace(", kBlocksPerSM", ""))],
    },
    "query_eval": {
        "committed": [],
        "one box per warp": [("kBoxLanes = 16;", "kBoxLanes = 32;")],
        "one query tile per block": [("kTilesPerBlock = 4;", "kTilesPerBlock = 1;")],
        # Everything but the evaluation of the surviving triangles.
        "probe: no evaluation": [(K4_EVAL, K4_EVAL + "        id0 ^= todo;\n        todo = 0;\n")],
    },
    "sample_windows": {
        "committed": [],
        "one output per thread": [("kElemsPerThread = 4;", "kElemsPerThread = 1;"),
                                  (K3_VECTOR_STORE, K3_SCALAR_STORE)],
        "eight outputs per thread": [("kElemsPerThread = 4;", "kElemsPerThread = 8;")],
        "sixteen outputs per thread": [("kElemsPerThread = 4;", "kElemsPerThread = 16;")],
        "plain stores": [(K3_INCLUDES, K3_PLAIN_STORES)],
        "crop staged, one output per thread": [(K3_ARGS, K3_STAGED_KERNEL),
                                               (K3_LAUNCH, K3_STAGED_LAUNCH)],
        "no block bound": [(K3_BOUNDS, K3_BOUNDS.replace(", kBlocksPerSM", ""))],
        "lanes on consecutive outputs": [(K3_GROUPS, K3_LANE_STRIPES)],
        "lanes on consecutive outputs, 8 each": [(K3_GROUPS, K3_LANE_STRIPES),
                                                 ("kElemsPerThread = 4;",
                                                  "kElemsPerThread = 8;")],
    },
}
# sample_windows calls per flagship RGB-D cycle, by case (correspondence K = 11, 5, 3).
K3_PER_CYCLE = {"K=11": 1, "K=5": 1, "K=3": 3}
K3_CALLS_PER_CROP = sum(K3_PER_CYCLE.values())  # the old stage gathered one crop per cycle


def edited(name: str, source: str, edits) -> str:
    for old, new in edits:
        if old not in source:
            raise ValueError(f"variant {name!r}: edit target not found: {old!r}")
        source = source.replace(old, new)
    return source


def build(name: str, source: str, out_dir: Path):
    """Start nvcc on one variant's source; returns (library path, process)."""
    from m3t_tpu_torch.ops import _cuda

    stem = "".join(ch if ch.isalnum() else "_" for ch in name)
    cu = out_dir / f"{stem}.cu"
    cu.write_text(source)
    so = out_dir / f"lib{stem}.so"
    proc = subprocess.Popen([_cuda._nvcc(), *_cuda.ARCH_FLAGS, "-std=c++17", "-O3",
                             "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-shared", "-o",
                             str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return so, proc


def k1_inputs(inp, state, bt):
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import region_fast as rf

    pcfg, intr, cfg = inp["pcfg"], inp["intr"], inp["pcfg"].cfg
    poses = bt["poses"]
    bin_crop, cu, cv = pipeline._prepare_crops(pcfg, intr, bt["images"], poses)
    rtab = rf.ratio_table(state.histogram_f, state.histogram_b)
    points = pipeline._select_view_cl(bt["model"], poses)
    c = pcfg.crop_size
    cases = []
    for scale in pcfg.scales:
        geo = rf.line_geometry(cfg, scale, points, cs.N_LINES, poses, *intr, cs.WIDTH,
                               cs.HEIGHT, cu, cv, c, pcfg.lp)
        kp = rf.round_up(cfg.line_length_in_segments * scale, 8)
        cases.append((f"ratio kp={kp}", geo.params, rtab, kp, "ratio"))
        if scale == max(pcfg.scales):
            cases.append((f"bins kp={kp}", geo.params, None, kp, "bins"))
    params, mask = rf.histogram_walk_geometry(cfg, points, cs.N_LINES, poses, *intr,
                                              cs.WIDTH, cs.HEIGHT, cu, cv, c, 2 * pcfg.lp)
    cases.append((f"walk bins kp={mask.shape[-1]} LP={2 * pcfg.lp}", params, None,
                  mask.shape[-1], "bins"))
    return bin_crop, cases


def k4_inputs(inp, state, bt):
    from m3t_tpu_torch import pipeline

    dev = bt["poses"].device
    occ = cs.occlusion_path(inp)
    with cs.recorded_queries() as calls:
        cs.region_cycle(occ, cs.batch_of(occ, cs.N_BODIES, dev), state)
    cases = [("occlusion path", calls[0][0])]
    scene = cs.occluded(inp)
    bts = cs.batch_of(scene, cs.N_BODIES, dev)
    sst = pipeline.initialize_histograms(scene["pcfg"], inp["intr"], bts["images"],
                                         bts["model"], bt["poses"])
    with cs.recorded_queries() as calls:
        cs.rgbd_cycle("rgbd_pcfg")(scene, bts, sst)
    return cases + [("rgbd silhouette", calls[1][0]), ("rgbd modeled occlusion", calls[2][0])]


def k3_inputs(inp, bt):
    """(name, image, (u_min, v_min, stride, corner_u, corner_v), k) of chip_smoke's
    sample_windows rows on the shared frame, and K=11 on distinct frames."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import depth_fast as df

    rgbd, intr, poses = inp["rgbd_pcfg"], inp["intr"], bt["poses"]
    frames = bt["depth_images"]
    corners = df.depth_corners(frames, poses, *intr, rgbd.crop_size)
    centers = pipeline._select_depth_view(bt["depth_model"], poses).center_f_body
    cases = []
    for cd in rgbd.considered_distances:
        u_min, v_min, stride, k = df.correspondence_windows(rgbd.depth_cfg, cd, centers,
                                                           poses, *intr)
        cases.append((f"K={k}", frames, (u_min, v_min, stride, *corners), k))
    u_min, v_min, _, _, stride = df.occlusion_windows(
        rgbd.depth_cfg.measured_occlusion_radius, False, centers, poses, *intr, cs.WIDTH,
        cs.HEIGHT)
    cases.append(("occlusion K=6", frames, (u_min, v_min, stride, *corners), 6))
    cases.append(("distinct frames K=11", cs.rolled_frames(frames), cases[0][2], 11))
    return rgbd.crop_size, cases


def sample_windows_call(lib, image, geometry, c, k):
    b, h, w = image.shape
    u_min = geometry[0]
    out = torch.empty((b, u_min.shape[1], k, k), device=image.device)
    err = lib.m3t_sample_windows(image.data_ptr(), image.stride(0), h, w,
                                 *(g.data_ptr() for g in geometry), out.data_ptr(), b,
                                 u_min.shape[1], k, c,
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sample_windows variant failed to launch: cudaError {err}")
    return out


def old_crops(image, corner_u, corner_v, c):
    """The per-cycle (B, C, C) int32 depth crop of the crop-based window stage that
    depth_kernels.cu replaced (m3t_tpu/ops/depth_fast.py::depth_crops, untransposed, on
    a frame at least as large as the crop): an index gather through the int16 view."""
    dev = image.device
    ar = torch.arange(c, device=dev)
    rows = (corner_v.long()[:, None] + ar)[:, :, None]
    cols = (corner_u.long()[:, None] + ar)[:, None, :]
    body = torch.arange(image.shape[0], device=dev)[:, None, None]
    return image.view(torch.int16)[body, rows, cols].to(torch.int32) & 0xFFFF


def old_params(u_min, v_min, stride, corner_u, corner_v, k):
    """The old stage's (B, 4, LP) f32 kernel params, as
    m3t_tpu/ops/depth_fast.py::_fetch_strided_windows builds them."""
    from m3t_tpu_torch.ops.region_fast import round_up

    b, p = u_min.shape
    kv = torch.arange(k, dtype=torch.int32, device=u_min.device)
    v_rows = (v_min - corner_v[:, None])[:, :, None] + kv * stride[:, :, None]
    params = torch.zeros((b, 4, round_up(p * k, 128)), device=u_min.device)
    params[:, 0, :p * k] = ((u_min - corner_u[:, None]).to(torch.float32)[:, :, None]
                            .expand(b, p, k).reshape(b, p * k))
    params[:, 1, :p * k] = v_rows.to(torch.float32).reshape(b, p * k)
    params[:, 2, :p * k] = (stride.to(torch.float32)[:, :, None].expand(b, p, k)
                            .reshape(b, p * k))
    return params


def old_kernel(lib, params, crop, k):
    """The old kernel (a baseline depth_kernels.cu): its padded (B, kp, LP) int32
    output."""
    from m3t_tpu_torch.ops.region_fast import round_up

    b, _, lp = params.shape
    out = torch.empty((b, round_up(k, 8), lp), dtype=torch.int32, device=params.device)
    err = lib.m3t_sample_windows(params.data_ptr(), crop.data_ptr(), out.data_ptr(), b, lp,
                                 out.shape[1], crop.shape[-1],
                                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"baseline sample_windows failed to launch: cudaError {err}")
    return out


def old_windows(lib, crop, geometry, k):
    """The old stage after the crop: params, the old kernel, then the slice, permute and
    cast to (B, P, K, K) f32."""
    b, p = geometry[0].shape
    out = old_kernel(lib, old_params(*geometry, k), crop, k)
    return out[:, :k, :p * k].reshape(b, k, p, k).permute(0, 2, 3, 1).to(torch.float32)


def k3_times(rep, name, lib, c, cases, per_cycle):
    """Times one sample_windows variant on every case (the baseline: the old whole stage,
    its crop's share included) and adds each correspondence case's share to
    per_cycle[name]."""
    from m3t_tpu_torch.ops import depth_fast as df

    for case, image, geometry, k in cases:
        if name == "baseline":
            crop = old_crops(image, *geometry[3:], c)
            if rep == 0 and not torch.equal(old_windows(lib, crop, geometry, k),
                                            df.sample_windows_plain(image, *geometry, c, k)):
                raise AssertionError(f"sample_windows baseline {case}: != plain")
            params = old_params(*geometry, k)
            crop_ms = cs.time_ms(lambda: old_crops(image, *geometry[3:], c), 20,
                                 graph=True)
            rest_ms = cs.time_ms(lambda: old_windows(lib, crop, geometry, k), 20,
                                 graph=True)
            kernel_ms = cs.time_ms(lambda: old_kernel(lib, params, crop, k), 20,
                                   graph=True)
            ms = crop_ms / K3_CALLS_PER_CROP + rest_ms
            detail = (f"  (crop {crop_ms:.4f} / {K3_CALLS_PER_CROP} calls + params, kernel, "
                      f"cast {rest_ms:.4f}; kernel alone {kernel_ms:.4f})")
        else:
            def call(lib=lib, image=image, geometry=geometry, k=k):
                return sample_windows_call(lib, image, geometry, c, k)
            if rep == 0 and not torch.equal(call(), df.sample_windows_plain(image, *geometry,
                                                                            c, k)):
                raise AssertionError(f"sample_windows {name} {case}: != plain")
            ms, detail = cs.time_ms(call, 20, graph=True), ""
        per_cycle[name] = per_cycle.get(name, 0.0) + ms * K3_PER_CYCLE.get(case, 0)
        print(f"rep {rep} sample_windows {name:<28} {case:<24} {ms:.4f}{detail}", flush=True)


def sample_lines_call(lib, bin_crop, params, table, kp, output):
    b, _, lp = params.shape
    ratio = output == "ratio"
    out = torch.empty((b, kp, lp), dtype=torch.float32 if ratio else torch.int32,
                      device=params.device)
    err = lib.m3t_sample_lines(params.data_ptr(), bin_crop.data_ptr(),
                               table.data_ptr() if ratio else None, out.data_ptr(), b, lp,
                               kp, bin_crop.shape[-1], table.shape[1] if ratio else 0,
                               int(ratio), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sample_lines variant failed to launch: cudaError {err}")
    return out


def query_eval_call(lib, args, cull: bool, baseline: bool):
    from m3t_tpu_torch.ops import occlusion

    coeffs, valid, sil, u, v = args
    b = coeffs.shape[0]
    int_queries = not baseline and u.dtype == torch.int32 and v.dtype == torch.int32
    qtype = torch.int32 if int_queries else torch.float32
    uq, vq = (x.reshape(b, -1).to(qtype).contiguous() for x in (u, v))
    coeffs, valid, sil = (x.contiguous() for x in (coeffs, valid, sil))
    inv = torch.empty(uq.shape, device=uq.device)
    ids = torch.empty(uq.shape, dtype=torch.int32, device=uq.device)
    stream = torch.cuda.current_stream().cuda_stream
    if baseline:
        nvalid = occlusion.leading_valid_count(valid)
        err = lib.m3t_query_eval(coeffs.data_ptr(), valid.data_ptr(), sil.data_ptr(),
                                 nvalid.data_ptr(), uq.data_ptr(), vq.data_ptr(),
                                 inv.data_ptr(), ids.data_ptr(), b, coeffs.shape[1],
                                 uq.shape[1], stream)
    else:
        err = lib.m3t_query_eval(coeffs.data_ptr(), valid.data_ptr(), sil.data_ptr(),
                                 uq.data_ptr(), vq.data_ptr(), inv.data_ptr(),
                                 ids.data_ptr(), b, coeffs.shape[1], uq.shape[1],
                                 int(int_queries), int(cull), stream)
    if err:
        raise RuntimeError(f"query_eval variant failed to launch: cudaError {err}")
    return inv.reshape(u.shape), ids.reshape(u.shape)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path,
                        help="a directory with an earlier region_kernels.cu, "
                             "occlusion_kernels.cu and depth_kernels.cu")
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--kernels", nargs="+", choices=list(VARIANTS),
                        default=list(VARIANTS), help="the kernels to time (default all)")
    parser.add_argument("--out", type=Path, default=ROOT / "m3t_tpu_torch" / "_build" /
                        "variants", help="where the variant sources and libraries go")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import occlusion
    from m3t_tpu_torch.ops import region_fast as rf

    args.out.mkdir(parents=True, exist_ok=True)
    sources = {"sample_lines": "region_kernels.cu", "query_eval": "occlusion_kernels.cu",
               "sample_windows": "depth_kernels.cu"}
    variant_sources = {}
    for kernel in args.kernels:
        file = sources[kernel]
        committed = (CSRC / file).read_text()
        for name, edits in VARIANTS[kernel].items():
            variant_sources[kernel, name] = edited(f"{kernel} {name}", committed, edits)
        if args.baseline:
            baseline = (args.baseline / file).read_text()
            if baseline == committed:
                print(f"baseline {file} equals the committed source: not timed again")
            else:
                variant_sources[kernel, "baseline"] = baseline
    jobs = {key: build(" ".join(key), source, args.out)
            for key, source in variant_sources.items()}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for (kernel, name), (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        registers = sorted({int(n) for n in re.findall(r"Used (\d+) registers", log)})
        print(f"{kernel} {name}: ptxas registers per thread {registers}")
        lib = ctypes.CDLL(str(so))
        if kernel == "sample_lines":
            lib.m3t_sample_lines.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        elif kernel == "sample_windows" and name == "baseline":
            lib.m3t_sample_windows.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        elif kernel == "sample_windows":
            lib.m3t_sample_windows.argtypes = ([ptr, ctypes.c_longlong, i32, i32] + [ptr] * 6
                                               + [i32] * 4 + [ptr])
        elif name == "baseline":
            lib.m3t_query_eval.argtypes = [ptr] * 8 + [i32] * 3 + [ptr]
        else:
            lib.m3t_query_eval.argtypes = [ptr] * 7 + [i32] * 5 + [ptr]
        libs[kernel, name] = lib

    dev = torch.device("cuda")
    inp = cs.flagship_inputs("cuda", cs.N_BODIES)
    bt = cs.batch_of(inp, cs.N_BODIES, dev)
    state = pipeline.initialize_histograms(inp["pcfg"], inp["intr"], bt["images"],
                                           bt["model"], bt["poses"])
    if "sample_lines" in args.kernels:
        bin_crop, k1_cases = k1_inputs(inp, state, bt)
    if "query_eval" in args.kernels:
        k4_cases = k4_inputs(inp, state, bt)
    if "sample_windows" in args.kernels:
        crop_size, k3_cases = k3_inputs(inp, bt)

    k3_per_cycle = []
    for rep in range(args.reps):
        k3_per_cycle.append({})
        # The variants in turn, reversed every other rep: change, baseline, baseline, change.
        order = list(libs.items())
        if rep % 2:
            order.reverse()
        for (kernel, name), lib in order:
            if kernel == "sample_lines":
                for case, params, table, kp, output in k1_cases:
                    def call(lib=lib, params=params, table=table, kp=kp, output=output):
                        return sample_lines_call(lib, bin_crop, params, table, kp, output)
                    if rep == 0 and not torch.equal(
                            call(), rf.sample_lines_plain(params, bin_crop, table, kp, output)):
                        raise AssertionError(f"sample_lines {name} {case}: != plain")
                    print(f"rep {rep} sample_lines {name:<26} {case:<28} "
                          f"{cs.time_ms(call, 20, graph=True):.4f}", flush=True)
                continue
            if kernel == "sample_windows":
                k3_times(rep, name, lib, crop_size, k3_cases, k3_per_cycle[rep])
                continue
            for case, qargs in k4_cases:
                for cull in ((True,) if name == "baseline" else (True, False)):
                    def call(lib=lib, qargs=qargs, cull=cull, baseline=name == "baseline"):
                        return query_eval_call(lib, qargs, cull, baseline)
                    if rep == 0 and not name.startswith("probe"):
                        inv, ids = call()
                        want_inv, want_ids = occlusion.query_eval_plain(*qargs)
                        if not (torch.equal(inv.view(torch.int32), want_inv.view(torch.int32))
                                and torch.equal(ids, want_ids)):
                            raise AssertionError(f"query_eval {name} {case}: != plain")
                    label = f"{case} cull={cull}" if name != "baseline" else case
                    print(f"rep {rep} query_eval   {name:<26} {label:<28} "
                          f"{cs.time_ms(call, 20, graph=True):.4f}", flush=True)
    for rep, times in enumerate(k3_per_cycle):
        for name, ms in times.items():
            print(f"rep {rep} sample_windows {name:<28} per RGB-D cycle {ms:.4f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
