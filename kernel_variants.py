#!/usr/bin/env python3
"""Time source variants of the port's sample_lines and query_eval kernels against each
other, and against a baseline copy of the kernel sources, on one CUDA device.

Run from the repository root on a machine with one CUDA device:

    python3 kernel_variants.py [--baseline DIR] [--reps N]

Each variant is the committed source of m3t_tpu_torch/csrc/region_kernels.cu or
occlusion_kernels.cu with the text edits listed in VARIANTS, built with nvcc into its own
library and called through ctypes on the inputs that chip_smoke.py's phase 2 gives the
kernels at the flagship shapes (B=512): sample_lines on the region path's ratio calls
(kp 120, 80, 40, 24), bins mode on the kp=120 lines and the histogram walk (LP=512,
kp=24); query_eval on the first call of an occlusion-path cycle (Q=9600) and on the
silhouette (Q=200) and depth modeled-occlusion (Q=7200) calls of an RGB-D cycle with
a cube occluder, each with its cull on and off.  ``--baseline DIR`` adds DIR's
region_kernels.cu and occlusion_kernels.cu (the kernels of an earlier commit, whose
query_eval takes the loop bound from its caller and float pixels) as the variant
"baseline".  Every result is compared with the plain twin first (probe variants, which
skip the evaluation to time the rest, are not); times are medians of CUDA-graph
replays of 20 calls (chip_smoke.time_ms).  The variants run in turn, ``--reps`` times
over, and one line per (rep, variant, case) is printed, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "m3t_tpu_torch" / "csrc"
K1_BOUNDS = "__launch_bounds__(kLinesPerBlock * kStepRowsPerBlock, kBlocksPerSM)"
K4_EVAL = "        unsigned todo = __ballot_sync(kFull, keep);\n"
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
}


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
                             "-Xcompiler", "-fPIC", "-shared", "-o", str(so), str(cu)],
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
                        help="a directory with an earlier region_kernels.cu and "
                             "occlusion_kernels.cu")
    parser.add_argument("--reps", type=int, default=2)
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
    sources = {"sample_lines": "region_kernels.cu", "query_eval": "occlusion_kernels.cu"}
    variant_sources = {}
    for kernel, file in sources.items():
        committed = (CSRC / file).read_text()
        for name, edits in VARIANTS[kernel].items():
            variant_sources[kernel, name] = edited(f"{kernel} {name}", committed, edits)
        if args.baseline:
            variant_sources[kernel, "baseline"] = (args.baseline / file).read_text()
    jobs = {key: build(" ".join(key), source, args.out)
            for key, source in variant_sources.items()}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for (kernel, name), (so, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        if kernel == "sample_lines":
            lib.m3t_sample_lines.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
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
    bin_crop, k1_cases = k1_inputs(inp, state, bt)
    k4_cases = k4_inputs(inp, state, bt)

    for rep in range(args.reps):
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
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
