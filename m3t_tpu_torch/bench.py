"""Throughput and latency of the fused tracking cycles on one card (port of bench.py).

Computes bench.py's workloads mode by mode and times them as bench.py does: full
tracking cycles (5 correspondence x 2 update iterations, n_lines=200, scales {6,4,2,1},
histogram adaptation: the reference's default RBOT-class configuration, tracker.h:79-84
and region_modality.h:411-422) for a batch of bodies on a rendered 640x512 frame, with
the generated sparse-viewpoint model of a geodesic sphere.

Prints ONE JSON line on stdout, last: bench.py's keys and label strings (body-frames/s
against the reference's single-core C++ rate of ~770 fps per object, ICG/readme.md:10;
or, with --latency, ms per cycle at B in {1, 8, 64} against the 33 ms budget,
tracker.h:82-83), plus ``"device"``: the card's name, the device count and its power
limit from nvidia-smi (``{"name": "cpu"}`` under ``--device cpu``).  Everything else goes
to stderr.

Usage: python -m m3t_tpu_torch.bench [n_bodies] [--bodies N] [--rgbd | --occlusion |
           --kinematic | --kinematic-rgbd | --ycb | --latency] [--iters N] [--windows N]
           [--device cuda]

Modes, as bench.py has them:
  --rgbd           region + depth fusion (ICG configuration)
  --occlusion      region cycle with per-iteration focused scene evaluation, modeled
                   occlusions and region checking (tracker.cpp:448-451)
  --kinematic      articulated structures (2-link revolute chains, Mb-ICG class)
  --kinematic-rgbd articulated structures with per-link region + depth fusion (RTB)
  --ycb            the YCB-Video configuration: region 200 lines + depth 200 points,
                   measured occlusions both ways, 128 pre-matched texture terms
  --latency        ms per region cycle at B in {1, 8, 64}

What equals bench.py: the PipelineConfigs, intrinsics, models (RegionModel and
DepthModel of the bench sphere, 162 views at 800 px, through from_models), frames, scenes
and kinematic structures, and the random draws of one ``np.random.default_rng(0)`` in
bench.py's order (frame noise; x, then y jitter; each latency batch's x jitter; the YCB
texture points).  The model caches are bench.py's file names in the temporary directory
(``tempfile.gettempdir()``, /tmp unless TMPDIR says otherwise); one that is missing or
differs from the committed ``m3t_tpu_torch/data/bench_sphere_*_model.npz``, which equal
freshly generated models bit for bit, is first copied from it.  Frames, models and scenes are batched as
views of one body's tensors, where bench.py materializes copies; the values are equal.
The unused B-sized histogram start of --latency is left out.

bench.py's kinematic structure is kept with both of its faults (ROADMAP Queue C 2): its
constraint restates the child's one free direction, so every KKT system is singular,
the step is zeroed and the structures never move; and both links share one body, so the
frame shows the parent only, 0.13 m from where the structure starts.  The runner
computes what bench.py computes; a repaired structure (chip_smoke.py phase 6k) is a
choice for the benchmark's cells, not of this runner.

Timing follows bench.py: two synchronized warm-up cycles (one per latency batch), then
windows of ``max(iters // windows, 3)`` cycles, each ending in a device synchronize and a
host read of the poses (the joint poses in the kinematic modes), through
utils/benchtime.py's median-of-windows policy.  bench.py's whole-run sanity floors are
TPU rates that apply only on a TPU, so the floor here is 0.  The cycles are graphed, as
bench.py's are jitted: the first warm-up cycle captures the CUDA graph (graphs.py), as
bench.py's compiles, and the timed cycles replay it.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from m3t_tpu_torch.common import resolve_device

MODES = ("rgbd", "occlusion", "kinematic", "kinematic_rgbd", "ycb", "latency")
WIDTH, HEIGHT, N_LINES, N_POINTS = 640, 512, 200, 200
DEPTH_SCALE = 0.001
LATENCY_BATCHES = (1, 8, 64)
BASELINE_FPS = 770.0  # fps per object, single CPU core (ICG readme abstract)
DATA = Path(__file__).resolve().parent / "data"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Workload(NamedTuple):
    """One timed workload: ``cycle(state) -> state``, the initial ``state``, ``sync(state)``
    (waits for the device and reads the poses to the host), bench.py's ``label``, the
    body-frames one cycle tracks, the tensors the cycle reads (``inputs``) and the
    PipelineConfig it runs (``pcfg``)."""

    cycle: Callable
    state: object
    sync: Callable
    label: str
    body_frames: int
    inputs: dict
    pcfg: object


def _cached_model(cls, name: str, body, file: str):
    """bench.py's model of ``body`` through its cache file in the temporary directory,
    copied from the committed npz when the file is absent or differs from it (written by
    bench.py, or stale)."""
    path = Path(tempfile.gettempdir()) / f"m3t_bench_{file}_model.npz"
    committed = DATA / f"bench_sphere_{file}_model.npz"
    if not (path.exists() and filecmp.cmp(path, committed, shallow=False)):
        partial = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        shutil.copyfile(committed, partial)
        os.replace(partial, path)
    model = cls(name, body, str(path), n_divides=2, n_points=N_POINTS, image_size=800)
    if not model.SetUp():
        raise RuntimeError(f"{name} failed to set up from {path}")
    return model


def _frames(frame, n: int, device):
    """One frame on device, expanded (a view) to n."""
    frame = torch.as_tensor(frame, device=device)
    return frame.expand((n,) + frame.shape)


def _sync(device, field: str):
    def sync(state):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        getattr(state, field).cpu()
    return sync


def build_workload(mode: str, n_bodies: int, device="cuda") -> list[Workload]:
    """bench.py's workload of ``mode`` ("region" or one of MODES) at n_bodies on device:
    one Workload, or for "latency" one per batch of LATENCY_BATCHES."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.common import Intrinsics
    from m3t_tpu_torch.depth_model import DepthModel
    from m3t_tpu_torch.ops.region_fn import RegionConfig
    from m3t_tpu_torch.region_model import RegionModel
    from m3t_tpu_torch.utils import procedural

    if mode != "region" and mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    pcfg = pipeline.PipelineConfig(
        cfg=RegionConfig(n_lines_max=N_LINES),
        scales=(6, 4, 2, 1), standard_deviations=(15.0, 5.0, 3.5, 1.5),
        n_corr_iterations=5, n_update_iterations=2,
        use_depth=(mode in ("rgbd", "kinematic_rgbd", "ycb")))
    if mode == "ycb":
        # evaluate_ycb_dataset.cpp:46-117: scales {7,4,2}, sigma {25,15,10}, 4 corr x 2
        # update iterations, measured occlusions on both modalities.
        pcfg = pcfg._replace(
            scales=(7, 4, 2), standard_deviations=(25.0, 15.0, 10.0),
            n_corr_iterations=4, region_measure_occlusions=True,
            depth_measure_occlusions=True, use_texture=True)
    intr_t = Intrinsics(fu=520.0, fv=520.0, ppu=WIDTH / 2 - 0.5, ppv=HEIGHT / 2 - 0.5,
                        width=WIDTH, height=HEIGHT)
    intr = (intr_t.fu, intr_t.fv, intr_t.ppu, intr_t.ppv)

    body = procedural.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    triangles = body.triangle_vertices_f_body()
    model_1 = pipeline.RegionModelArrays.from_models(
        [_cached_model(RegionModel, "bench_model", body, "region")], N_LINES, device=dev)

    rng = np.random.default_rng(0)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.6
    frame = procedural.render_synthetic_color_frame(triangles, intr_t, pose0,
                                                    noise_rng=rng)
    planar = np.ascontiguousarray(np.moveaxis(frame, -1, 0))
    poses = np.tile(pose0, (n_bodies, 1, 1))
    poses[:, 0, 3] += rng.uniform(-0.004, 0.004, n_bodies).astype(np.float32)
    poses[:, 1, 3] += rng.uniform(-0.004, 0.004, n_bodies).astype(np.float32)

    if mode == "latency":
        workloads = []
        for b_lat in LATENCY_BATCHES:
            poses_l = np.tile(pose0, (b_lat, 1, 1))
            poses_l[:, 0, 3] += rng.uniform(-0.004, 0.004, b_lat).astype(np.float32)
            inputs = dict(images=_frames(planar, b_lat, dev), model=model_1.expand(b_lat),
                          poses=torch.as_tensor(poses_l, device=dev))

            def cycle(state, inputs=inputs):
                return pipeline.tracking_cycle(pcfg, intr, inputs["images"],
                                               inputs["model"], state)

            state = pipeline.initialize_histograms(pcfg, intr, inputs["images"],
                                                   inputs["model"], inputs["poses"])
            workloads.append(Workload(cycle, state, _sync(dev, "body2camera_pose"),
                                      f"B={b_lat}", b_lat, inputs, pcfg))
        return workloads

    inputs = dict(images=_frames(planar, n_bodies, dev), model=model_1.expand(n_bodies),
                  poses=torch.as_tensor(poses, device=dev))
    if mode not in ("kinematic", "kinematic_rgbd"):
        state = pipeline.initialize_histograms(pcfg, intr, inputs["images"],
                                               inputs["model"], inputs["poses"])
    if mode in ("rgbd", "ycb", "kinematic_rgbd"):
        pcfg = pcfg._replace(depth_cfg=pcfg.depth_cfg._replace(n_points_max=N_POINTS))
        depth_frame = procedural.render_synthetic_depth_frame(triangles, intr_t, pose0)
        depth_1 = pipeline.DepthModelArrays.from_models(
            [_cached_model(DepthModel, "bench_depth_model", body, "depth")], N_POINTS,
            device=dev)

    if mode in ("rgbd", "ycb"):
        from m3t_tpu_torch.ops.texture_fn import TexturePoints

        inputs.update(depth_images=_frames(depth_frame, n_bodies, dev),
                      depth_model=depth_1.expand(n_bodies), texture_points=None)
        if mode == "ycb":
            k_tex = 128
            inputs["texture_points"] = TexturePoints(
                torch.as_tensor(rng.normal(scale=0.04, size=(n_bodies, k_tex, 3)),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rng.uniform(0, WIDTH, size=(n_bodies, k_tex, 2)),
                                dtype=torch.float32, device=dev),
                torch.as_tensor(rng.random((n_bodies, k_tex)) > 0.3, device=dev))

        def cycle(state):
            return pipeline.tracking_cycle_rgbd(
                pcfg, intr, intr, DEPTH_SCALE, inputs["images"], inputs["depth_images"],
                inputs["model"], inputs["depth_model"], state,
                texture_points=inputs["texture_points"])

        if mode == "ycb":
            label = (f"body-frames/s per chip, YCB-Video flagship cycle "
                     f"(B={n_bodies}, 640x512, 200 lines + 200 points + "
                     f"measured occlusions both ways + 128 texture terms, "
                     f"4x2 iters)")
        else:
            label = (f"body-frames/s per chip, region+depth (ICG) cycle "
                     f"(B={n_bodies}, 640x512, 200 lines + 200 points, "
                     f"5x2 iters)")
    elif mode == "occlusion":
        from m3t_tpu_torch.ops.occlusion import SceneGeometry
        from m3t_tpu_torch.ops.raster import decimate_mesh

        pcfg = pcfg._replace(region_model_occlusions=True, region_checking=True,
                             focused_image_size=128)
        v, t = decimate_mesh(body.vertices, body.triangles, 256)
        tv = v[t]
        n_tri = len(tv)
        inputs["scene_geom"] = SceneGeometry.from_numpy(dict(
            triangles=tv[None], owner=np.zeros((1, n_tri), np.int32),
            sil_id=np.full((1, n_tri), (int(body.body_id) << 8) | int(body.region_id)),
            tri_valid=np.ones((1, n_tri), bool), cull=np.ones((1, n_tri), bool),
            ref_owner=np.zeros((1, 1), np.int32),
            ref_radius=np.full((1, 1), 0.5 * body.maximum_body_diameter, np.float32),
            ref_valid=np.ones((1, 1), bool), body_id=np.full((1,), int(body.body_id)),
            region_id=np.full((1,), int(body.region_id))), dev).expand(n_bodies)

        def cycle(state):
            return pipeline.tracking_cycle(pcfg, intr, inputs["images"], inputs["model"],
                                           state, scene_geom=inputs["scene_geom"])

        label = (f"body-frames/s per chip, region cycle + per-iteration occlusion "
                 f"rendering/region checking (B={n_bodies}, {n_tri} tris, "
                 f"128^2 focused, 5x2 iters)")
    elif mode in ("kinematic", "kinematic_rgbd"):
        from m3t_tpu_torch.constraint import Constraint
        from m3t_tpu_torch.link import Link
        from m3t_tpu_torch.ops import kinematics
        from m3t_tpu_torch.ops.occlusion import build_kinematic_scene_geometry
        from m3t_tpu_torch.optimizer import Optimizer

        # S structures of 2 links (parent + revolute child) with a closed-chain hard
        # constraint and per-link link-on-link occlusions (bench.py:273-306): B == S * 2.
        s_structs = max(n_bodies // 2, 1)
        n_bodies = s_structs * 2
        b2j = np.eye(4, dtype=np.float32)
        b2j[0, 3] = 0.13
        link_p = Link("bench_lp", body)
        link_c = Link("bench_lc", body, body2joint_pose=b2j,
                      free_directions=[False, False, True, False, False, False])
        link_p.AddChildLink(link_c)
        if not (link_c.SetUp() and link_p.SetUp()):
            raise RuntimeError("the bench structure's links failed to set up")
        link_p.set_link2world_pose(pose0)
        constraint = Constraint(
            "bench_constraint", link_p, link_c, body22joint2_pose=b2j,
            constraint_directions=[True, True, False, True, True, True])
        opt = Optimizer("bench_opt", link_p)
        if not (constraint.SetUp() and opt.AddConstraint(constraint) and opt.SetUp()):
            raise RuntimeError("the bench structure's optimizer failed to set up")
        n_hist = pcfg.cfg.n_histogram_bins ** 3
        uniform = torch.full((s_structs, 2, n_hist), 1.0 / n_hist, dtype=torch.float32,
                             device=dev)
        state = pipeline.KinematicTrackingState(
            kinematics.initial_joint2parent([opt], device=dev).expand(
                s_structs, 2, 4, 4).contiguous(), uniform, uniform.clone())
        pcfg = pcfg._replace(region_model_occlusions=True, region_checking=True,
                             focused_image_size=128)
        scene_1 = build_kinematic_scene_geometry([[body, body]], decimate_to=128,
                                                 device=dev)
        inputs.update(
            images=_frames(planar, s_structs, dev), model=model_1.expand(n_bodies),
            kin=kinematics.build_kinematic_model([opt], device=dev).expand(s_structs),
            scene_geom=type(scene_1)(*(a.repeat((s_structs,) + (1,) * (a.dim() - 1))
                                       for a in scene_1)))
        depth = {}
        if mode == "kinematic_rgbd":
            inputs.update(depth_images=_frames(depth_frame, s_structs, dev),
                          depth_model=depth_1.expand(n_bodies))
            depth = dict(depth_intr=intr, depth_scale=DEPTH_SCALE,
                         depth_images=inputs["depth_images"],
                         depth_model=inputs["depth_model"])
            label = (f"body-frames/s per chip, articulated RGB-D cycle "
                     f"(S={s_structs} 2-link constrained structures, 200 lines "
                     f"+ 200 points per link, link-on-link occlusions, "
                     f"adjoint-chain KKT, 5x2 iters)")
        else:
            label = (f"body-frames/s per chip, articulated tracking cycle "
                     f"(S={s_structs} 2-link constrained structures, "
                     f"link-on-link occlusions, adjoint-chain KKT, 5x2 iters)")

        def cycle(state):
            return pipeline.tracking_cycle_kinematic(
                pcfg, intr, inputs["images"], inputs["model"], inputs["kin"], state,
                scene_geom=inputs["scene_geom"], **depth)

        return [Workload(cycle, state, _sync(dev, "joint2parent"), label, n_bodies,
                         inputs, pcfg)]
    else:
        def cycle(state):
            return pipeline.tracking_cycle(pcfg, intr, inputs["images"], inputs["model"],
                                           state)

        label = (f"body-frames/s per chip, region tracking cycle "
                 f"(B={n_bodies}, 640x512, 200 lines, 5x2 iters, real model)")
    return [Workload(cycle, state, _sync(dev, "body2camera_pose"), label, n_bodies,
                     inputs, pcfg)]


def _warm(work: Workload, n_cycles: int):
    """The workload's state after n_cycles synchronized cycles."""
    state = work.state
    for _ in range(n_cycles):
        state = work.cycle(state)
        work.sync(state)
    return state


def _window(work: Workload, state_box: list, n_cycles: int) -> Callable[[], float]:
    def timed_window():
        begin = time.perf_counter()
        for _ in range(n_cycles):
            state_box[0] = work.cycle(state_box[0])
        work.sync(state_box[0])
        return time.perf_counter() - begin
    return timed_window


def device_record(device) -> dict:
    """The device a result ran on: the card's name, the device count and its power limit
    in W (nvidia-smi), or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu"}
    index = device.index if device.index is not None else torch.cuda.current_device()
    limit = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip()
    return {"name": torch.cuda.get_device_name(index), "count": torch.cuda.device_count(),
            "power_limit_w": float(limit)}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_bodies_pos", nargs="?", type=int, default=None)
    parser.add_argument("--bodies", type=int, default=512)
    parser.add_argument("--iters", type=int, default=100,
                        help="total timed iterations, split across windows")
    parser.add_argument("--windows", type=int, default=5)
    parser.add_argument("--rgbd", action="store_true")
    parser.add_argument("--occlusion", action="store_true")
    parser.add_argument("--kinematic", action="store_true")
    parser.add_argument("--kinematic-rgbd", dest="kinematic_rgbd", action="store_true")
    parser.add_argument("--ycb", action="store_true")
    parser.add_argument("--latency", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    from m3t_tpu_torch.utils import benchtime

    cli = parse_args(argv)
    dev = resolve_device(cli.device)
    mode = "region"
    for flag in MODES:
        if getattr(cli, flag):
            mode = flag
    n_bodies = cli.n_bodies_pos if cli.n_bodies_pos is not None else cli.bodies
    iters_w = max(cli.iters // cli.windows, 3)
    begin = time.perf_counter()
    workloads = build_workload(mode, n_bodies, dev)
    log(f"{mode}: built in {time.perf_counter() - begin:.1f} s on {dev}")

    if mode == "latency":
        latencies, spreads, unstable = {}, {}, False
        for work in workloads:
            state_box = [_warm(work, 1)]
            stats = benchtime.measure_windows(_window(work, state_box, iters_w),
                                              cli.windows)
            latencies[work.body_frames] = stats.median_s / iters_w * 1000.0
            spreads[work.body_frames] = [round(stats.min_s / iters_w * 1000.0, 2),
                                         round(stats.max_s / iters_w * 1000.0, 2)]
            unstable = unstable or stats.unstable
        ms1 = latencies[1]
        result = {
            "metric": ("ms/cycle serve latency, region tracking cycle "
                       "(640x512, 200 lines, 5x2 iters; 33 ms budget = "
                       "tracker.h:82-83)"),
            "value": round(ms1, 2),
            "unit": "ms/cycle (B=1)",
            "vs_baseline": round(33.0 / ms1, 3),
            "latency_ms_per_cycle": {str(k): round(v, 2) for k, v in latencies.items()},
            "spread_ms_per_cycle": {str(k): v for k, v in spreads.items()},
            "unstable": unstable,
        }
    else:
        work = workloads[0]
        state_box = [_warm(work, 2)]
        per_window = float(iters_w * work.body_frames)
        stats = benchtime.measure_with_floor(
            _window(work, state_box, iters_w), per_window, floor_rate=0.0,
            n_windows=cli.windows, pause=lambda: time.sleep(5.0))
        rate = stats.rate(per_window)
        lo, hi = stats.rate_spread(per_window)
        result = {
            "metric": work.label,
            "value": round(rate, 1),
            "unit": "body-frames/s",
            "vs_baseline": round(rate / BASELINE_FPS, 3),
            "spread": [round(lo, 1), round(hi, 1)],
            "windows": len(stats.times),
            "unstable": stats.unstable,
        }
    result["device"] = device_record(dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
