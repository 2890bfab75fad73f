#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (m3t_tpu_torch): every kernel against its
plain twin, every path, entry point and graph run to its checks.  It times nothing:
benchmark/run.py measures the port on the card.

Run from the repository root on a machine with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):
  1. the card: name and power limit from nvidia-smi;
  0m. model generation on the host: bench.py's region and depth models of the sphere,
     all 162 views, built by the port (Body, RegionModel/DepthModel.SetUp(), the g++
     host library's rasterizer and contour tracer) with no cache file, in two processes
     started together, each timed in its process, and held
     equal to the committed m3t_tpu_torch/data npz (every array and the checksum); the
     phases below stack them with from_models, not from the npz;
  2. build the Hopper kernels from m3t_tpu_torch/csrc (ops/_cuda.py declares them) and
     hold each against its plain PyTorch twin at the flagship shapes, on inputs the
     flagship paths produce (sample_lines ratio mode at kp 136/120/80/40/24, the scales
     of every path driven below, bins mode on the kp=120 and kp=24 lines and the walk's
     LP=512 kp=24; bin_counts at (512, 6144, 4096); sample_windows on the RGB-D path's
     shared frame at K = 11, 5, 3 for the correspondence windows, K = 6 for the
     measured-occlusion windows and K = 7 (the kernel's runtime-K instantiation), at
     K = 11 on 512 distinct frames (the shared frame rolled by a per-body offset, 335
     MB: not L2-resident) and on a 200x160 frame under the 256-pixel crop (0 beyond the
     frame); query_eval on the calls that one occlusion-path cycle makes (B=512,
     Q=9600), on the silhouette (Q=200) and depth modeled-occlusion (Q=7200) calls of
     one RGB-D cycle with a cube occluder and all four scene checks, on 1600 random
     triangles, which take four shared-memory tiles, on the calls of one kinematic cycle
     (B=512 per-link scenes), and on the adversarial case at B=512
     (adversarial_queries); newton_step on the first Newton step of one region cycle
     (B=512) and on its body 0 alone; scene_coeffs on the first focused scenes of one
     occlusion-path cycle and of one kinematic cycle, and on the kinematic cell's shape
     (robot_scenes: 1792 scenes of 2240 triangles, its four outputs, not only what the
     queries read); every result must equal its twin exactly (query_eval's inverse
     depths bit for bit), but newton_step's poses within NEWTON_STEP_ATOL (its pose @
     variation sums in another order), here and wherever a recorded call is held
     against its twin (twin_mismatches);
  3. the flagship region cycle, bench.py's default workload: B=512 bodies, 640x512
     frames, 200 lines, scales {6,4,2,1}, 5 correspondence x 2 update iterations,
     histogram adaptation, the sphere model of phase 0m, through initialize_histograms
     and tracking_cycle, graphed (its first cycle captures the CUDA graph);
  4. the flagship RGB-D (ICG) cycle, bench.py --rgbd: phase 3 plus 200 depth points per
     body on a depth frame rendered at the initial pose (depth scale 1 mm, depth
     intrinsics equal to the colour ones), through tracking_cycle_rgbd;
  5. the YCB-Video parameters, bench.py --ycb: scales {7,4,2}, sigma {25,15,10}, 4x2
     iterations, measured occlusions on both modalities and 128 texture terms per body,
     B=512.  bench.py's texture terms are random points matched to random pixels; here
     they are points of the sphere's camera-facing half at their projections at the
     rendered pose plus 1 px of noise, 30 % of them invalid, so that tracking stays
     checkable;
  6. the flagship occlusion path, bench.py --occlusion: phase 3 with modeled occlusions
     and region checking against the focused scene (the tracked sphere decimated to 98
     triangles, 128x128 focused crop), evaluated at the current pose every
     correspondence iteration through scene_coeffs and query_eval (5 launches each per
     cycle);
  6k. the articulated paths, bench.py --kinematic and --kinematic-rgbd: S=256 two-link
     structures (B=512 links) of the committed bench structure
     (m3t_tpu_torch/data/bench_kinematic_model.npz: the sphere, a child sphere on a
     joint at 0.13 m and a closed-chain constraint over [T,T,F,T,T,T]), per-link scenes
     holding both links decimated to 128 triangles (128x128 focused crop, modeled
     occlusions and region checking), 200 lines, 5x2 iterations, through
     initialize_kinematic_histograms and tracking_cycle_kinematic; the RGB-D path adds
     200 depth points per link.  Three departures from bench.py, each a fault of its
     structure (ROADMAP Queue C): the child is free in all six directions, so that the
     constraint is what makes the joint revolute (bench.py's constraint restates the
     child's one free direction, which makes every KKT system singular: the step is
     zeroed and the structure never moves); both links are rendered into the colour and
     depth frames, at the structure's initial poses, the child in green (bench.py renders
     the parent only, 0.13 m from where its structure starts, since its two links share
     one body); and the root starts with the ±4 mm x/y jitter of the rigid paths;
     in phases 3-6k StartModality and PATH_CYCLES cycles run, every kernel launch count
     set to 0 just before the path runs and asserted just after; poses must be finite
     and within 5 mm of the rendered pose (of each link); in one more cycle of each
     RGB-D path (RGB-D, YCB, kinematic RGB-D) no aten operation may read the depth
     frame (no depth crop: only sample_windows reads the frame);
  7. card against CPU at B=8 (the first 8 bodies, or 4 structures): StartModality, then
     3 cycles, each started on both devices from the same state; every kernel call the
     card makes equal to its plain twin on the same inputs, and poses and histograms
     within atol 1e-4, body by body.  Seven cases: the region cycle; the RGB-D cycle
     with measured occlusions, on a depth frame with a wall 0.3 m from the camera over
     its left half; with a 3 cm cube 0.45 m from the camera in front of the sphere's
     left side (in the colour and depth frames and in the scene), the region cycle with
     both region scene checks and the RGB-D cycle with all four; the YCB cycle with
     texture terms; and the kinematic cycle with scenes and the kinematic RGB-D cycle
     (joint poses and histograms).  In each of the last three, one body (structure) may
     part beyond 1e-4 at a rounding boundary of the plain arithmetic, two in the
     kinematic RGB-D cycle; each is logged by number (check_card_against_cpu).  Phase 7
     runs every case before it fails on any.
     The card's masks must drop region lines and depth points against the same
     correspondences without the wall's measured occlusions, and without the cube's
     scene checks;
  8. the scale-out paths (m3t_tpu_torch.parallel and the multi-camera cycles), every
     batch entry with colour and depth frames of its own, made on the card:
     8s. the sequence scans: B=512 sequences of 6 frames of the flagship sphere moving
         1 mm along x per frame (3.0 GB of colour and 2.0 GB of depth frames), frame 0
         starting the histograms, track_sequences_scan and track_sequences_scan_rgbd
         over the other 5 (each step's graph captured at its first step), every pose of
         every step within 5 mm of the sphere in that frame, and every kernel call of
         one RGB-D scan step held against its twin;
     8c. the multi-camera rigid RGB-D cycle with all four scene checks: phase 7's
         sphere and cube seen by the reference camera and by a camera 20 degrees to the
         side of the sphere and 5 degrees off its axis, B=512 bodies x 2 cameras (1.0 GB
         and 0.67 GB of frames), through initialize_multicamera_histograms and
         make_sharded_cycle(mesh=None, with_depth=True, with_scene=True);
     8k. the multi-camera articulated RGB-D cycle: phase 6k's S=256 structures seen by
         two cameras (the second 20 degrees to the side of the structure), per-link
         scenes in each camera, through make_sharded_kinematic_cycle;
     8c and 8k run as phases 3-6k do (graphed, each cycle built once; launch counts
     asserted, every body or link within 5 mm, peak memory); every kernel call of one
     8c cycle is held against its twin, a frame of its own per batch entry;
     8x. in phase 7's loop, card against CPU at B=8 (S=4) and C=2: one step of the RGB-D
         scan, the multi-camera rigid cycle with texture terms per camera, and the
         multi-camera articulated cycle (which may part at one named structure per
         camera: it has twice the link views of the one-camera case);
     8d. python -m m3t_tpu_torch.parallel.dryrun --processes 2 --device cuda --backend
         gloo: two processes of a (1, 2) mesh on the one card (two NCCL ranks cannot share
         a card), held against one process, every multi-camera cycle graphed (a capture
         and two replays on each rank); its exit code decides.
  9. the reference-shaped serve path (Tracker, modalities, links, optimizers and the fused
     serve backend), through Tracker.RunTrackerProcess(execute_detection=True,
     start_tracking=True, max_iterations=6) with use_fused_cycle=True over phase 8s's
     six frames (one ImageColorCamera, and an ImageDepthCamera with the same
     extrinsics), every body a Body of the bench sphere with its own Link,
     RegionModality (200 lines, scales {6,4,2,1}), Optimizer and StaticDetector at its
     jittered pose, all sharing phase 0m's models; the backend must be built (no
     "fused cycle unavailable" notice), the kernels launched per tracking step as the
     bare cycle launches them and none in the starting step, every body within 5 mm of
     the sphere in the last frame, and peak memory read:
     9s. the region graph at B=512;
     9d. 9s with a DepthModality per body (200 points, the phase 0m depth model);
     9l. both graphs at B=1;
     9x. in phase 7's loop, both graphs at B=8 and at B=1 (9l's kernel shapes) on the
         card and on the CPU: 3 serve steps, each started on both devices from the CPU's
         state (fused_serve.read_graph_state and load_graph_state), poses and histograms
         body by body within
         atol 1e-4, every kernel call of the card's steps equal to its twin.
  10. the host path of the object graph (renderers, the host scene checks, hard and soft
     constraints and the host KKT step), through Tracker.RunTrackerProcess(
     execute_detection=True, start_tracking=True, max_iterations=6) over six colour and
     uint16 depth frames rendered by the port's host rasterizer (the bodies moving 1 mm
     along x per frame), the modalities' five host-path functions graphed
     (correspondences, gradient and Hessian, colour additions: one CUDA graph per
     static key; the renders stay eager, see 10o), with every kernel launch count set to 0
     before it (the host path must launch none), the fused backend's refusal asserted
     (with the JAX package's reason), every tensor of the graph asserted on the card and
     every link within 5 mm of its rendered pose in the last frame; the graphs captured
     and peak memory read:
     10o. an occluded scene of a YCB-Video frame's size: five Body objects of the phase
         0m sphere (ids 1-5, set explicitly) at 0.45-0.6 m, two of them overlapping in
         the image, and phase 7's cube (id 6, untracked) in front of one, in one
         RendererGeometry; each sphere with a RegionModality (bench.py's region
         parameters) and a DepthModality (200 points) wired as eval/ycb_evaluator.py
         wires a body, both measuring occlusions on the depth camera and modelling them
         with a FocusedBasicDepthRenderer, the region modality checking regions and the
         depth modality silhouettes on a FocusedSilhouetteRenderer(id_type=REGION) (200
         px crops referencing the body); 5x2 iterations; the graph "models occlusions".
         Also one FullNormalRenderer image of the scene at 640x512 on the card and on the
         CPU: the share of pixels whose triangle id differs (at most 0.1 %), and the
         largest depth and normal differences where the ids agree; and the graph's ten
         focused renderers rendering in three forms on the card: eagerly with each chunk
         of triangles over its window (the renderers' form, also on the CPU), eagerly
         over the whole image, and through the graphed rasterize (whole image): the
         images equal;
     10k. four copies of phase 6k's structure (bench.py:285-306, the child free in all
         six directions with a Body of its own), each link with region and depth
         modalities that model link-on-link occlusions through FocusedBasicDepthRenderers,
         the hard Constraint of bench.py (a revolute joint about z) and a SoftConstraint
         bounding the child's translation; 5x2 iterations; the graph "has constraints";
     10x. both graphs at their full sizes on the card and on the CPU: 2 steps, each
         started on both devices from the CPU's state (fused_serve.read_graph_state and
         load_graph_state: joint poses, link poses, histograms), poses and histograms
         within atol 1e-4 entry by entry (a body or a structure); at most one entry per
         case may part, within 1e-2 in pose and 1e-3 in histograms (the occluded
         graph's histogram_b: 3e-3), logged by name and step, and only where a second
         CPU graph, started every step from the CPU's state with every link pose moved
         by a relative 1e-7 (at step 0, its detector's pose), parts from the CPU at the
         same entry and step: a rounding-boundary event of the plain arithmetic, which
         the CPU meets alone.
  11. the evaluators (m3t_tpu_torch/eval) and their entry points on synthetic datasets in
     the published layouts, in a temporary directory, each frame rendered by the port's
     host rasterizer, written by its PNG writer and read back equal by its reader; the
     bodies are clusters of spheres (no symmetry), their models generated in parallel
     processes (n_divides 1; RBOT's at image_size 800, the others' at 400) and copied
     under every body name of the same mesh; no model is generated during a run:
     11w. the datasets: RBOT (18 body names, 4 sequences of 10 frames at 640x512, the
         squirrel_small partner crossing in d_occlusion), YCB-Video (2 sequences of 3
         bodies at 640x480, 8-bit BGR and 16-bit depth at 0.1 mm, detector poses 4 mm off),
         RTB (a two-link revolute structure through its tracker_config/config.yaml, 2
         sequences with ground-truth depth), OPT (1920x1080) and Choi (640x480);
     11r. RBOT through the entry point's configuration (modelled occlusions and region
         checking, 200 lines): 72 runs and 18 hidden partners, B = 90, fused, every
         kernel launch counted from 0: sample_lines, bin_counts, query_eval and
         newton_step launched in every frame's cycle; tracking success, peak memory;
         then python -m
         m3t_tpu_torch.examples.evaluate_rbot_dataset on the same files must print the
         same tracking success;
     11y, 11k, 11o. YCB-Video fused RGB-D, RTB fused kinematic with depth, OPT and Choi
         through the serve path (execute_tracking_step_maybe_fused): sample_lines,
         bin_counts and sample_windows launched in every cycle or step (and newton_step
         but on RTB's articulated cycle), scores held;
     11h. RBOT, YCB-Video and RTB on the host path, 3 frames each;
     11x. card against CPU on the same files: RBOT (2 bodies x a_regular and d_occlusion,
         5 frames), YCB-Video, RTB, OPT and Choi: per batch entry the same success flag
         per frame, every scored pose within PHASE7_ATOL and the scores within it, every
         kernel call of the card's run equal to its twin; at most one entry per case may
         part, within 1e-2 in pose and 1e-3 in histograms, and only where the CPU on
         inputs nudged by a relative WITNESS_NUDGE parts too (then the scored poses
         within 1e-2 and the scores within 1e-3).  cv2 must not have been imported.
     A line names what the card's machine cannot run for want of cv2 and is held on the
     CPU only: the TextureModality, loader frames other than PNG and the viewers' display
     and saving.
  12. the other entry points of examples/ (m3t_tpu_torch/examples), on phase 11's
     datasets and models, every Tracker step recorded with its launches:
     12r. record_camera_sequence records 12 frames at 640x480 from a stand-in for
         cv2.VideoCapture (a module named cv2 for the block, as tests/test_hardware_
         cameras.py fakes it) whose frames show phase 11's four-sphere cluster along a
         known path; the PNG files must read back as the frames and the loader metafile
         give the device's intrinsics; run_on_recorded_sequence replays them through that
         metafile (phase 11's region model), fused, then with --host-path: exit 0, K1 6,
         K2 2 and K5 10 launches in every fused tracking step and none in the starting
         step, none on the host path, the final pose within 5 mm of the path; peak
         memory;
     12r, 12g and 12p hold every kernel call of their runs against its plain twin on
         the same inputs after each run (twin_checked);
     12g. run_generated_tracker over a generator config with one link over 12r's
         recording (use_fused_cycle in its tracker metafile), --max-iterations 10: K1 6,
         K2 2 and K5 10 per step; run_pen_paper_demo on the same config exits 1 with
         "trajectory points: 0" (its main() adds the publisher after SetUp, a fault of
         the JAX script that the port keeps), and its DrawingPublisher, added before the
         tracker's last SetUp, projects 10 tip points;
     12p. the six studies, each over a two-value grid: parameter_study_rbot_dataset
         --fused over n_lines_max {100, 200} (18 bodies x 4 sequences, 10 frames, the
         published grid's 32-bin histograms), parameter_study.py rbot over n_lines_max
         (its rows equal: the fused RBOT evaluator ignores the setter), YCB-Video over
         n_corr_iterations (rows equal: its fused path ignores the tracker grid; the
         study's 21 BODY_NAMES tied to the dataset's three), RTB over scales, OPT over
         learning_rate_f (phase 11's sequence laid out as the published run qu_tr_1_b,
         depth rendered from the published depth camera, so it serves on the host path)
         and Choi over n_corr_iterations: per row the printed scores, seconds, cycles and
         each kernel's launches per cycle, K1 and K2 (and K3 with depth, K5 but on
         RTB's articulated cycle) in every fused cycle;
     12x. card against CPU (compare_runs, as 11x): the fused replay of 12r and each
         study's first row (the RBOT studies over 2 bodies x a_regular and d_occlusion,
         5 frames), each fused cycle from the CPU's state, every kernel call of the card's
         run equal to its twin, scored and final poses and printed scores within 1e-4,
         partings as 11x's;
     12o. optimization_time --max-chain 20 --n-runs 50: its table (host time: the
         Optimizer's numpy Newton step).
     cv2 must not have been imported.
  13. the benchmark runner, python -m m3t_tpu_torch.bench (bench.py's counterpart), in
     its seven modes (region, --rgbd, --occlusion, --kinematic, --kinematic-rgbd, --ycb,
     --latency), on bench.py's own workloads (its kinematic structure, which never
     moves, and its random YCB texture terms included):
     13b. python -m m3t_tpu_torch.bench [--<mode>] --iters 10 --windows 2 as a
         subprocess per mode, one after the other: exit 0 and a last line with
         bench.py's keys and a finite value > 0, logged beside the card's name and power
         limit;
     13k. each mode's workload through bench.build_workload at B=512 (--latency at 1, 8
         and 64), every kernel launch counted from 0 over StartModality and 3 cycles and
         held per cycle against BENCH_LAUNCHES, every kernel call held against its
         plain twin (twin_checked); the largest translation error to the rendered pose
         (of the parent link, the only one rendered) is logged and not asserted.
  14. the fused cycles graphed (m3t_tpu_torch.graphs, the port's jax.jit: one CUDA graph
     per static key) against their eager twins (disable_graphs), on each bench mode's
     workload at B=512 (S=256: region, --rgbd, --ycb, --occlusion, --kinematic,
     --kinematic-rgbd), phase 8s's RGB-D scan step, the multi-camera cycles of phases 8c
     and 8k (B=512 x 2 cameras, S=256 x 2), --latency at B=1, 8 and 64 and phase 9l's
     serve graphs (region and RGB-D, one body; an eager and a graphed copy in lockstep):
     3 eager cycles (steps), then a graphed one from the state each eager one started
     from, the first capturing the graph, every graphed state equal to the eager one bit
     for bit; kernel launches per cycle of both forms and per replay as BENCH_LAUNCHES;
     graphs and segments per graph (1 in one process); each form's peak memory;
     14h. the host path of phases 10o and 10k, an eager copy (disable_graphs) and a
     graphed copy of each graph, 2 steps from equal states (detection, the starting
     step and a tracking step each, the graphed copy loaded with the eager copy's state
     before each step): every link pose, joint pose and histogram equal bit for bit,
     no kernel launched; the graphs captured;
     14d. two gloo processes on the one card form a (1, 2) mesh (the dry run's problem,
     rigid_call and kinematic_call of m3t_tpu_torch.parallel.dryrun): on each rank 3
     eager multi-camera cycles (rigid and articulated) and a graphed one from each eager
     one's start, every graphed state equal to the eager one bit for bit, one segment
     more than the cycle's Newton steps (the camera all_reduce runs between each two
     captured segments) and the eager launches per replay.
Every phase runs the fused cycles graphed, the form a user gets, but where it records
kernel calls to hold them against their twins (phase 2's recorded calls, 7, 8s and
8c's twin checks, 8x, 9x, 11x, 12r, 12g and 12p's twin checks, 12x, 13k:
recorded_launches) or counts aten operations (phases 4-6k's depth-frame reads): a
graph's replay calls no wrapper and dispatches no operation, so those cycles run
eagerly (disable_graphs).  12r also
replays its recording graphed, held by its launches.  Every path of phases 3-10 starts
with clear_graphs, so that its peak memory holds its own graphs only.
The last two lines are the phases' JSON and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import io
import json
import multiprocessing
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

# newton_step against its twin: every pose entry (the matmul's order parts a few ulps).
NEWTON_STEP_ATOL = 1e-6
WIDTH, HEIGHT, N_LINES, N_POINTS, N_BODIES = 640, 512, 200, 200, 512
DEPTH_SCALE = 0.001
PATH_CYCLES = 17  # phases 3-6k, 8c and 8k: cycles after StartModality
CUBE_HALF, CUBE_POSITION = 0.03, (-0.04, 0.0, 0.45)  # the occluder of phase 7, camera frame
PHASE7_ATOL = 1e-4  # card against CPU, every state field


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def texture_matches(rng, n_bodies: int, pose0, intr_t, k: int = 128, radius: float = 0.06):
    """bench.py --ycb's (B, 128) texture terms (bench.py:216-226), made checkable: points
    of the sphere's camera-facing half (body frame), matched at their projections at
    pose0 plus 1 px of noise, about 30 % invalid.  Numpy (center_f_body, image_uv,
    valid)."""
    d = rng.normal(size=(n_bodies, k, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[..., 2] = -np.abs(d[..., 2])
    points = (radius * d).astype(np.float32)
    cam = points @ pose0[:3, :3].T + pose0[:3, 3]
    uv = np.stack([cam[..., 0] * intr_t.fu / cam[..., 2] + intr_t.ppu,
                   cam[..., 1] * intr_t.fv / cam[..., 2] + intr_t.ppv], -1)
    uv += rng.normal(size=uv.shape)
    return points, uv.astype(np.float32), rng.random((n_bodies, k)) > 0.3


BENCH_MODELS = {"region": ("bench_model", "bench_sphere_region_model.npz"),
                "depth": ("bench_depth_model", "bench_sphere_depth_model.npz")}


def bench_model(kind: str, path: str):
    """bench.py's region or depth model of the sphere (bench.py:124-127, 205-206: radius
    0.06 m, n_subdiv 2, n_divides 2 (162 views), 200 points, image_size 800) through its
    cache file at path, generated there when the file is absent."""
    from m3t_tpu_torch.depth_model import DepthModel
    from m3t_tpu_torch.region_model import RegionModel
    from m3t_tpu_torch.utils import procedural

    body = procedural.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    cls = RegionModel if kind == "region" else DepthModel
    model = cls(BENCH_MODELS[kind][0], body, path, n_divides=2, n_points=N_POINTS,
                image_size=800)
    if not model.SetUp():
        raise AssertionError(f"{BENCH_MODELS[kind][0]} failed to set up")
    return model


def generate_bench_model(kind: str, path: str) -> float:
    """Phase 0m in a worker process: bench_model(kind, path) with no cache file present;
    returns the seconds it took."""
    Path(path).unlink(missing_ok=True)
    begin = time.perf_counter()
    bench_model(kind, path)
    return time.perf_counter() - begin


def generate_models():
    """Phase 0m: bench.py's region and depth models, generated by the port on this
    machine's CPU with no cache file present, one worker process each, both started
    together, each asserted equal to the committed npz in m3t_tpu_torch/data, every
    array and the checksum.  Returns the two set-up models (read back from the generated
    files) and the seconds each generation took in its process."""
    from m3t_tpu_torch import pipeline

    data = Path(pipeline.__file__).parent / "data"
    out_dir = Path(pipeline.__file__).parent / "_build" / "generated"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {kind: str(out_dir / file) for kind, (_, file) in BENCH_MODELS.items()}
    with concurrent.futures.ProcessPoolExecutor(
            len(paths), mp_context=multiprocessing.get_context("spawn")) as pool:
        took = dict(zip(paths, pool.map(generate_bench_model, paths, paths.values())))
    models, seconds = [], {}
    for kind, (name, file) in BENCH_MODELS.items():
        seconds[name] = took[kind]
        with np.load(paths[kind]) as got, np.load(data / file) as want:
            if sorted(got.files) != sorted(want.files):
                raise AssertionError(f"{file}: arrays {got.files} against {want.files}")
            differ = [k for k in want.files
                      if got[k].dtype != want[k].dtype or not np.array_equal(got[k], want[k])]
        if differ:
            raise AssertionError(f"generated {file} differs from the committed one in "
                                 f"{differ}")
        model = bench_model(kind, paths[kind])
        log(f"phase 0m: {name} generated in {seconds[name]:.1f} s, "
            f"{model.orientations.shape[0]} views, equal to the committed {file}")
        models.append(model)
    return models, seconds


def flagship_inputs(device, n_bodies: int, models=None):
    """bench.py's flagship frames, models, configs and jittered initial poses.  models:
    set-up (RegionModel, DepthModel) of the bench sphere, stacked with from_models;
    without them, the committed npz."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.common import Intrinsics
    from m3t_tpu_torch.ops import occlusion
    from m3t_tpu_torch.ops.depth_fn import DepthConfig
    from m3t_tpu_torch.ops.region_fn import RegionConfig
    from m3t_tpu_torch.utils import procedural

    pcfg = pipeline.PipelineConfig(
        cfg=RegionConfig(n_lines_max=N_LINES), scales=(6, 4, 2, 1),
        standard_deviations=(15.0, 5.0, 3.5, 1.5), n_corr_iterations=5,
        n_update_iterations=2)
    rgbd_pcfg = pcfg._replace(use_depth=True, depth_cfg=DepthConfig(n_points_max=N_POINTS))
    # evaluate_ycb_dataset.cpp:46-117 as bench.py --ycb sets it.
    ycb_pcfg = rgbd_pcfg._replace(
        scales=(7, 4, 2), standard_deviations=(25.0, 15.0, 10.0), n_corr_iterations=4,
        region_measure_occlusions=True, depth_measure_occlusions=True, use_texture=True)
    # bench.py --occlusion (bench.py:242-272): the tracked sphere is its own scene,
    # decimated to at most 256 triangles, culled, combined id 1 << 8 | 1.
    occ_pcfg = pcfg._replace(region_model_occlusions=True, region_checking=True,
                             focused_image_size=128)
    sphere = occlusion.SceneBody(*procedural.icosphere(2, 0.06), body_id=1, region_id=1)
    intr_t = Intrinsics(520.0, 520.0, WIDTH / 2 - 0.5, HEIGHT / 2 - 0.5, WIDTH, HEIGHT)
    intr = (intr_t.fu, intr_t.fv, intr_t.ppu, intr_t.ppv)
    rng = np.random.default_rng(0)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.6
    triangles = procedural.sphere_triangles(0.06, 2)
    frame = procedural.render_synthetic_color_frame(triangles, intr_t, pose0, noise_rng=rng)
    depth_frame = procedural.render_synthetic_depth_frame(triangles, intr_t, pose0,
                                                          DEPTH_SCALE)
    planar = np.ascontiguousarray(np.moveaxis(frame, -1, 0))
    poses = np.tile(pose0, (n_bodies, 1, 1))
    poses[:, 0, 3] += rng.uniform(-0.004, 0.004, n_bodies).astype(np.float32)
    poses[:, 1, 3] += rng.uniform(-0.004, 0.004, n_bodies).astype(np.float32)
    if models is None:
        data = Path(pipeline.__file__).parent / "data"
        model = pipeline.RegionModelArrays.from_npz(
            str(data / "bench_sphere_region_model.npz"), N_LINES, device=device)
        depth_model = pipeline.DepthModelArrays.from_npz(
            str(data / "bench_sphere_depth_model.npz"), N_POINTS, device=device)
    else:
        model = pipeline.RegionModelArrays.from_models(models[:1], N_LINES, device=device)
        depth_model = pipeline.DepthModelArrays.from_models(models[1:], N_POINTS,
                                                            device=device)
    return dict(kind=RIGID, pcfg=pcfg, rgbd_pcfg=rgbd_pcfg, ycb_pcfg=ycb_pcfg,
                occ_pcfg=occ_pcfg, intr=intr, intr_t=intr_t, pose0=pose0, poses=poses,
                model=model,
                depth_model=depth_model, sphere=sphere,
                targets=np.broadcast_to(pose0[:3, 3], (n_bodies, 3)),
                texture=texture_matches(np.random.default_rng(7), n_bodies, pose0, intr_t),
                occ_scene=occlusion.build_scene_geometry([[sphere]], decimate_to=256,
                                                         device=device),
                images=torch.as_tensor(planar, device=device),
                depth_images=torch.as_tensor(depth_frame, device=device))


def occlusion_path(inp):
    """inp for phase 6: bench.py --occlusion's config and scene."""
    return dict(inp, pcfg=inp["occ_pcfg"], scene_geom=inp["occ_scene"])


def occluded(inp):
    """inp with a cube between the camera and the sphere's left side, in the colour
    frame (green, with noise), in the depth frame and in the scene (body 2, region 2),
    and every scene check on: pcfg with both region checks, rgbd_pcfg with all four."""
    from m3t_tpu_torch.ops import occlusion
    from m3t_tpu_torch.ops.raster import rasterize_np
    from m3t_tpu_torch.utils import procedural

    intr_t, pose0, device = inp["intr_t"], inp["pose0"], inp["images"].device
    cube_v, cube_t = procedural.cube(CUBE_HALF)
    cube_pose = np.eye(4, dtype=np.float32)
    cube_pose[:3, 3] = CUBE_POSITION
    sphere_cam = procedural.sphere_triangles(0.06, 2) @ pose0[:3, :3].T + pose0[:3, 3]
    tris = np.concatenate([sphere_cam, cube_v[cube_t] + cube_pose[:3, 3]])
    ids = np.repeat([1, 2], [len(sphere_cam), len(cube_t)])
    depth, id_img = rasterize_np(tris, ids, intr_t.fu, intr_t.fv, intr_t.ppu, intr_t.ppv,
                                 WIDTH, HEIGHT, cull_backfaces=True, use_native=False)
    cube_px = id_img == 2
    planar = inp["images"].cpu().numpy().copy()
    noise = np.random.default_rng(1).integers(-8, 9, size=(3, int(cube_px.sum())))
    planar[:, cube_px] = np.clip(np.array([60, 170, 60])[:, None] + noise, 0, 255)
    depth_u16 = np.round(np.where(np.isfinite(depth), depth, 2.0) / DEPTH_SCALE)
    cube = occlusion.SceneBody(cube_v, cube_t, body_id=2, region_id=2)
    scene_flags = dict(region_model_occlusions=True, region_checking=True)
    return dict(inp, pcfg=inp["pcfg"]._replace(**scene_flags),
                rgbd_pcfg=inp["rgbd_pcfg"]._replace(depth_model_occlusions=True,
                                                    depth_silhouette_check=True,
                                                    **scene_flags),
                images=torch.as_tensor(planar, device=device),
                depth_images=torch.as_tensor(depth_u16.astype(np.uint16), device=device),
                scene_geom=occlusion.build_scene_geometry([[inp["sphere"], cube]],
                                                          device=device),
                occluder_poses=torch.as_tensor(cube_pose[None, None], device=device))


def structure_frames(intr_t, link_poses, seeds=(8, 10)):
    """Colour (H, W, 3) uint8 and depth (H, W) uint16 frames of the bench structure's two
    links (spheres) at link_poses (2, 4, 4) in the camera's frame, the parent shaded red,
    the child green, with the noise of np.random.default_rng(seed) for each colour."""
    from m3t_tpu_torch.ops.raster import rasterize_np
    from m3t_tpu_torch.utils import procedural

    sphere = procedural.sphere_triangles(0.06, 2)
    parent, child = (sphere @ p[:3, :3].T + p[:3, 3] for p in link_poses)
    both = np.concatenate([parent, child])
    eye = np.eye(4, dtype=np.float32)
    # The child in green (the links do not overlap in the image): in the parent's colour
    # it would sit in the background side of the parent's lines 9 px away, and the
    # reverse, which biases both links by a few mm.
    frame = procedural.render_synthetic_color_frame(both, intr_t, eye,
                                                    noise_rng=np.random.default_rng(seeds[0]))
    green = procedural.render_synthetic_color_frame(
        child, intr_t, eye, fg_color=(60, 170, 60), noise_rng=np.random.default_rng(seeds[1]))
    _, ids = rasterize_np(child, np.ones(len(child)), intr_t.fu, intr_t.fv, intr_t.ppu,
                          intr_t.ppv, intr_t.width, intr_t.height, cull_backfaces=True,
                          use_native=False)
    frame[ids == 1] = green[ids == 1]
    return frame, procedural.render_synthetic_depth_frame(both, intr_t, eye, DEPTH_SCALE)


def kinematic(inp):
    """inp for the articulated paths (bench.py --kinematic and --kinematic-rgbd, see
    phase 6k): configs with link-on-link scenes, the committed bench structure with its
    child free in all six directions, colour and depth frames with both links at the
    structure's initial poses, the per-link scenes of one structure, and the jittered
    initial joint poses of N_BODIES // 2 structures."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import kinematics, occlusion

    intr_t, device = inp["intr_t"], inp["images"].device
    with np.load(Path(pipeline.__file__).parent / "data" / "bench_kinematic_model.npz") as f:
        arrays = {k: f[k] for k in f.files}
    arrays["free"] = np.ones_like(arrays["free"])
    jp0 = arrays.pop("joint2parent")
    link_poses = kinematics.forward_kinematics(
        kinematics.KinematicModel.from_numpy(arrays, device="cpu"),
        torch.as_tensor(jp0))[0].numpy()
    frame, depth_frame = structure_frames(intr_t, link_poses)
    jitter = np.random.default_rng(9).uniform(-0.004, 0.004, (N_BODIES // 2, 2))
    joint2parent = np.tile(jp0, (N_BODIES // 2, 1, 1, 1))
    joint2parent[:, 0, :2, 3] += jitter.astype(np.float32)
    flags = dict(region_model_occlusions=True, region_checking=True, focused_image_size=128)
    return dict(inp, kind=ARTICULATED, pcfg=inp["pcfg"]._replace(**flags),
                rgbd_pcfg=inp["rgbd_pcfg"]._replace(**flags), kin_arrays=arrays,
                joint2parent=joint2parent, link_poses=link_poses,
                images=torch.as_tensor(np.ascontiguousarray(np.moveaxis(frame, -1, 0)),
                                       device=device),
                depth_images=torch.as_tensor(depth_frame, device=device),
                kin_scene=occlusion.build_kinematic_scene_geometry(
                    [[inp["sphere"], inp["sphere"]]], decimate_to=128, device=device))


def broadcast(record, n: int, device):
    """A record of one body's tensors (a model or a scene) on device, expanded to n."""
    return type(record)(*(a.to(device) for a in record)).expand(n)


def frames_of(frame, n: int, device):
    """One frame on device, expanded (a view) to n."""
    frame = frame.to(device)
    return frame.expand((n,) + frame.shape)


def rigid_batch(inp, n_bodies: int, device):
    """The models, frames and scene of one body broadcast (as views) to n_bodies, on
    device, with the first n_bodies initial poses, targets and texture terms."""
    from m3t_tpu_torch.ops.texture_fn import TexturePoints

    scene = {}
    if "scene_geom" in inp:
        scene["scene_geom"] = broadcast(inp["scene_geom"], n_bodies, device)
    if "occluder_poses" in inp:
        poses = inp["occluder_poses"].to(device)
        scene["occluder_poses"] = poses.expand((n_bodies,) + poses.shape[1:])
    return dict(model=broadcast(inp["model"], n_bodies, device),
                depth_model=broadcast(inp["depth_model"], n_bodies, device),
                images=frames_of(inp["images"], n_bodies, device),
                depth_images=frames_of(inp["depth_images"], n_bodies, device), scene=scene,
                poses=torch.as_tensor(inp["poses"][:n_bodies], device=device),
                targets=inp["targets"][:n_bodies],
                texture_points=TexturePoints(*(torch.as_tensor(a[:n_bodies], device=device)
                                               for a in inp["texture"])))


def articulated_batch(inp, n_bodies: int, device):
    """n_bodies // 2 two-link structures on device: the link models broadcast to
    n_bodies, a frame and a per-link scene per structure, the kinematic model, the
    first initial joint poses and the link targets (link-major)."""
    from m3t_tpu_torch.ops import kinematics

    n = n_bodies // 2
    scene = type(inp["kin_scene"])(*(
        a.to(device).repeat((n,) + (1,) * (a.dim() - 1)) for a in inp["kin_scene"]))
    return dict(model=broadcast(inp["model"], n_bodies, device),
                depth_model=broadcast(inp["depth_model"], n_bodies, device),
                images=frames_of(inp["images"], n, device),
                depth_images=frames_of(inp["depth_images"], n, device),
                scene=dict(scene_geom=scene),
                kin=kinematics.KinematicModel.from_numpy(inp["kin_arrays"], device).expand(n),
                joint2parent=torch.as_tensor(inp["joint2parent"][:n], device=device),
                targets=np.tile(inp["link_poses"][:, :3, 3], (n, 1)))


def rigid_start(inp, bt):
    from m3t_tpu_torch import pipeline

    return pipeline.initialize_histograms(inp["pcfg"], inp["intr"], bt["images"],
                                          bt["model"], bt["poses"])


def articulated_start(inp, bt):
    from m3t_tpu_torch import pipeline

    return pipeline.initialize_kinematic_histograms(
        inp["pcfg"], inp["intr"], bt["images"], bt["model"], bt["kin"], bt["joint2parent"])


def articulated_body_poses(bt, state):
    from m3t_tpu_torch import pipeline

    return pipeline.kinematic_body_poses(bt["kin"], state).reshape(-1, 4, 4)


class PathKind(NamedTuple):
    """What differs between the rigid and the articulated paths: how inputs become a
    batch (batch(inp, n_bodies, device)), the path's StartModality (start(inp, bt)) and
    the (B, 4, 4) body poses of a state (body_poses(bt, state))."""

    batch: Callable
    start: Callable
    body_poses: Callable


RIGID = PathKind(rigid_batch, rigid_start, lambda bt, state: state.body2camera_pose)
ARTICULATED = PathKind(articulated_batch, articulated_start, articulated_body_poses)


def region_cycle(inp, bt, state):
    from m3t_tpu_torch import pipeline

    return pipeline.tracking_cycle(inp["pcfg"], inp["intr"], bt["images"], bt["model"],
                                   state, **bt["scene"])


def rgbd_cycle(pcfg_key):
    def cycle(inp, bt, state):
        from m3t_tpu_torch import pipeline

        return pipeline.tracking_cycle_rgbd(
            inp[pcfg_key], inp["intr"], inp["intr"], DEPTH_SCALE, bt["images"],
            bt["depth_images"], bt["model"], bt["depth_model"], state,
            texture_points=bt["texture_points"], **bt["scene"])
    return cycle


def kinematic_cycle(pcfg_key):
    def cycle(inp, bt, state):
        from m3t_tpu_torch import pipeline

        pcfg = inp[pcfg_key]
        depth = {}
        if pcfg.use_depth:
            depth = dict(depth_intr=inp["intr"], depth_scale=DEPTH_SCALE,
                         depth_images=bt["depth_images"], depth_model=bt["depth_model"])
        return pipeline.tracking_cycle_kinematic(pcfg, inp["intr"], bt["images"],
                                                 bt["model"], bt["kin"], state,
                                                 **bt["scene"], **depth)
    return cycle


def launch_counters():
    """Each kernel wrapper by name: the function that ops/_cuda.py declares, which counts
    its launches."""
    from m3t_tpu_torch import pipeline  # noqa: F401  (imports every kernel's module)
    from m3t_tpu_torch.ops import _cuda

    return {fn.__name__: fn for fn in _cuda.wrappers()}


def kernel_modules():
    """Each kernel wrapper's name and the module that holds it and its ``_plain`` twin."""
    return {name: sys.modules[fn.__module__] for name, fn in launch_counters().items()}


@contextlib.contextmanager
def recorded_launches():
    """Every kernel wrapper call made inside the block, in order, as (name, args, kwargs,
    result) (the callers look the wrappers up in their module at each call).  The fused
    cycles run eagerly inside the block (disable_graphs): a graph's replay calls no
    wrapper, so only an eager cycle's kernel calls can be recorded."""
    from m3t_tpu_torch import graphs

    modules, kernels = kernel_modules(), launch_counters()
    calls = []

    def recorder(name):
        def record(*args, **kwargs):
            out = kernels[name](*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return record

    records = {name: recorder(name) for name in modules}
    for name, module in modules.items():
        setattr(module, name, records[name])
    try:
        with graphs.disable_graphs():
            yield calls
    finally:
        for name, module in modules.items():
            setattr(module, name, kernels[name])


def twin_mismatches(calls) -> list:
    """The names of the recorded kernel calls whose result is not its plain twin's on the
    same inputs, compared as phase 2 compares them (query_eval's inverse depths bit for
    bit, newton_step's poses within NEWTON_STEP_ATOL)."""
    modules, bad = kernel_modules(), []
    for name, args, kwargs, got in calls:
        twin = getattr(modules[name], f"{name}_plain")
        want = twin(*args, **kwargs)
        if name == "query_eval":
            same = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                    and torch.equal(got[1], want[1]))
        elif name == "newton_step":
            same = torch.allclose(got, want, rtol=0.0, atol=NEWTON_STEP_ATOL,
                                  equal_nan=True)
        elif name == "scene_coeffs":
            same = all(torch.equal(x, y) for x, y in zip(got, want))
        else:
            same = torch.equal(got, want)
        if not same:
            bad.append(name)
    return bad


def adversarial_queries(n_scenes: int, device):
    """query_eval inputs built to catch a wrong cull: ((coeffs, tri_valid, sil_id, u, v),
    bbox), the same scene n_scenes times.  Triangles (pixel-space vertices, so the edge
    planes are exact): t0 a triangle at inverse depth 0.5 (id 11); t1 far from every
    query (12), so it is culled between t0 and t2; t2 and t3 copies of t0 (13, 14): ties
    on chain 0 and across the chains, which t0 must win; t4 a nearer triangle (inverse
    depth 1, id 15) whose left edge is the column u = 40 on which a half-warp of queries
    sits, the edge of that half-warp's box; t5 an invalid row of NaN coefficients (16);
    t6 a valid row of NaN coefficients (17); t7 a triangle one float step right of u =
    48, just outside the box of the queries at u <= 48 (18).  Queries: a 16 x 16 grid of
    integer pixels, the column u = 40 and the column u = 48, NaN, -1e9 and +inf pixels,
    as float32."""
    from m3t_tpu_torch.ops import raster

    after_48 = float(np.nextafter(np.float32(48.0), np.float32(100.0)))
    tris = np.array([
        [[8, 8], [8, 40], [40, 8]],                      # t0, z = 2
        [[200, 200], [230, 200], [200, 230]],            # t1, z = 1
        [[8, 8], [8, 40], [40, 8]],                      # t2, z = 2
        [[8, 8], [8, 40], [40, 8]],                      # t3, z = 2
        [[40, 0], [40, 60], [70, 0]],                    # t4, z = 1
        [[0, 0], [0, 1], [1, 0]],                        # t5 (invalid, NaN)
        [[0, 0], [0, 1], [1, 0]],                        # t6 (NaN)
        [[after_48, 0], [after_48, 60], [80, 0]],        # t7, z = 1
    ], np.float32)
    z = np.array([2, 1, 2, 2, 1, 1, 1, 1], np.float32)[:, None, None]
    verts = np.concatenate([tris * z, np.broadcast_to(z, tris.shape[:2] + (1,))], -1)
    soup = raster.triangle_coefficients(
        torch.as_tensor(verts[None], device=device),
        torch.arange(11, 19, dtype=torch.int32, device=device)[None], 1.0, 1.0, 0.0, 0.0)
    coeffs = soup.coeffs.clone()
    coeffs[0, 5:7] = float("nan")
    valid = torch.ones((1, 8), dtype=torch.bool, device=device)
    valid[0, 5] = False
    grid_v, grid_u = np.meshgrid(np.arange(16) * 3.0, np.arange(16) * 3.0, indexing="ij")
    column = np.arange(16, dtype=np.float64) * 4.0
    u = np.concatenate([grid_u.ravel(), np.full(16, 40.0), np.full(16, 48.0),
                        [np.nan] * 8 + [-1e9] * 4 + [np.inf] * 4])
    v = np.concatenate([grid_v.ravel(), column, column,
                        [5.0] * 8 + [-1e9, 5.0, -1e9, 5.0] + [5.0, np.inf, -np.inf, 5.0]])
    queries = [torch.as_tensor(x, dtype=torch.float32, device=device)[None].expand(
        n_scenes, -1).contiguous() for x in (u, v)]
    return ((coeffs.expand(n_scenes, -1, -1), valid.expand(n_scenes, -1),
             soup.ids.expand(n_scenes, -1), *queries),
            soup.bbox.expand(n_scenes, -1, -1))


def rolled_frames(frames):
    """(B, H, W) uint16: the first frame rolled by a different (rows, cols) offset for
    every body, materialised (B distinct frames)."""
    b, h, w = frames.shape
    rng = np.random.default_rng(6)
    dev = frames.device
    dy = torch.as_tensor(rng.integers(-40, 41, b), device=dev)
    dx = torch.as_tensor(rng.integers(-40, 41, b), device=dev)
    rows = (torch.arange(h, device=dev)[None, :] - dy[:, None]) % h
    cols = (torch.arange(w, device=dev)[None, :] - dx[:, None]) % w
    first = frames[0].view(torch.int16)
    return first[rows[:, :, None], cols[:, None, :]].view(torch.uint16)


def depth_frame_reads(inp, cycle, tensors) -> int:
    """How many aten operations of one cycle of the path read the depth frame: those
    that take a tensor on the frame's storage and return one that is not on it (a view
    of the frame reads nothing).  On the card only sample_windows reads the frame, so a
    crop of it in any shape, dtype or layout, or a copy of it, counts."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from m3t_tpu_torch import graphs

    bt, state = tensors
    frame = bt["depth_images"].untyped_storage().data_ptr()

    def on_frame(x):
        return isinstance(x, torch.Tensor) and x.untyped_storage().data_ptr() == frame

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (any(map(on_frame, tree_leaves((args, kwargs))))
                    and not all(map(on_frame, tree_leaves(out)))):
                self.n += 1
            return out

    # Eagerly: a graph's replay dispatches no aten operation.
    with graphs.disable_graphs(), Count() as count:
        cycle(inp, bt, state)
    torch.cuda.synchronize()
    return count.n


def robot_scenes(device, n_structures: int = 256, n_links: int = 7, seed: int = 6):
    """scene_coeffs arguments at the kinematic cell's shape: n_structures chains of
    n_links 320-face icospheres (r 3.5 cm, 7 cm apart, 0.75-0.9 m from a 1280x960
    camera at fu = fv = 1000, each link moved by up to 1 cm), one scene per link holding
    every link of its chain, focused on that link (200-pixel crops)."""
    from m3t_tpu_torch.ops import occlusion
    from m3t_tpu_torch.utils import procedural

    vertices, triangles = procedural.icosphere(2, 0.035)
    bodies = [occlusion.SceneBody(vertices, triangles, body_id=k + 1, region_id=k + 1)
              for k in range(n_links)]
    one = occlusion.build_kinematic_scene_geometry(
        [bodies], referenced=[[k] for k in range(n_links)], device=device)
    geom = type(one)(*(a.repeat((n_structures,) + (1,) * (a.dim() - 1)) for a in one))
    rng = np.random.default_rng(seed)
    links = np.tile(np.eye(4, dtype=np.float32), (n_structures, n_links, 1, 1))
    links[..., 0, 3] = 0.07 * (np.arange(n_links) - (n_links - 1) / 2)
    links[..., 2, 3] = rng.uniform(0.75, 0.9, (n_structures, 1))
    links[..., :3, 3] += rng.uniform(-0.01, 0.01, (n_structures, n_links, 3))
    poses = torch.as_tensor(np.repeat(links, n_links, axis=0), device=device)
    projection = occlusion._focused_projection(geom, poses, (1000.0, 1000.0, 640.0, 480.0),
                                               1280, 960, 200, 0.02, 10.0)[4]
    return (geom.triangles, geom.owner, geom.sil_id, geom.tri_valid, geom.cull, poses,
            *projection, 0.02)


def check_twin(name: str, case: str, *args, **kwargs) -> str:
    """One call of the kernel wrapper ``name`` on the card against its plain twin on the
    same inputs (twin_mismatches); returns the case's label."""
    kernel = launch_counters()[name]
    out = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    if twin_mismatches([(name, args, kwargs, out)]):
        raise AssertionError(f"{name} {case}: kernel != plain")
    return f"{name} {case}"


def check_kernels(inp, kin):
    """Phase 2: every kernel against its plain twin at the flagship shapes (kin: the
    articulated paths' inputs); returns the cases checked."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import depth_fast as df
    from m3t_tpu_torch.ops import raster
    from m3t_tpu_torch.ops import region_fast as rf

    dev = torch.device("cuda")
    pcfg, intr, cfg = inp["pcfg"], inp["intr"], inp["pcfg"].cfg
    bt = inp["kind"].batch(inp, N_BODIES, dev)
    model, images, poses = bt["model"], bt["images"], bt["poses"]
    state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
    bin_crop, cu, cv = pipeline._prepare_crops(pcfg, intr, images, poses)
    rtab = rf.ratio_table(state.histogram_f, state.histogram_b)
    points = pipeline._select_view_cl(model, poses)
    c = pcfg.crop_size
    b = N_BODIES

    cases = []
    # One region cycle runs scales 6, 4, 2, 1, 1 in ratio mode, then one bins-mode walk;
    # the YCB parameters add scale 7.
    configs = (pcfg, inp["rgbd_pcfg"], inp["ycb_pcfg"])
    for scale in sorted(set().union(*(p.scales for p in configs)), reverse=True):
        geo = rf.line_geometry(cfg, scale, points, N_LINES, poses, *intr, WIDTH, HEIGHT,
                               cu, cv, c, pcfg.lp)
        kp = rf.round_up(cfg.line_length_in_segments * scale, 8)
        cases.append(check_twin("sample_lines", f"ratio kp={kp} LP={pcfg.lp}", geo.params,
                                bin_crop, rtab, kp, "ratio"))
        if scale in (max(pcfg.scales), min(pcfg.scales)):
            cases.append(check_twin("sample_lines", f"bins kp={kp} LP={pcfg.lp}",
                                    geo.params, bin_crop, None, kp, "bins"))
    params, mask = rf.histogram_walk_geometry(cfg, points, N_LINES, poses, *intr, WIDTH,
                                              HEIGHT, cu, cv, c, 2 * pcfg.lp)
    kp2 = mask.shape[-1]
    cases.append(check_twin("sample_lines", f"bins kp={kp2} LP={2 * pcfg.lp}", params,
                            bin_crop, None, kp2, "bins"))

    bins = rf.sample_lines(params, bin_crop, None, kp2, "bins").transpose(1, 2)
    half = pcfg.lp
    n_total = cfg.n_histogram_bins ** 3
    for side, sl in (("fg", slice(None, half)), ("bg", slice(half, None))):
        k2_bins = bins[:, sl].reshape(b, -1)
        k2_mask = mask[:, sl].reshape(b, -1).contiguous()
        cases.append(check_twin("bin_counts",
                                f"{side} B={b} N={k2_bins.shape[1]} bins={n_total}",
                                k2_bins, k2_mask, n_total))

    # sample_windows on the RGB-D path's frames (one frame shared by the batch as an
    # expanded view, as the cycle receives it) and selected depth views.
    rgbd, ycb = inp["rgbd_pcfg"], inp["ycb_pcfg"]
    frames = bt["depth_images"]
    dcu, dcv = df.depth_corners(frames, poses, *intr, c)
    centers = pipeline._select_depth_view(bt["depth_model"], poses).center_f_body

    def k3_case(name, image, u_min, v_min, stride, corner_u, corner_v, k):
        return check_twin("sample_windows", f"{name} K={k} P={u_min.shape[1]}", image,
                          u_min, v_min, stride, corner_u, corner_v, c, k)

    for cd in sorted(set(rgbd.considered_distances) | set(ycb.considered_distances),
                     reverse=True):
        u_min, v_min, stride, k = df.correspondence_windows(rgbd.depth_cfg, cd, centers,
                                                           poses, *intr)
        cases.append(k3_case(f"correspondence cd={cd}", frames, u_min, v_min, stride, dcu,
                             dcv, k))
        if k == 11:
            widest = (u_min, v_min, stride)
    u_min, v_min, _, _, stride = df.occlusion_windows(
        rgbd.depth_cfg.measured_occlusion_radius, False, centers, poses, *intr, WIDTH,
        HEIGHT)
    cases.append(k3_case("measured occlusion", frames, u_min, v_min, stride, dcu, dcv,
                         df.KMAX_N_OCCLUSION_STRIDES + 1))
    # A K that no template instantiation takes.
    u_min, v_min, stride, k = df.correspondence_windows(rgbd.depth_cfg, 0.03, centers,
                                                       poses, *intr)
    if k in (3, 5, 6, 11):
        raise AssertionError(f"sample_windows runtime-K case has a template K ({k})")
    cases.append(k3_case("runtime K, correspondence cd=0.03", frames, u_min, v_min,
                         stride, dcu, dcv, k))
    # A batch of sequences rather than many objects in one camera: a frame per body.
    cases.append(k3_case("distinct frames", rolled_frames(frames), *widest, dcu, dcv, 11))
    # A 200x160 camera (the frame's centre) under the 256-pixel crop.
    small = frames[0, 176:336, 220:420].contiguous().expand(b, -1, -1)
    fu, fv, ppu, ppv = intr
    u_min, v_min, stride, k = df.correspondence_windows(
        rgbd.depth_cfg, 0.05, centers, poses, fu, fv, ppu - 220, ppv - 176)
    corners = df.depth_corners(small, poses, fu, fv, ppu - 220, ppv - 176, c)
    rows, cols = df.window_positions(u_min, v_min, stride, *corners, c, k)
    if not ((rows >= small.shape[1]).any() or (cols >= small.shape[2]).any()):
        raise AssertionError("sample_windows small frame: no sample beyond the frame")
    cases.append(k3_case("small frame 200x160", small, u_min, v_min, stride, *corners, k))

    def k4_case(name, args):
        coeffs, _, _, u, _ = args
        return check_twin("query_eval",
                          f"{name} B={u.shape[0]} Q={u[0].numel()} T={coeffs.shape[1]}",
                          *args)

    def recorded(kernel, path_inp, cycle, path_state=None):
        """The arguments of every call of kernel in one cycle of the path at B=512."""
        path_bt = path_inp["kind"].batch(path_inp, b, dev)
        if path_state is None:
            path_state = path_inp["kind"].start(path_inp, path_bt)
        with recorded_launches() as calls:
            cycle(path_inp, path_bt, path_state)
        return [args for name, args, _, _ in calls if name == kernel]

    # query_eval on the calls of one flagship occlusion-path cycle (the first of its five
    # correspondence iterations) and of one RGB-D cycle with the cube and all four scene
    # checks (its first iteration's silhouette and depth modeled-occlusion calls).
    occ = occlusion_path(inp)
    cases.append(k4_case("occlusion path", recorded("query_eval", occ, region_cycle,
                                                    state)[0]))
    scene = occluded(inp)
    bt_scene = scene["kind"].batch(scene, b, dev)
    scene_state = pipeline.initialize_histograms(scene["pcfg"], intr, bt_scene["images"],
                                                 bt_scene["model"], poses)
    calls = recorded("query_eval", scene, rgbd_cycle("rgbd_pcfg"), scene_state)
    cases.append(k4_case("rgbd silhouette", calls[1]))
    cases.append(k4_case("rgbd modeled occlusion", calls[2]))
    cases.append(k4_case("kinematic path", recorded("query_eval", kin,
                                                    kinematic_cycle("pcfg"))[0]))
    # Random triangles (about 20 % invalid, not compacted) in four shared-memory tiles.
    rng = np.random.default_rng(4)
    n_scenes, n_tri = 64, 1600
    tri = np.empty((n_scenes, n_tri, 3, 3), np.float32)
    tri[..., :2] = rng.uniform(-0.1, 0.1, (n_scenes, n_tri, 3, 2))
    tri[..., 2] = rng.uniform(0.4, 0.8, (n_scenes, n_tri, 3))
    soup = raster.triangle_coefficients(
        torch.as_tensor(tri, device=dev),
        torch.as_tensor(rng.integers(1, 1 << 16, (n_scenes, n_tri)), device=dev),
        300.0, 300.0, 63.5, 63.5)
    keep = torch.as_tensor(rng.random((n_scenes, n_tri)) > 0.2, device=dev)
    pixels = torch.as_tensor(rng.integers(-8, 136, (2, n_scenes, 4096)), dtype=torch.int32,
                             device=dev)
    cases.append(k4_case("random triangles", (soup.coeffs, soup.valid & keep, soup.ids,
                                              pixels[0], pixels[1])))
    cases.append(k4_case("adversarial", adversarial_queries(b, dev)[0]))
    # newton_step on the first of the Newton steps of one flagship region cycle, and on
    # its first body alone (the latency batch's shape).
    step = recorded("newton_step", inp, region_cycle, state)[0]
    cases.append(check_twin("newton_step", f"region path B={b}", *step))
    cases.append(check_twin("newton_step", "region path, body 0 B=1", *(
        a[:1].contiguous() if torch.is_tensor(a) else a for a in step)))
    # scene_coeffs on the first focused scenes of one occlusion-path cycle and of one
    # kinematic cycle, and at the kinematic cell's shape.
    for label, path_inp, cycle, path_state in (
            ("occlusion path", occ, region_cycle, state),
            ("kinematic path", kin, kinematic_cycle("pcfg"), None)):
        args = recorded("scene_coeffs", path_inp, cycle, path_state)[0]
        cases.append(check_twin("scene_coeffs",
                                f"{label} B={args[0].shape[0]} T={args[0].shape[1]}",
                                *args))
    args = robot_scenes(dev)
    cases.append(check_twin("scene_coeffs",
                            f"robot scenes B={args[0].shape[0]} T={args[0].shape[1]}",
                            *args))
    log(f"phase 2: {len(cases)} kernel calls equal to their twins: {json.dumps(cases)}")
    return cases


def run_path(label, inp, cycle, want_per_cycle, want_at_init):
    """Phases 3-6k, 8c and 8k: StartModality and PATH_CYCLES cycles of the path at
    B=512 (the first captures its graph), every kernel launch counted from 0, every body
    (link) within 5 mm of its rendered pose."""
    from m3t_tpu_torch import graphs

    graphs.clear_graphs()  # the path's peak memory holds its own graph only
    dev = torch.device("cuda")
    bt = inp["kind"].batch(inp, N_BODIES, dev)
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    state = inp["kind"].start(inp, bt)
    for _ in range(PATH_CYCLES):
        state = cycle(inp, bt, state)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    want = {name: want_at_init.get(name, 0) + want_per_cycle.get(name, 0) * PATH_CYCLES
            for name in counters}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {want}")

    pose = inp["kind"].body_poses(bt, state).cpu().numpy()
    if not np.all(np.isfinite(pose)) or not torch.isfinite(state.histogram_f).all():
        raise AssertionError(f"{label}: non-finite tracking state")
    err = np.linalg.norm(pose[:, :3, 3] - bt["targets"], axis=1)
    if not np.all(err < 0.005):
        raise AssertionError(f"{label}: translation error up to {err.max()} m (limit 5 mm)")
    result = dict(path=label, bodies=N_BODIES,
                  cameras=bt["cam2ref"].shape[0] if "cam2ref" in bt else 1,
                  cycles=PATH_CYCLES, max_translation_error_m=float(err.max()),
                  launches=launches, peak_memory_bytes=torch.cuda.max_memory_allocated())
    log(f"{label} cycle: {json.dumps(result)}")
    return result, (bt, state)


def check_masks_drop(label, inp, device="cuda", n_bodies: int = 8):
    """Phase 7: at the initial poses, the occlusion masks of inp's RGB-D config (measured
    occlusions from the depth frame, and the scene checks when inp has a scene) must drop
    some region lines and some depth points against the same correspondences without
    them."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import depth_fast as df
    from m3t_tpu_torch.ops import region_fast as rf

    pcfg, intr = inp["rgbd_pcfg"], inp["intr"]
    bt = inp["kind"].batch(inp, n_bodies, device)
    poses = bt["poses"]
    handle = torch.ones(n_bodies, dtype=torch.bool, device=device)
    dcu, dcv = df.depth_corners(bt["depth_images"], poses, *intr, pcfg.crop_size)
    depth = pipeline._DepthInputs(bt["depth_images"], intr, DEPTH_SCALE, bt["depth_model"],
                                  dcu, dcv)
    _, cu, cv = pipeline._prepare_crops(pcfg, intr, bt["images"], poses)
    points = pipeline._select_view_cl(bt["model"], poses)
    region = dict(measured_occlusion=pipeline._region_measured_occlusion(pcfg, depth, points,
                                                                         poses))
    depth_scene = {}
    if bt["scene"]:
        scene_geom = bt["scene"]["scene_geom"]
        scene_poses = torch.cat([poses[:, None], bt["scene"]["occluder_poses"]], dim=1)
        rend = pipeline._render_scene_for(pcfg, scene_geom, scene_poses, intr, WIDTH,
                                          HEIGHT)
        region["region_check"], region["modeled_occlusion"] = \
            pipeline._scene_region_inputs(pcfg, rend, scene_geom)
        depth_scene = dict(zip(("modeled_occlusion", "silhouette_check"),
                               pipeline._scene_depth_inputs(pcfg, rend, scene_geom)))

    def n_lines(**checks):
        return int(rf.line_geometry(
            pcfg.cfg, pcfg.scales[0], points, N_LINES, poses, *intr, WIDTH, HEIGHT, cu, cv,
            pcfg.crop_size, pcfg.lp, handle_occlusions=handle, **checks).valid.sum())

    def n_points(config, **checks):
        return int(pipeline._depth_terms(config, depth, 0, poses, handle,
                                         **checks).valid.sum())

    lines = (n_lines(), n_lines(**region))
    kept = (n_points(pcfg._replace(depth_measure_occlusions=False)),
            n_points(pcfg, **depth_scene))
    log(f"{label} at B={n_bodies}: valid region lines {lines[0]} -> {lines[1]}, "
        f"valid depth points {kept[0]} -> {kept[1]}")
    if not (lines[1] < lines[0] and kept[1] < kept[0]):
        raise AssertionError(f"{label} dropped no region line or no depth point")


def walled(inp):
    """inp with a wall 0.3 m from the camera over the left half of the depth frame: it
    hides half of the sphere, so measured occlusions drop lines and points."""
    depth = inp["depth_images"].clone()
    depth[:, :WIDTH // 2] = round(0.3 / DEPTH_SCALE)
    return dict(inp, depth_images=depth)


def check_card_against_cpu(label, inp, cycle, n_bodies: int = 8, n_cycles: int = 3,
                          parted_allowed: int = 0):
    """Phase 7: the same small batch on the card and on the CPU (plain twins).

    Each cycle starts both devices from the same state (the CPU's), so the check holds
    the card to what the CPU computes for that cycle, and every kernel call the card
    makes in it is held against the kernel's plain twin on the same inputs, exactly.
    The states are compared batch entry by batch entry (a body, or a structure on the
    articulated paths).  An entry parts from the CPU when a sample or a correspondence
    lies on a rounding boundary: the plain PyTorch arithmetic that feeds it rounds
    differently on the two devices, the sample goes one way on the card and the other on
    the CPU, and since a sphere's rotation is nearly unobservable (its rotation Hessian
    is little more than the Tikhonov term), the pose moves well beyond PHASE7_ATOL in
    that cycle.  Each parted entry is logged with its cycle and differences; the case
    fails if more than ``parted_allowed`` entries part, or if a kernel call differs from
    its twin.  Left to run freely, the two trajectories can part the same way: that gap
    is printed, not held.  Returns the largest difference of each state field, the
    parted entries and the kernel calls that differ from their twins.
    """
    setups = {dev: inp["kind"].batch(inp, n_bodies, dev) for dev in ("cuda", "cpu")}

    def entry_diffs(a, b):
        return {n: (x.cpu() - y.cpu()).abs().reshape(x.shape[0], -1).amax(1)
                for n, x, y in zip(a._fields, a, b)}

    def run(dev, state):
        return cycle(inp, setups[dev], type(state)(*(a.to(dev) for a in state)))

    def compare(step, card, cpu):
        diffs = entry_diffs(card, cpu)
        for entry in range(len(next(iter(diffs.values())))):
            event = {n: float(d[entry]) for n, d in diffs.items()}
            if any(d > PHASE7_ATOL for d in event.values()):
                parted.setdefault(entry, []).append(step)
                log(f"{label}: batch entry {entry} parted in {step}: max abs diff {event}")
        return {n: float(d.max()) for n, d in diffs.items()}

    parted, mismatches = {}, []
    with recorded_launches() as calls:
        card = inp["kind"].start(inp, setups["cuda"])
    mismatches += [f"start {name}" for name in twin_mismatches(calls)]
    cpu = inp["kind"].start(inp, setups["cpu"])
    per_step = {"start": compare("start", card, cpu)}
    free = {"cuda": cpu, "cpu": cpu}
    n_calls = len(calls)
    for i in range(n_cycles):
        with recorded_launches() as calls:
            card = run("cuda", cpu)
        mismatches += [f"cycle {i + 1} {name}" for name in twin_mismatches(calls)]
        n_calls += len(calls)
        cpu = run("cpu", cpu)
        per_step[f"cycle {i + 1}"] = compare(f"cycle {i + 1}", card, cpu)
        free = {dev: run(dev, st) for dev, st in free.items()}
    worst = {n: max(step[n] for step in per_step.values()) for n in cpu._fields}
    log(f"{label}: card vs CPU at B={n_bodies}, {n_cycles} cycles from equal states: "
        f"max abs diff {worst}; by step {per_step}; parted entries {sorted(parted)} "
        f"(allowed {parted_allowed}); {n_calls} kernel calls against their twins, "
        f"{len(mismatches)} differ")
    log(f"{label}: free-running {n_cycles} cycles: max abs diff "
        + json.dumps({n: float(d.max()) for n, d in entry_diffs(free["cuda"],
                                                                 free["cpu"]).items()})
        + "; translation error mm "
        + json.dumps({dev: [round(float(e) * 1e3, 3) for e in np.linalg.norm(
            inp["kind"].body_poses(setups[dev], st)[:, :3, 3].cpu().numpy()
            - setups[dev]["targets"], axis=1)] for dev, st in free.items()}))
    return dict(max_abs_diff=worst, parted={e: steps for e, steps in sorted(parted.items())},
                parted_allowed=parted_allowed, kernel_calls=n_calls,
                twin_mismatches=mismatches)


# ----------------------------------------------------------------------------------------
# Phase 8: the scale-out paths, with a frame per (body, camera) and per (sequence, step)
# ----------------------------------------------------------------------------------------

SIDE_CAMERA_DEG = (20.0, 5.0)  # camera 1: degrees to the side of the target, and off its axis
SCAN_FRAMES = 6                # phase 8s: frame 0 starts the histograms, 5 are tracked
SCAN_STEP_M = 0.001            # phase 8s: the sphere's motion along x per frame


def side_cameras(center):
    """(2, 4, 4) camera-to-reference poses: the reference camera, and a camera that sees
    ``center`` from SIDE_CAMERA_DEG[0] degrees to the side, SIDE_CAMERA_DEG[1] degrees off
    its optical axis."""
    from m3t_tpu_torch.utils import procedural

    return np.stack([np.eye(4, dtype=np.float32),
                     procedural.orbit_camera(center, *SIDE_CAMERA_DEG)])


def own_frames(colour, depth, n: int, device, seed: int, time_major: bool = False):
    """Frames with storage of their own for n batch entries, from frames rendered once
    per camera (or time step): colour (K, 3, H, W) uint8 -> (n, K, 3, H, W), each frame
    with its own noise of +-4 on top of the rendered noise, and depth (K, H, W) uint16 ->
    (n, K, H, W) copies; (K, n, ...) when time_major.  Made on the card from a seeded
    generator, then moved to device, so that the CPU's batch of phase 8x equals the
    card's."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.as_tensor(colour, device="cuda").to(torch.int16)
    k = base.shape[0]
    lead = (k, n) if time_major else (n, k)
    out = torch.empty(lead + base.shape[1:], dtype=torch.uint8, device="cuda")
    for i in range(0, n, 32):
        m = min(32, n - i)
        shape = ((k, m) if time_major else (m, k)) + base.shape[1:]
        noise = torch.randint(-4, 5, shape, generator=gen, device="cuda", dtype=torch.int16)
        block = (base[:, None] if time_major else base[None]) + noise
        if time_major:
            out[:, i:i + m] = block.clamp_(0, 255).to(torch.uint8)
        else:
            out[i:i + m] = block.clamp_(0, 255).to(torch.uint8)
    depth = torch.as_tensor(depth, device="cuda")
    depth = (depth[:, None] if time_major else depth[None]).expand(lead + depth.shape[1:])
    return out.to(device), depth.contiguous().to(device)


def sphere_cube_view(inp, ref2cam, seed: int):
    """Planar colour (3, H, W) uint8 and depth (H, W) uint16 of the flagship sphere at
    pose0 and phase 7's cube (green) in the camera whose reference-to-camera pose is
    ref2cam, with the noise of np.random.default_rng(seed)."""
    from m3t_tpu_torch.ops.raster import rasterize_np
    from m3t_tpu_torch.utils import procedural

    intr_t = inp["intr_t"]
    sphere_pose = ref2cam @ inp["pose0"]
    cube_pose = np.eye(4, dtype=np.float32)
    cube_pose[:3, 3] = CUBE_POSITION
    cube_pose = ref2cam @ cube_pose
    sphere = procedural.sphere_triangles(0.06, 2)
    cube_v, cube_t = procedural.cube(CUBE_HALF)
    frame = procedural.render_synthetic_color_frame(sphere, intr_t, sphere_pose)
    tris = np.concatenate([sphere @ sphere_pose[:3, :3].T + sphere_pose[:3, 3],
                           cube_v[cube_t] @ cube_pose[:3, :3].T + cube_pose[:3, 3]])
    ids = np.repeat([1, 2], [len(sphere), len(cube_t)])
    depth, id_img = rasterize_np(tris, ids, intr_t.fu, intr_t.fv, intr_t.ppu, intr_t.ppv,
                                 WIDTH, HEIGHT, cull_backfaces=True, use_native=False)
    frame[id_img == 2] = (60, 170, 60)
    noise = np.random.default_rng(seed).integers(-8, 9, frame.shape)
    frame = np.clip(frame.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    depth_u16 = np.round(np.where(np.isfinite(depth), depth, 2.0) / DEPTH_SCALE)
    return np.ascontiguousarray(np.moveaxis(frame, -1, 0)), depth_u16.astype(np.uint16)


def sequences(inp):
    """inp for phase 8s: SCAN_FRAMES frames of the flagship sphere moving SCAN_STEP_M
    along x per frame (colour (T, 3, H, W), depth (T, H, W)) and the sphere's position
    in each."""
    from m3t_tpu_torch.utils import procedural

    sphere = procedural.sphere_triangles(0.06, 2)
    colour, depth, targets = [], [], []
    for t in range(SCAN_FRAMES):
        pose = inp["pose0"].copy()
        pose[0, 3] += SCAN_STEP_M * t
        frame = procedural.render_synthetic_color_frame(sphere, inp["intr_t"], pose,
                                                        noise_rng=np.random.default_rng(30 + t))
        colour.append(np.moveaxis(frame, -1, 0))
        depth.append(procedural.render_synthetic_depth_frame(sphere, inp["intr_t"], pose,
                                                             DEPTH_SCALE))
        targets.append(pose[:3, 3])
    return dict(inp, kind=SEQUENCES, scan_colour=np.stack(colour), scan_depth=np.stack(depth),
                scan_targets=np.stack(targets))


def sequences_batch(inp, n_bodies: int, device):
    """n_bodies sequences: frames (T, B, 3, H, W) and depth frames (T, B, H, W) of their
    own, the flagship models and initial poses; targets: the position in frame 1."""
    bt = rigid_batch(inp, n_bodies, device)
    frames, depth = own_frames(inp["scan_colour"], inp["scan_depth"], n_bodies, device, 85,
                               time_major=True)
    return dict(bt, frames=frames, depth_frames=depth,
                targets=np.broadcast_to(inp["scan_targets"][1], (n_bodies, 3)))


def sequences_start(inp, bt):
    from m3t_tpu_torch import pipeline

    return pipeline.initialize_histograms(inp["pcfg"], inp["intr"], bt["frames"][0],
                                          bt["model"], bt["poses"])


def scan_step_cycle(inp, bt, state):
    """One step of the RGB-D sequence scan (frame 1)."""
    from m3t_tpu_torch import parallel

    return parallel.track_sequences_scan_rgbd(
        inp["rgbd_pcfg"], inp["intr"], inp["intr"], DEPTH_SCALE, bt["frames"][1:2],
        bt["depth_frames"][1:2], bt["model"], bt["depth_model"], state)[0]


def multicamera(inp):
    """inp for phase 8c: phase 7's scene (the sphere, the cube between it and the
    reference camera, all four scene checks) seen by two cameras, the second 20 degrees
    to the side of the sphere and off its axis; a colour and a depth frame per camera,
    texture matches per camera (camera_texture, (B, C, ...)) and texture_pcfg, the RGB-D
    config with texture terms."""
    scene = occluded(inp)
    cam2ref = side_cameras(inp["pose0"][:3, 3])
    views = [sphere_cube_view(inp, np.linalg.inv(c), 20 + i) for i, c in enumerate(cam2ref)]
    rng = np.random.default_rng(21)
    texture = [texture_matches(rng, N_BODIES, np.linalg.inv(c) @ inp["pose0"], inp["intr_t"])
               for c in cam2ref]
    return dict(scene, kind=MULTICAMERA, cam2ref=cam2ref,
                camera_colour=np.stack([v[0] for v in views]),
                camera_depth=np.stack([v[1] for v in views]),
                camera_texture=tuple(np.stack([t[i] for t in texture], 1) for i in range(3)),
                texture_pcfg=scene["rgbd_pcfg"]._replace(use_texture=True))


def multicamera_batch(inp, n_bodies: int, device):
    """phase 8c's batch: rigid_batch with a colour and a depth frame of their own per
    (body, camera), (B, C, 3, H, W) and (B, C, H, W), the cameras and the texture matches
    per (body, camera)."""
    from m3t_tpu_torch.ops.texture_fn import TexturePoints

    bt = rigid_batch(inp, n_bodies, device)
    images, depth = own_frames(inp["camera_colour"], inp["camera_depth"], n_bodies, device, 81)
    return dict(bt, images=images, depth_images=depth,
                cam2ref=torch.as_tensor(inp["cam2ref"], device=device),
                texture_points=TexturePoints(*(torch.as_tensor(a[:n_bodies], device=device)
                                               for a in inp["camera_texture"])))


def multicamera_start(inp, bt):
    from m3t_tpu_torch import pipeline

    return pipeline.initialize_multicamera_histograms(inp["pcfg"], inp["intr"], bt["images"],
                                                      bt["cam2ref"], bt["model"], bt["poses"])


def multicamera_cycle(inp, pcfg_key, with_texture: bool = False):
    """cycle(inp, bt, state) of phase 8c: inp's multi-camera rigid cycle, built once (so
    that a path times the replays of one graph, whatever its key)."""
    from m3t_tpu_torch import pipeline

    sharded = pipeline.make_sharded_cycle(inp[pcfg_key], None, inp["intr"], inp["intr"],
                                          with_depth=True, with_scene=True,
                                          with_texture=with_texture)

    def cycle(inp, bt, state):
        extra = [bt["depth_images"], DEPTH_SCALE, bt["depth_model"],
                 bt["scene"]["scene_geom"], bt["scene"]["occluder_poses"]]
        if with_texture:
            extra.append(bt["texture_points"])
        return sharded(bt["images"], bt["cam2ref"], bt["model"], state, *extra)
    return cycle


def kinematic_multicamera(kin):
    """inp for phase 8k: phase 6k's structures seen by two cameras, the second 20
    degrees to the side of the structure's centre and off its axis; a colour and a depth
    frame of both links per camera."""
    cam2ref = side_cameras(kin["link_poses"][:, :3, 3].mean(0))
    views = [structure_frames(kin["intr_t"], np.linalg.inv(c) @ kin["link_poses"],
                              seeds=(8 + 10 * i, 10 + 10 * i)) for i, c in enumerate(cam2ref)]
    return dict(kin, kind=MULTICAMERA_ARTICULATED, cam2ref=cam2ref,
                camera_colour=np.stack([np.moveaxis(v[0], -1, 0) for v in views]),
                camera_depth=np.stack([v[1] for v in views]))


def kinematic_multicamera_batch(inp, n_bodies: int, device):
    """phase 8k's batch: articulated_batch with a colour and a depth frame of their own
    per (structure, camera) and the cameras."""
    bt = articulated_batch(inp, n_bodies, device)
    images, depth = own_frames(inp["camera_colour"], inp["camera_depth"], n_bodies // 2,
                               device, 83)
    return dict(bt, images=images, depth_images=depth,
                cam2ref=torch.as_tensor(inp["cam2ref"], device=device))


def kinematic_multicamera_start(inp, bt):
    """Histograms per (structure, link, camera) at the initial joint poses: the links as
    the bodies of the rigid multi-camera StartModality."""
    from m3t_tpu_torch import pipeline

    joint2parent = bt["joint2parent"]
    s, nl = joint2parent.shape[:2]
    links = pipeline._kinematic_flat_poses(bt["kin"], joint2parent)[1]
    start = pipeline.initialize_multicamera_histograms(
        inp["pcfg"], inp["intr"], pipeline._repeat_each(bt["images"], nl), bt["cam2ref"],
        bt["model"], links)
    return pipeline.KinematicMultiCameraState(
        joint2parent, *(h.reshape((s, nl) + h.shape[1:]) for h in start[1:]))


def kinematic_multicamera_cycle(inp, pcfg_key):
    """cycle(inp, bt, state) of phase 8k: inp's multi-camera articulated cycle, built
    once."""
    from m3t_tpu_torch import pipeline

    pcfg = inp[pcfg_key]
    sharded = pipeline.make_sharded_kinematic_cycle(pcfg, None, inp["intr"], inp["intr"],
                                                    with_depth=pcfg.use_depth,
                                                    with_scene=True)

    def cycle(inp, bt, state):
        depth = ([bt["depth_images"], DEPTH_SCALE, bt["depth_model"]] if pcfg.use_depth
                 else [])
        return sharded(bt["images"], bt["cam2ref"], bt["model"], bt["kin"], state, *depth,
                       bt["scene"]["scene_geom"], None)
    return cycle


SEQUENCES = PathKind(sequences_batch, sequences_start,
                     lambda bt, state: state.body2camera_pose)
MULTICAMERA = PathKind(multicamera_batch, multicamera_start,
                       lambda bt, state: state.body2reference_pose)
MULTICAMERA_ARTICULATED = PathKind(kinematic_multicamera_batch, kinematic_multicamera_start,
                                   articulated_body_poses)


def run_scan(label, inp, rgbd: bool, want_per_step, want_at_init):
    """Phase 8s: StartModality on frame 0, then track_sequences_scan (or _rgbd) over
    the other frames of N_BODIES sequences, every kernel launch counted from 0; every
    pose of every step within 5 mm of the sphere in that frame."""
    from m3t_tpu_torch import graphs, parallel

    graphs.clear_graphs()
    bt = sequences_batch(inp, N_BODIES, torch.device("cuda"))
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    start = sequences_start(inp, bt)
    if rgbd:
        final, poses = parallel.track_sequences_scan_rgbd(
            inp["rgbd_pcfg"], inp["intr"], inp["intr"], DEPTH_SCALE, bt["frames"][1:],
            bt["depth_frames"][1:], bt["model"], bt["depth_model"], start)
    else:
        final, poses = parallel.track_sequences_scan(inp["pcfg"], inp["intr"],
                                                     bt["frames"][1:], bt["model"], start)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    n_steps = SCAN_FRAMES - 1
    want = {name: want_at_init.get(name, 0) + want_per_step.get(name, 0) * n_steps
            for name in counters}
    if launches != want:
        raise AssertionError(f"{label}: kernel launches {launches}, expected {want}")
    poses = poses.cpu().numpy()
    if not np.all(np.isfinite(poses)) or not torch.isfinite(final.histogram_f).all():
        raise AssertionError(f"{label}: non-finite tracking state")
    err = np.linalg.norm(poses[..., :3, 3] - inp["scan_targets"][1:, None], axis=-1)
    if not np.all(err < 0.005):
        raise AssertionError(f"{label}: translation error up to {err.max()} m (limit 5 mm) "
                             f"at steps {sorted(set(np.nonzero(err >= 0.005)[0] + 1))}")
    result = dict(path=label, sequences=N_BODIES, steps=n_steps,
                  max_translation_error_m=float(err.max()),
                  max_translation_error_m_by_step=[float(e) for e in err.max(1)],
                  launches=launches, frame_bytes=bt["frames"].numel()
                  + bt["depth_frames"].numel() * 2,
                  peak_memory_bytes=torch.cuda.max_memory_allocated())
    log(f"{label}: {json.dumps(result)}")
    return result, (bt, start)


def run_dryrun(timeout: float = 420.0) -> dict:
    """Phase 8d: the dry run over two processes on the card with gloo (two NCCL ranks
    cannot share one card); its exit code decides.  Every process it starts is in its
    own session, stopped with it on a timeout."""
    cmd = [sys.executable, "-m", "m3t_tpu_torch.parallel.dryrun", "--processes", "2",
           "--device", "cuda", "--backend", "gloo"]
    begin = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError(f"dry run: no end within {timeout} s: {out[-2000:]}")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    for line in out.splitlines():
        if line.startswith("[dryrun]") or line.startswith('{"dryrun"'):
            log(f"phase 8d: {line}")
    if proc.returncode != 0:
        raise AssertionError(f"dry run exited {proc.returncode}: {out[-3000:]}")
    result = json.loads(next(x for x in out.splitlines() if x.startswith('{"dryrun"')))
    return dict(result["dryrun"], seconds=time.perf_counter() - begin)


# ----------------------------------------------------------------------------------------
# Phase 9: the reference-shaped serve path (Tracker, modalities, links, optimizers and
# the fused serve backend)
# ----------------------------------------------------------------------------------------

SERVE_NOTICE = "fused cycle unavailable"


def pingpong(i: int, n: int) -> int:
    """Frame i of a replay that runs 0, 1, .., n-1, n-2, .., 1, 0, 1, ..: one step of
    the motion per frame, without end."""
    i %= 2 * (n - 1)
    return i if i < n else 2 * (n - 1) - i


def serve_graph(inp, seq, models, n_bodies: int, rgbd: bool, device):
    """The reference-shaped object graph of phase 9 on device: n_bodies Body objects of
    the bench sphere, each with its Link, RegionModality (bench.py's parameters), an
    optional DepthModality, its Optimizer and a StaticDetector at its jittered initial
    pose, all sharing phase 0m's models and one ImageColorCamera (and ImageDepthCamera)
    over phase 8s's frames replayed by pingpong; a Tracker with 5x2 iterations serving
    through the fused cycle."""
    from m3t_tpu_torch import (camera, depth_modality, detector, link, optimizer,
                               region_modality, tracker)
    from m3t_tpu_torch.utils import procedural

    n_frames = len(seq["scan_colour"])
    colour = [np.ascontiguousarray(np.moveaxis(f, 0, -1)) for f in seq["scan_colour"]]
    color_camera = camera.ImageColorCamera(
        "serve_color", inp["intr_t"], lambda i: colour[pingpong(i, n_frames)])
    depth_camera = camera.ImageDepthCamera(
        "serve_depth", inp["intr_t"], lambda i: seq["scan_depth"][pingpong(i, n_frames)],
        depth_scale=DEPTH_SCALE)
    region_model, depth_model = models
    srv = tracker.Tracker("serve", n_corr_iterations=5, n_update_iterations=2,
                          use_fused_cycle=True)
    for i in range(n_bodies):
        body = procedural.sphere_body(f"serve_body{i}", radius=0.06, n_subdiv=2)
        rm = region_modality.RegionModality(f"serve_region{i}", body, color_camera,
                                            region_model, device=device)
        rm.n_lines_max = N_LINES
        body_link = link.Link(f"serve_link{i}", body)
        body_link.AddModality(rm)
        if rgbd:
            dm = depth_modality.DepthModality(f"serve_depth{i}", body, depth_camera,
                                              depth_model, device=device)
            dm.n_points_max = N_POINTS
            body_link.AddModality(dm)
        body_optimizer = optimizer.Optimizer(f"serve_optimizer{i}", body_link)
        srv.AddOptimizer(body_optimizer)
        srv.AddDetector(detector.StaticDetector(f"serve_detector{i}", body_optimizer,
                                                link2world_pose=inp["poses"][i]))
    return srv


def serve_poses(srv) -> np.ndarray:
    return np.stack([o.root_link_ptr.link2world_pose for o in srv.optimizer_ptrs])


def serve_histograms(srv):
    rms = [o.root_link_ptr.modality_ptrs[0] for o in srv.optimizer_ptrs]
    return [torch.stack([getattr(m.color_histograms_ptr, f"histogram_{s}") for m in rms])
            for s in "fb"]


def serve_steps(srv, first: int, n: int) -> None:
    """n more iterations of RunTrackerProcess's loop for a tracker that tracks every body
    (cameras, consistent poses, the tracking step; no sleep)."""
    for i in range(first, first + n):
        if not (srv.UpdateCameras(i) and srv.CalculateConsistentPoses()
                and srv.ExecuteTrackingStep(i)):
            raise AssertionError(f"serve step {i} failed")


def run_serve(label, inp, seq, models, n_bodies: int, rgbd: bool, want_per_step: dict,
              device="cuda"):
    """Phase 9s, 9d and 9l: the serve graph driven through RunTrackerProcess over the 6
    frames of phase 8s (detection and the starting step at frame 0, a tracking step per
    frame), the fused backend asserted built and every kernel launch counted (none in
    the starting step), every body within 5 mm of the sphere in the last frame."""
    from m3t_tpu_torch import graphs

    graphs.clear_graphs()
    n_frames = len(seq["scan_colour"])
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = serve_graph(inp, seq, models, n_bodies, rgbd, device)
    if not srv.SetUp():
        raise AssertionError(f"{label}: Tracker.SetUp failed")
    for fn in counters.values():
        fn.launches = 0
    start_launches, printed = {}, io.StringIO()

    def launches():
        return {name: fn.launches for name, fn in counters.items()}

    starting = srv.ExecuteStartingStep

    def counted_start(iteration):
        before = launches()
        ok = starting(iteration)
        for name, n in launches().items():
            start_launches[name] = start_launches.get(name, 0) + n - before[name]
        return ok

    srv.ExecuteStartingStep = counted_start
    with contextlib.redirect_stdout(printed):
        ok = srv.RunTrackerProcess(execute_detection=True, start_tracking=True,
                                   max_iterations=n_frames)
        torch.cuda.synchronize()
    del srv.ExecuteStartingStep
    sys.stdout.write(printed.getvalue())
    if not ok:
        raise AssertionError(f"{label}: RunTrackerProcess failed")
    if srv._fused_backend is None or SERVE_NOTICE in printed.getvalue():
        raise AssertionError(f"{label}: the fused serve backend was not built: "
                             f"{printed.getvalue()!r}")
    got = launches()
    want = {name: want_per_step.get(name, 0) * n_frames for name in counters}
    if got != want or any(start_launches.values()):
        raise AssertionError(f"{label}: kernel launches {got} (starting step "
                             f"{start_launches}), expected {want} and none at the start")
    pose = serve_poses(srv)
    target = seq["scan_targets"][n_frames - 1]
    err = np.linalg.norm(pose[:, :3, 3] - target, axis=1)
    hist_f, _ = serve_histograms(srv)
    if not np.all(np.isfinite(pose)) or not torch.isfinite(hist_f).all():
        raise AssertionError(f"{label}: non-finite tracking state")
    if not np.all(err < 0.005):
        raise AssertionError(f"{label}: translation error up to {err.max()} m (limit 5 mm)")
    result = dict(path=label, bodies=n_bodies, frames=n_frames, launches=got,
                  starting_step_launches=start_launches,
                  max_translation_error_m=float(err.max()),
                  peak_memory_bytes=torch.cuda.max_memory_allocated())
    log(f"{label}: {json.dumps(result)}")
    return result


def check_serve_card_against_cpu(label, inp, seq, models, rgbd: bool, n_bodies: int = 8,
                                 n_steps: int = 3):
    """Phase 9x: the serve graph at B=n_bodies on the card and on the CPU, detection and
    the starting step at frame 0, then a tracking step per frame, each step started on
    both devices from the CPU's state (fused_serve.read_graph_state and
    load_graph_state); poses and histograms compared body by body after every step, and
    every kernel call of the card's steps held against its plain twin on the same
    inputs."""
    from m3t_tpu_torch import fused_serve

    trackers = {}
    for dev in ("cuda", "cpu"):
        trackers[dev] = serve_graph(inp, seq, models, n_bodies, rgbd, dev)
        if not trackers[dev].SetUp():
            raise AssertionError(f"{label}: Tracker.SetUp failed on {dev}")
        trackers[dev].ExecuteDetection(start_tracking=True)
    worst = {"pose": 0.0, "histogram_f": 0.0, "histogram_b": 0.0}
    parted, mismatches, n_calls = [], [], 0
    for i in range(n_steps):
        for dev, srv in trackers.items():
            with (recorded_launches() if dev == "cuda" else contextlib.nullcontext([])
                  ) as calls:
                ok = (srv.UpdateCameras(i) and srv.CalculateConsistentPoses()
                      and srv.ExecuteDetectingStep(i) and srv.ExecuteStartingStep(i)
                      and srv.ExecuteTrackingStep(i))
            if not ok or srv._fused_backend is None:
                raise AssertionError(f"{label}: serve step {i} failed on {dev}")
            n_calls += len(calls)
            mismatches += [f"step {i} {name}" for name in twin_mismatches(calls)]
        card, cpu = trackers["cuda"], trackers["cpu"]
        diffs = {"pose": np.abs(serve_poses(card) - serve_poses(cpu)).reshape(n_bodies, -1)
                 .max(1)}
        for name, c, h in zip(("histogram_f", "histogram_b"), serve_histograms(card),
                              serve_histograms(cpu)):
            diffs[name] = (c.cpu() - h).abs().amax(1).numpy()
        for body in range(n_bodies):
            event = {n: float(d[body]) for n, d in diffs.items()}
            if any(d > PHASE7_ATOL for d in event.values()):
                parted.append((body, i))
                log(f"{label}: body {body} parted at step {i}: max abs diff {event}")
        worst = {n: max(worst[n], float(d.max())) for n, d in diffs.items()}
        fused_serve.load_graph_state(card, fused_serve.read_graph_state(cpu))
    log(f"{label}: card vs CPU at B={n_bodies}, {n_steps} serve steps from equal states: "
        f"max abs diff {worst}; parted {parted}; {n_calls} kernel calls against their "
        f"twins, {len(mismatches)} differ")
    return dict(max_abs_diff=worst, parted=parted, parted_allowed=0, kernel_calls=n_calls,
                twin_mismatches=mismatches)


# ----------------------------------------------------------------------------------------
# Phase 10: the host path (renderers, the scene checks, constraints and the host KKT)
# through Tracker.RunTrackerProcess
# ----------------------------------------------------------------------------------------

HOST_FRAMES = 6
HOST_STEP_M = 0.001  # every body (structure) moves along x by this much per frame
# Phase 10o: five tracked spheres at frame 0 (camera frame, m) and their colours.  Bodies
# 3 and 4 overlap in the image (3 in front); phase 7's cube, untracked, hides the lower
# left of body 1.
HOST_BODIES = ((-0.20, -0.12, 0.50), (-0.02, -0.05, 0.55), (0.21, -0.10, 0.60),
               (-0.06, 0.13, 0.45), (0.04, 0.15, 0.52))
HOST_COLOURS = ((160, 60, 50), (200, 140, 40), (150, 50, 160), (220, 210, 70),
                (110, 40, 30))
HOST_CUBE_COLOUR = (60, 170, 60)
# Phase 10k: the roots of four copies of phase 6k's two-link structure (the child 0.13 m
# along the root's x).
STRUCTURE_ROOTS = ((-0.22, -0.12, 0.60), (0.05, -0.12, 0.60), (-0.22, 0.12, 0.62),
                   (0.05, 0.12, 0.58))
CHILD_ARM = 0.13
HOST_PARTED_BOUNDS = {"pose": 1e-2, "histogram_f": 1e-3, "histogram_b": 1e-3}
# Phase 10x's witness: the relative move of every link pose of the second CPU graph.
WITNESS_NUDGE = 1e-7
CV2_ONLY = ("TextureModality (ORB/BRISK/SIFT detection and matching), the loader cameras' "
            "frames other than PNG, and the viewers' display and saving")


def render_frame(intr_t, items, rng, noise: int = 8, gain: float = 1.0, depth_scale=None):
    """A colour (H, W, 3) uint8 frame, and with ``depth_scale`` a uint16 depth frame, of
    ``items`` (body-frame triangles (T, 3, 3), camera-frame pose, colour), rendered by the
    port's host rasterizer on the background of the flagship frames, times ``gain``,
    with uniform noise of +-``noise``; depth 2 m where no triangle lies."""
    from m3t_tpu_torch.ops.raster import rasterize_np

    tris = np.concatenate([t @ pose[:3, :3].T + pose[:3, 3] for t, pose, _ in items])
    ids = np.repeat(np.arange(1, len(items) + 1), [len(t) for t, _, _ in items])
    depth, id_img = rasterize_np(tris.astype(np.float32), ids, intr_t.fu, intr_t.fv,
                                 intr_t.ppu, intr_t.ppv, intr_t.width, intr_t.height,
                                 cull_backfaces=True)
    frame = np.empty((intr_t.height, intr_t.width, 3), np.float32)
    frame[:] = (40, 120, 190)
    for k, (_, _, colour) in enumerate(items):
        frame[id_img == k + 1] = colour
    frame = frame * gain + rng.integers(-noise, noise + 1, frame.shape)
    colour = np.clip(np.rint(frame), 0, 255).astype(np.uint8)
    if depth_scale is None:
        return colour, None
    return colour, np.round(np.where(np.isfinite(depth), depth, 2.0)
                            / depth_scale).astype(np.uint16)


def host_frames(intr_t, items, n_frames: int = HOST_FRAMES, seed: int = 20):
    """Colour (H, W, 3) uint8 and depth (H, W) uint16 frames of ``items`` (body-frame
    triangles, a function of the frame giving the camera-frame pose, colour)."""
    rng = np.random.default_rng(seed)
    frames = [render_frame(intr_t, [(t, pose(f), colour) for t, pose, colour in items], rng,
                           depth_scale=DEPTH_SCALE) for f in range(n_frames)]
    return [c for c, _ in frames], [d for _, d in frames]


def still(position):
    """The pose of a body that stays at ``position``, at any frame."""
    def pose(f):
        p = np.eye(4, dtype=np.float32)
        p[:3, 3] = position
        return p
    return pose


def moving(position):
    """The pose at frame f of a body starting at ``position``, moving HOST_STEP_M along
    x per frame."""
    def pose(f):
        p = np.eye(4, dtype=np.float32)
        p[:3, 3] = position
        p[0, 3] += HOST_STEP_M * f
        return p
    return pose


def host_cameras(intr_t, colours, depths, prefix: str):
    """An ImageColorCamera and an ImageDepthCamera over the frames, replayed back and
    forth (pingpong) beyond the last one."""
    from m3t_tpu_torch import camera

    n = len(colours)
    return (camera.ImageColorCamera(f"{prefix}_color", intr_t,
                                    lambda i: colours[pingpong(i, n)]),
            camera.ImageDepthCamera(f"{prefix}_depth", intr_t,
                                    lambda i: depths[pingpong(i, n)],
                                    depth_scale=DEPTH_SCALE))


def host_modalities(prefix, body, color_camera, depth_camera, models, rg, device,
                    region_checking: bool):
    """A body's RegionModality (bench.py's region parameters) and DepthModality (200
    points), wired as eval/ycb_evaluator.py wires a body: both measure occlusions on the
    depth camera and model them with a FocusedBasicDepthRenderer; with region_checking,
    the region modality checks regions and the depth modality silhouettes on a
    FocusedSilhouetteRenderer(id_type=REGION) (the body's region id is its body id).
    Both renderers reference the body and read ``rg``."""
    from m3t_tpu_torch import depth_modality, region_modality, renderer

    depth_renderer = renderer.FocusedBasicDepthRenderer(f"{prefix}_depth_renderer", rg,
                                                        color_camera, device=device)
    depth_renderer.AddReferencedBody(body)
    rm = region_modality.RegionModality(f"{prefix}_region", body, color_camera, models[0],
                                        device=device)
    rm.n_lines_max = N_LINES
    rm.MeasureOcclusions(depth_camera)
    rm.ModelOcclusions(depth_renderer)
    dm = depth_modality.DepthModality(f"{prefix}_depth", body, depth_camera, models[1],
                                      device=device)
    dm.n_points_max = N_POINTS
    dm.MeasureOcclusions()
    dm.ModelOcclusions(depth_renderer)
    if region_checking:
        silhouette_renderer = renderer.FocusedSilhouetteRenderer(
            f"{prefix}_silhouette_renderer", rg, color_camera,
            id_type=renderer.IDType.REGION, device=device)
        silhouette_renderer.AddReferencedBody(body)
        rm.UseRegionChecking(silhouette_renderer)
        dm.UseSilhouetteChecking(silhouette_renderer)
    return rm, dm


def occluded_scene_graph(inp, models, device):
    """Phase 10o's graph on device: five Body objects of the bench sphere (ids 1-5,
    set explicitly) at HOST_BODIES and phase 7's cube (id 6, untracked) in one
    RendererGeometry, each sphere with its Link, region and depth modalities (every
    scene check), Optimizer and a StaticDetector 2-3 mm off its frame-0 pose; a Tracker
    with 5x2 iterations asking for the fused cycle; the frames of the moving spheres and
    the still cube.  Returns (tracker, the frames' body poses (F, 5, 4, 4), the scene's
    pieces)."""
    from m3t_tpu_torch import detector, link, optimizer, renderer_geometry, tracker
    from m3t_tpu_torch.utils import procedural

    sphere = procedural.sphere_triangles(0.06, 2)
    cube_v, cube_t = procedural.cube(CUBE_HALF)
    items = [(sphere, moving(p), c) for p, c in zip(HOST_BODIES, HOST_COLOURS)]
    items.append((cube_v[cube_t], still(CUBE_POSITION), HOST_CUBE_COLOUR))
    colours, depths = host_frames(inp["intr_t"], items)
    color_camera, depth_camera = host_cameras(inp["intr_t"], colours, depths, "host")
    rg = renderer_geometry.RendererGeometry("host_geometry", device=device)
    bodies = [procedural.sphere_body(f"host_body{i}", radius=0.06, n_subdiv=2)
              for i in range(len(HOST_BODIES))]
    bodies.append(procedural.cube_body("host_cube", half=CUBE_HALF))
    for i, body in enumerate(bodies):
        body.body_id = body.region_id = i + 1
        rg.AddBody(body)
    bodies[-1].set_body2world_pose(still(CUBE_POSITION)(0))
    srv = tracker.Tracker("host", n_corr_iterations=5, n_update_iterations=2,
                          use_fused_cycle=True)
    rng = np.random.default_rng(21)
    for i, (body, position) in enumerate(zip(bodies, HOST_BODIES)):
        rm, dm = host_modalities(f"host{i}", body, color_camera, depth_camera, models, rg,
                                 device, region_checking=True)
        body_link = link.Link(f"host_link{i}", body)
        body_link.AddModality(rm)
        body_link.AddModality(dm)
        body_optimizer = optimizer.Optimizer(f"host_optimizer{i}", body_link)
        start = moving(position)(0)
        start[:2, 3] += rng.uniform(-0.003, 0.003, 2).astype(np.float32)
        srv.AddOptimizer(body_optimizer)
        srv.AddDetector(detector.StaticDetector(f"host_detector{i}", body_optimizer,
                                                link2world_pose=start))
    truth = np.stack([[moving(p)(f) for p in HOST_BODIES] for f in range(HOST_FRAMES)])
    return srv, truth, dict(rg=rg, bodies=bodies, color_camera=color_camera)


def structure_graph(inp, models, device):
    """Phase 10k's graph on device: four copies of phase 6k's structure (bench.py:285-306
    with the child free in all six directions and its own Body) at STRUCTURE_ROOTS, each
    a root and a child Link of the bench sphere with region and depth modalities that
    model link-on-link occlusions through FocusedBasicDepthRenderers over one
    RendererGeometry of all eight links, the hard Constraint of bench.py ([T,T,F,T,T,T]:
    a revolute joint about z) and a SoftConstraint that bounds the child's translation
    (tests/test_kinematics.py::test_soft_constraint_limits_deviation); an Optimizer and a
    StaticDetector 2-3 mm off per structure; a Tracker with 5x2 iterations asking for the
    fused cycle; the frames of the structures moving along x (parents red, children
    green).  Returns (tracker, the frames' link poses (F, 8, 4, 4), the scene's pieces)."""
    from m3t_tpu_torch import (constraint, detector, link, optimizer, renderer_geometry,
                               soft_constraint, tracker)
    from m3t_tpu_torch.utils import procedural

    sphere = procedural.sphere_triangles(0.06, 2)
    b2j = still((CHILD_ARM, 0.0, 0.0))(0)
    items = []
    for root in STRUCTURE_ROOTS:
        items.append((sphere, moving(root), (160, 60, 50)))
        items.append((sphere, moving(np.add(root, (CHILD_ARM, 0.0, 0.0))), (60, 170, 60)))
    colours, depths = host_frames(inp["intr_t"], items, seed=22)
    color_camera, depth_camera = host_cameras(inp["intr_t"], colours, depths, "structure")
    rg = renderer_geometry.RendererGeometry("structure_geometry", device=device)
    bodies = [procedural.sphere_body(f"structure_body{i}", radius=0.06, n_subdiv=2)
              for i in range(2 * len(STRUCTURE_ROOTS))]
    for i, body in enumerate(bodies):
        body.body_id = body.region_id = i + 1
        rg.AddBody(body)
    srv = tracker.Tracker("structures", n_corr_iterations=5, n_update_iterations=2,
                          use_fused_cycle=True)
    rng = np.random.default_rng(23)
    for s, root in enumerate(STRUCTURE_ROOTS):
        links = []
        for k, body in enumerate(bodies[2 * s:2 * s + 2]):
            rm, dm = host_modalities(f"structure{s}_{k}", body, color_camera, depth_camera,
                                     models, rg, device, region_checking=False)
            links.append(link.Link(f"structure{s}_link{k}", body,
                                   body2joint_pose=b2j if k else None))
            links[-1].AddModality(rm)
            links[-1].AddModality(dm)
        links[0].AddChildLink(links[1])
        hard = constraint.Constraint(f"structure{s}_constraint", links[0], links[1],
                                     body22joint2_pose=b2j,
                                     constraint_directions=[True, True, False, True, True,
                                                            True])
        soft = soft_constraint.SoftConstraint(
            f"structure{s}_soft_constraint", links[0], links[1], body22joint2_pose=b2j,
            constraint_directions=[False, False, False, True, True, True],
            max_distance_translation=0.002, standard_deviation_translation=0.01)
        structure_optimizer = optimizer.Optimizer(f"structure{s}_optimizer", links[0])
        structure_optimizer.AddConstraint(hard)
        structure_optimizer.AddSoftConstraint(soft)
        start = moving(root)(0)
        start[:2, 3] += rng.uniform(-0.003, 0.003, 2).astype(np.float32)
        srv.AddOptimizer(structure_optimizer)
        srv.AddDetector(detector.StaticDetector(f"structure{s}_detector",
                                                structure_optimizer, link2world_pose=start))
    truth = np.stack([[item[1](f) for item in items] for f in range(HOST_FRAMES)])
    return srv, truth, dict(rg=rg, bodies=bodies, color_camera=color_camera)


def graph_poses(srv) -> np.ndarray:
    """Every link's pose, optimizer by optimizer, root first: (N, 4, 4)."""
    return np.stack([link.link2world_pose for o in srv.optimizer_ptrs
                     for link in o.ReferencedLinks()])


def graph_histograms(srv):
    """Every region modality's histograms in graph_poses' order: (N, n_bins**3) each."""
    rms = [m for o in srv.optimizer_ptrs for link in o.ReferencedLinks()
           for m in link.modality_ptrs if hasattr(m, "use_region_checking")]
    return [torch.stack([getattr(m.color_histograms_ptr, f"histogram_{s}") for m in rms])
            for s in "fb"]


def graph_tensors(srv):
    """(owner, attribute, tensor) of every tensor held by the tracker's modalities,
    their histograms, renderers and renderer geometries (also inside named tuples)."""
    owners = []
    for o in srv.optimizer_ptrs:
        for link in o.ReferencedLinks():
            for m in link.modality_ptrs:
                owners += [m, m.color_histograms_ptr] if hasattr(m, "color_histograms_ptr") \
                    else [m]
    owners += srv.correspondence_renderer_ptrs + srv.results_renderer_ptrs
    owners += [data for rg in srv.renderer_geometry_ptrs
               for data in rg.render_data_bodies.values()]
    found = []
    for owner in owners:
        for key, value in vars(owner).items():
            values = value if isinstance(value, tuple) else (value,)
            found += [(getattr(owner, "name", type(owner).__name__), key, t)
                      for t in values if isinstance(t, torch.Tensor)]
    return found


def run_host_path(label, graph, inp, models, refusal: str):
    """Phases 10o and 10k: the graph on the card through RunTrackerProcess over the
    HOST_FRAMES frames (detection and the starting step at frame 0, a tracking step per
    frame), its six host-path functions graphed, with the kernel launch counts set to 0
    before it (the host path must launch none), the fused backend's refusal asserted,
    every tensor of the graph asserted on the card and every link within 5 mm of its
    rendered pose in the last frame; the graphs captured."""
    from m3t_tpu_torch import fused_serve, graphs

    graphs.clear_graphs()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv, truth, _ = graph(inp, models, "cuda")
    if not srv.SetUp():
        raise AssertionError(f"{label}: Tracker.SetUp failed")
    printed = io.StringIO()
    counters = launch_counters()
    for counter in counters.values():
        counter.launches = 0
    with contextlib.redirect_stdout(printed):
        ok = srv.RunTrackerProcess(execute_detection=True, start_tracking=True,
                                   max_iterations=HOST_FRAMES)
        torch.cuda.synchronize()
    launches = {name: counter.launches for name, counter in counters.items()}
    captured = graphs.captured()
    notice = printed.getvalue()
    sys.stdout.write(notice)
    if not ok:
        raise AssertionError(f"{label}: RunTrackerProcess failed")
    if any(launches.values()):
        raise AssertionError(f"{label}: the host path launched kernels: {launches}")
    backend, reason = fused_serve.FusedServeBackend.try_build(srv)
    if backend is not None or refusal not in reason:
        raise AssertionError(f"{label}: the fused backend did not refuse the graph with "
                             f"{refusal!r}: {reason!r}")
    if f"fused cycle unavailable ({reason})" not in notice:
        raise AssertionError(f"{label}: no fallback notice with {reason!r}: {notice!r}")
    off_card = [(owner, key, str(t.device)) for owner, key, t in graph_tensors(srv)
                if t.device.type != "cuda"]
    if off_card:
        raise AssertionError(f"{label}: tensors off the card: {off_card[:10]}")
    poses = graph_poses(srv)
    err = np.linalg.norm(poses[:, :3, 3] - truth[HOST_FRAMES - 1][:, :3, 3], axis=1)
    if not np.all(np.isfinite(poses)) or not np.all(err < 0.005):
        raise AssertionError(f"{label}: translation errors {err.tolist()} m (limit 5 mm)")
    by_name = {}
    for info in captured:
        by_name[info.name] = by_name.get(info.name, 0) + 1
    result = dict(
        path=label, links=len(poses), frames=HOST_FRAMES, refusal=reason,
        kernel_launches=sum(launches.values()), graphs=len(captured),
        graphs_by_function=by_name, replays=sum(i.replays for i in captured),
        translation_error_mm=[round(float(e) * 1e3, 4) for e in err],
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        tensors_on_card=len(graph_tensors(srv)))
    log(f"{label}: {json.dumps(result)}")
    graphs.clear_graphs()
    return result


def check_normal_image(inp, models):
    """Phase 10o's scene at frame 0 through one FullNormalRenderer at 640x512 on the
    card and on the CPU: the share of pixels whose triangle id differs, and the largest
    depth and normal differences where the ids agree.  More than 0.1 % differing fails."""
    from m3t_tpu_torch import renderer

    images = {}
    for dev in ("cuda", "cpu"):
        _, _, scene = occluded_scene_graph(inp, models, dev)
        for body, position in zip(scene["bodies"], HOST_BODIES):
            body.set_body2world_pose(moving(position)(0))
        if not (scene["color_camera"].SetUp() and scene["rg"].SetUp()):
            raise AssertionError(f"normal image: set-up failed on {dev}")
        full = renderer.FullNormalRenderer("host_normal", scene["rg"], scene["color_camera"],
                                           device=dev)
        if not full.SetUp():
            raise AssertionError(f"normal image: renderer set-up failed on {dev}")
        depth, ids, normals = full._render(renderer.IDType.BODY, with_normals=True)
        images[dev] = [t.cpu().numpy() for t in (depth, ids, normals)]
    (cd, ci, cn), (pd, pi, pn) = images["cuda"], images["cpu"]
    same = ci == pi
    both = same & np.isfinite(cd) & np.isfinite(pd)
    result = dict(
        pixels=int(ci.size), differing_id_share=float(1.0 - same.mean()),
        covered_share=float((pi > 0).mean()), ids=sorted(int(v) for v in np.unique(pi)),
        max_depth_diff_m=float(np.abs(cd[both] - pd[both]).max()),
        max_normal_diff=float(np.abs(cn[both] - pn[both]).max()))
    log(f"normal image 640x512, card vs CPU: {json.dumps(result)}")
    if result["differing_id_share"] > 1e-3:
        raise AssertionError(f"normal image: {result['differing_id_share']:.4%} of the "
                             f"pixels differ in id between card and CPU (limit 0.1 %)")
    if len(result["ids"]) != len(HOST_BODIES) + 2:
        raise AssertionError(f"normal image: ids {result['ids']}")
    return result


def nudged_pose(pose) -> np.ndarray:
    """The pose with its rotation and translation moved by a relative WITNESS_NUDGE."""
    pose = np.array(pose, np.float32)
    pose[:3] *= np.float32(1.0 + WITNESS_NUDGE)
    return pose


def nudged(state: dict) -> dict:
    """fused_serve.read_graph_state's result with every link pose nudged."""
    return dict(state, links={name: (body2joint, joint2parent, nudged_pose(link2world))
                              for name, (body2joint, joint2parent, link2world)
                              in state["links"].items()})


def entry_diffs(a, b, n_entries: int) -> dict:
    """The largest pose and histogram differences per batch entry between two graphs
    of the same names (histograms compared on the CPU)."""
    diffs = {"pose": np.abs(graph_poses(a) - graph_poses(b))}
    for name, x, y in zip(("histogram_f", "histogram_b"), graph_histograms(a),
                          graph_histograms(b)):
        diffs[name] = (x.cpu() - y.cpu()).abs().numpy()
    return {n: d.reshape(n_entries, -1).max(1) for n, d in diffs.items()}


def whole_image_render(soup, width, height, windows, chunk=64, with_normals=False):
    """ops/raster.rasterize_windows as the renderers call it, rendering every chunk over
    the whole image instead (ops/raster.rasterize: eager under disable_graphs, else
    graphed)."""
    from m3t_tpu_torch.ops import raster

    return raster.rasterize(soup, width, height, chunk=chunk, with_normals=with_normals)


# Form -> (what replaces ops/raster.rasterize_windows, whether graphed).
RENDER_FORMS = {"windows": (None, False),
                "whole_image": (whole_image_render, False),
                "graphed": (whole_image_render, True)}


def check_render_windows(inp, models):
    """Phase 10o's ten focused renderers over its scene at frame 0 in the three forms of
    RENDER_FORMS on the card (eager with each chunk over its window, the renderers' own
    form; eager over the whole image; the graphed whole-image rasterize, whose first
    pass captures and whose second replays), and in the windowed form on the CPU: the
    images of every form equal."""
    from unittest import mock

    from m3t_tpu_torch import graphs
    from m3t_tpu_torch.ops import raster

    result = {}
    for dev in ("cuda", "cpu"):
        graphs.clear_graphs()
        srv, _, scene = occluded_scene_graph(inp, models, dev)
        if not srv.SetUp():
            raise AssertionError(f"render windows: Tracker.SetUp failed on {dev}")
        for body, position in zip(scene["bodies"], HOST_BODIES):
            body.set_body2world_pose(moving(position)(0))
        renderers = srv.correspondence_renderer_ptrs
        images = {}
        for mode, (render, graphed) in RENDER_FORMS.items():
            if dev == "cpu" and mode != "windows":
                continue
            with (mock.patch.object(raster, "rasterize_windows", render) if render
                  else contextlib.nullcontext()), \
                    (contextlib.nullcontext() if graphed else graphs.disable_graphs()):
                for _ in range(2 if graphed else 1):
                    if not all(r.StartRendering() for r in renderers):
                        raise AssertionError(f"render windows: a render failed on {dev}")
            images[mode] = [t.cpu() for r in renderers
                            for t in (r.depth_image, getattr(r, "silhouette_image", None))
                            if t is not None]
        for mode, got in images.items():
            if not all(torch.equal(a, b) for a, b in zip(got, images["windows"])):
                raise AssertionError(f"render windows: the {mode} renders differ from the "
                                     f"windowed ones")
        if dev == "cuda":
            result["graphs"] = len(graphs.captured())
    graphs.clear_graphs()
    result["renderers"] = len(renderers)
    log(f"focused renders in {len(RENDER_FORMS)} forms equal: {json.dumps(result)}")
    return result


def check_host_card_against_cpu(label, graph, inp, models, n_steps: int = 2,
                                parted_allowed: int = 1, bounds=HOST_PARTED_BOUNDS):
    """Phase 10x: the graph on the card and on the CPU, detection and the starting
    step at frame 0, then a tracking step per frame, each step started on both devices
    from the CPU's state (fused_serve.read_graph_state / load_graph_state: joint poses,
    link poses, histograms).  Poses and histograms compared after the starting step and
    every step, batch entry by batch entry (a body, or a structure of two links);
    at most ``parted_allowed`` entries may part beyond PHASE7_ATOL, each within
    ``bounds``, logged by name and step.  A witness graph on the CPU starts every
    step from the CPU's state nudged (its detectors' poses at step 0); a card entry that
    parts where the witness does not part from the CPU is unexplained, and fails."""
    from m3t_tpu_torch import fused_serve

    trackers = {}
    for dev in ("cuda", "cpu", "witness"):
        trackers[dev] = graph(inp, models, "cpu" if dev == "witness" else dev)[0]
        if not trackers[dev].SetUp():
            raise AssertionError(f"{label}: Tracker.SetUp failed on {dev}")
        trackers[dev].ExecuteDetection(start_tracking=True)
    card, cpu, witness = trackers["cuda"], trackers["cpu"], trackers["witness"]
    for detector in witness.detector_ptrs:
        detector.link2world_pose = nudged_pose(detector.link2world_pose)
    names = [o.name for o in cpu.optimizer_ptrs]
    per_entry = len(graph_poses(cpu)) // len(names)
    worst = {n: 0.0 for n in HOST_PARTED_BOUNDS}
    parted, beyond, witnessed, unexplained = {}, [], {}, []
    for i in range(n_steps):
        for dev, srv in trackers.items():
            with contextlib.redirect_stdout(io.StringIO()):
                ok = (srv.UpdateCameras(i) and srv.CalculateConsistentPoses()
                      and srv.ExecuteDetectingStep(i) and srv.ExecuteStartingStep(i)
                      and srv.ExecuteTrackingStep(i))
            if not ok:
                raise AssertionError(f"{label}: step {i} failed on {dev}")
        diffs = entry_diffs(card, cpu, len(names))
        witness_diffs = entry_diffs(witness, cpu, len(names))
        for entry, name in enumerate(names):
            event = {n: float(d[entry]) for n, d in diffs.items()}
            moved = {n: float(d[entry]) for n, d in witness_diffs.items()}
            if any(d > PHASE7_ATOL for d in moved.values()):
                witnessed.setdefault(name, []).append(i)
                log(f"{label}: the nudged CPU parts from the CPU at {name}, step {i}: "
                    f"max abs diff {moved}")
            if any(d > PHASE7_ATOL for d in event.values()):
                parted.setdefault(name, []).append(i)
                log(f"{label}: {name} parted at step {i}: max abs diff {event}")
                if any(event[n] > b for n, b in bounds.items()):
                    beyond.append((name, i, event))
                if i not in witnessed.get(name, []):
                    unexplained.append((name, i, event))
        worst = {n: max(worst[n], float(d.max())) for n, d in diffs.items()}
        state = fused_serve.read_graph_state(cpu)
        fused_serve.load_graph_state(card, state)
        fused_serve.load_graph_state(witness, nudged(state))
    log(f"{label}: card vs CPU, {len(names)} entries of {per_entry} link(s), {n_steps} "
        f"steps from equal states: max abs diff {worst}; parted {parted} (allowed "
        f"{parted_allowed}, bounds {bounds}); the CPU nudged by a relative "
        f"{WITNESS_NUDGE} parts from the CPU at {witnessed}; unexplained {unexplained}")
    return dict(max_abs_diff=worst, parted=parted, parted_allowed=parted_allowed,
                beyond_bounds=beyond, witness_parted=witnessed, unexplained=unexplained,
                twin_mismatches=[])


# ----------------------------------------------------------------------------------------
# Phase 11: the evaluators and their entry points, on synthetic datasets in the published
# layouts, written with the port's PNG writer
# ----------------------------------------------------------------------------------------

EVAL_RBOT_FRAMES = 10      # 11r: frames per RBOT sequence (the dataset's 1000, cut)
EVAL_FRAMES = 5            # 11y keyframes per sequence; 11k, 11o tracked frames
EVAL_HOST_FRAMES = 3       # 11h: frames of each host-mode run
EVAL_CPU_RBOT_FRAMES = 5   # 11x: frames of the RBOT subset (the CPU's scene checks are slow)
EVAL_RBOT_SEQUENCES = ("a_regular", "b_dynamiclight", "c_noisy", "d_occlusion")
EVAL_RBOT_NOISE = {"a_regular": 6, "b_dynamiclight": 6, "c_noisy": 24, "d_occlusion": 6}
EVAL_YCB_SEQUENCES = (48, 49)
EVAL_YCB_BODIES = ("002_master_chef_can", "003_cracker_box", "005_tomato_soup_can")
EVAL_YCB_DEPTH_SCALE = 0.0001
EVAL_COLOURS = ((170, 60, 40), (60, 170, 60), (150, 50, 160))
# Region models of the RBOT bodies (the evaluator's own sphere radius and depth offsets;
# n_divides 1 (42 views) at image_size 800, where the reference takes n_divides 4 at
# 2000), and the region and depth models of the other datasets' bodies.
EVAL_RBOT_MODEL = dict(sphere_radius=0.8, n_divides=1, n_points=200,
                       max_radius_depth_offset=0.01, stride_depth_offset=0.002,
                       image_size=800)
EVAL_MODEL = dict(n_divides=1, n_points=200, image_size=400)
# 11x, 12x: how far a cycle's state (pose, histograms) may part, witnessed or not
# (compare_runs), as far as phase 10x lets a named entry part.
STATE_PARTED_BOUNDS = (1e-2, 1e-3, 1e-3)
EVAL_PARTED_ALLOWED = 1   # 11x, 12x: batch entries per case that may part
# 11x, 12x: how far the scores may differ once an entry parted: two parted structures
# moved the RTB study's ADD AUC by 3e-4 (NVIDIA H100 80GB HBM3, 700 W), before the
# port's depth windows divided by their stride count as jitted JAX does.
PARTED_SCORE_ATOL = 1e-3
SUCCESS_T, SUCCESS_R = 0.05, 5.0 * np.pi / 180.0  # the RBOT criterion, every 11x frame


def eval_meshes() -> dict:
    """The procedural meshes of phase 11's bodies (meters, body frame, 80 triangles per
    sphere): two clusters of overlapping spheres of different sizes, four and three, with
    no symmetry, so that a silhouette fixes their pose (an ellipsoid's or a cube's mirror
    symmetries let monocular region tracking drift, and a sphere's rotation wanders), and
    a smaller three-sphere cluster for RBOT's occluder, squirrel_small."""
    from m3t_tpu_torch.utils import procedural

    def spheres(spec):
        parts = [procedural.icosphere(1, r) for r, _ in spec]
        offsets = np.cumsum([0] + [len(v) for v, _ in parts[:-1]])
        return (np.concatenate([v + np.float32(c) for (v, _), (_, c) in zip(parts, spec)])
                .astype(np.float32), np.concatenate([t + o for (_, t), o in zip(parts, offsets)]))

    return {"quad": spheres([(0.035, (0.0, 0.0, 0.0)), (0.03, (0.05, 0.0, 0.01)),
                             (0.025, (-0.02, 0.045, -0.01)), (0.02, (0.0, -0.04, 0.03))]),
            "tri": spheres([(0.04, (-0.03, -0.01, 0.0)), (0.028, (0.045, 0.015, 0.0)),
                            (0.022, (0.0, 0.05, 0.02))]),
            "small": spheres([(0.025, (0.0, 0.0, 0.0)), (0.018, (0.03, 0.01, 0.0)),
                              (0.014, (0.0, 0.03, 0.012))])}


def eval_pose(translation, rotvec=(0.0, 0.0, 0.0)) -> np.ndarray:
    from scipy.spatial.transform import Rotation

    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_rotvec(rotvec).as_matrix()
    pose[:3, 3] = translation
    return pose


class FrameWriter:
    """Renders frames (render_frame), writes them with the port's PNG writer and reads
    each back with its reader, which must return the array written."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.files = 0

    def render(self, intr, items, noise: int = 6, gain: float = 1.0, depth_scale=None):
        """render_frame of ``items`` (vertices, triangles, camera-frame pose, colour)."""
        return render_frame(intr, [(v[t], pose, colour) for v, t, pose, colour in items],
                            self.rng, noise, gain, depth_scale)

    def write(self, path: Path, image: np.ndarray) -> None:
        from m3t_tpu_torch.utils import png

        path.parent.mkdir(parents=True, exist_ok=True)
        png.write_png(path, image)
        back = png.read_png(path)
        if back.dtype != image.dtype or not np.array_equal(back, image):
            raise AssertionError(f"11w: {path} reads back different from the frame written")
        self.files += 1


def pose_rows(poses, scale: float = 1.0) -> str:
    """Rows of 9 row-major rotation values and 3 translation values (times scale)."""
    return "\n".join(" ".join(f"{x:.9f}" for x in list(p[:3, :3].reshape(-1))
                              + list(p[:3, 3] * scale)) for p in poses) + "\n"


def write_rbot(root: Path, names, sequences, n_frames: int, writer: FrameWriter) -> dict:
    """11w: an RBOT dataset (<root>/<body>/<body>.obj in mm, <body>/frames/<sequence>
    <index:04d>.png, poses_first.txt and poses_second.txt in mm) at RBOT_INTRINSICS.
    Every body follows poses_first; squirrel_small follows poses_second in front of it
    in d_occlusion.  Bodies alternate between two meshes, and bodies of one mesh share
    their frames (hard links)."""
    from m3t_tpu_torch.eval.rbot_evaluator import OCCLUSION_BODY_NAME, RBOT_INTRINSICS
    from m3t_tpu_torch.utils.obj_loader import save_obj

    meshes = eval_meshes()
    first = [eval_pose((-0.01 + 0.002 * i, 0.005, 0.55), (0.3, 0.4 + 0.02 * i, 0.1 + 0.01 * i))
             for i in range(n_frames + 1)]
    second = [eval_pose((-0.10 + 0.008 * i, 0.02, 0.42)) for i in range(n_frames + 1)]
    for file, poses in (("poses_first.txt", first), ("poses_second.txt", second)):
        (root / file).write_text("# R11 R12 R13 R21 R22 R23 R31 R32 R33 tx ty tz\n"
                                 + pose_rows(poses, 1000.0))
    mesh_of = {name: ("quad", "tri")[k % 2] for k, name in enumerate(names)}
    mesh_of[OCCLUSION_BODY_NAME] = "small"
    for name, kind in mesh_of.items():
        (root / name).mkdir(parents=True, exist_ok=True)
        v, t = meshes[kind]
        save_obj(str(root / name / f"{name}.obj"), v * 1000.0, t)
    small = meshes["small"]
    for kind in sorted(set(mesh_of.values()) - {"small"}):
        v, t = meshes[kind]
        for seq in sequences:
            for i in range(n_frames):
                items = [(v, t, first[i], EVAL_COLOURS[0])]
                if seq == "d_occlusion":
                    items.append((*small, second[i], EVAL_COLOURS[1]))
                gain = 1.0 + 0.25 * np.sin(i) if seq == "b_dynamiclight" else 1.0
                colour, _ = writer.render(RBOT_INTRINSICS, items, EVAL_RBOT_NOISE[seq], gain)
                writer.write(root / "_frames" / kind / f"{seq}{i:04d}.png", colour)
    for name in names:
        (root / name / "frames").mkdir(exist_ok=True)
        for seq in sequences:
            for i in range(n_frames):
                os.link(root / "_frames" / mesh_of[name] / f"{seq}{i:04d}.png",
                        root / name / "frames" / f"{seq}{i:04d}.png")
    return mesh_of


def quaternion_rows(poses) -> str:
    from scipy.spatial.transform import Rotation

    rows = []
    for p in poses:
        q = Rotation.from_matrix(p[:3, :3]).as_quat()  # x y z w
        rows.append(f"{q[3]} {q[0]} {q[1]} {q[2]} {p[0, 3]} {p[1, 3]} {p[2, 3]}")
    return "\n".join(rows) + "\n"


def write_ycb(root: Path, ext: Path, writer: FrameWriter) -> dict:
    """11w: a YCB-Video dataset (<root>/data/<seq:04d>/<frame:06d>-color.png and
    -depth.png, 16-bit at depth scale 0.0001, image_sets/keyframe.txt, models/<body>/
    textured.obj) with the ground truth and the detector's poses of every keyframe
    (<ext>/poses/{gt,cosypose}/<seq:04d>_<body>.txt), at YCB_INTRINSICS: three bodies
    side by side per sequence; the detector 4 mm off in x."""
    from m3t_tpu_torch.eval.ycb_evaluator import YCB_INTRINSICS
    from m3t_tpu_torch.utils.obj_loader import save_obj

    meshes = eval_meshes()
    mesh_of = dict(zip(EVAL_YCB_BODIES, ("quad", "tri", "quad")))
    for name, kind in mesh_of.items():
        (root / "models" / name).mkdir(parents=True, exist_ok=True)
        save_obj(str(root / "models" / name / "textured.obj"), *meshes[kind])
    keyframes = []
    for s, seq in enumerate(EVAL_YCB_SEQUENCES):
        poses = {name: [eval_pose((-0.15 + 0.15 * k + 0.002 * i, 0.01 * s, 0.65 + 0.03 * k),
                                  (0.0, 0.015 * i, 0.3 * k)) for i in range(EVAL_FRAMES)]
                 for k, name in enumerate(EVAL_YCB_BODIES)}
        for i in range(EVAL_FRAMES):
            items = [(*meshes[mesh_of[name]], poses[name][i], EVAL_COLOURS[k])
                     for k, name in enumerate(EVAL_YCB_BODIES)]
            colour, depth = writer.render(YCB_INTRINSICS, items,
                                          depth_scale=EVAL_YCB_DEPTH_SCALE)
            directory = root / "data" / f"{seq:04d}"
            writer.write(directory / f"{i + 1:06d}-color.png", colour)
            writer.write(directory / f"{i + 1:06d}-depth.png", depth)
            keyframes.append(f"{seq:04d}/{i + 1:06d}")
        for name in EVAL_YCB_BODIES:
            for folder, offset in (("gt", 0.0), ("cosypose", 0.004)):
                (ext / "poses" / folder).mkdir(parents=True, exist_ok=True)
                detected = [p.copy() for p in poses[name]]
                for p in detected:
                    p[0, 3] += offset
                (ext / "poses" / folder / f"{seq:04d}_{name}.txt").write_text(
                    quaternion_rows(detected))
    (root / "image_sets").mkdir(exist_ok=True)
    (root / "image_sets" / "keyframe.txt").write_text("\n".join(keyframes) + "\n")
    return mesh_of


RTB_INTR = dict(fu=600.0, fv=600.0, ppu=319.5, ppv=239.5, width=640, height=480)
RTB_ARM = 0.13


def rtb_config(directory: Path) -> None:
    """<object>/model/tracker_config/config.yaml (the COMBINED mode's generator config):
    a two-link revolute structure (the four-sphere cluster and, 0.13 m along its x, the
    three-sphere cluster on a joint about z) with region and depth modalities on loader
    colour and depth cameras: tests/test_evaluators_extra.py's RTB configuration with
    depth added."""
    def matrix(pose):
        data = ", ".join(f"{v:g}" for v in np.asarray(pose).reshape(-1))
        return f"!!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n  data: [{data}]"

    intrinsics = "intrinsics:\n" + "".join(
        f"  {key}: {RTB_INTR[name]}\n" for key, name in (
            ("f_u", "fu"), ("f_v", "fv"), ("pp_x", "ppu"), ("pp_y", "ppv"),
            ("width", "width"), ("height", "height")))
    loader = 'load_index: 0\nn_leading_zeros: 0\nload_image_type: "png"\n'
    files = {
        "color_camera.yaml": f'%YAML:1.2\nload_directory: "."\n{intrinsics}'
                             f'image_name_pre: "color_"\n{loader}',
        "depth_camera.yaml": f'%YAML:1.2\nload_directory: "."\n{intrinsics}'
                             f'depth_scale: 0.001\nimage_name_pre: "depth_"\n{loader}',
        "child_link.yaml": f"%YAML:1.2\nbody2joint_pose: "
                           f"{matrix(eval_pose((RTB_ARM, 0.0, 0.0)))}\n"
                           "free_directions: [0, 0, 1, 0, 0, 0]\n",
        "detector.yaml": f"%YAML:1.2\nlink2world_pose: {matrix(np.eye(4))}\n",
    }
    model_yaml = '%YAML:1.2\nmodel_path: "INFER_FROM_NAME"\n' + "".join(
        f"{k}: {v}\n" for k, v in EVAL_MODEL.items())
    config = ["%YAML:1.2\nBody:\n"]
    for name in ("parent", "child"):
        files[f"{name}.yaml"] = ('%YAML:1.2\ngeometry_path: "INFER_FROM_NAME"\n'
                                 "geometry_unit_in_meter: 1.0\n"
                                 "geometry_counterclockwise: 1\ngeometry_enable_culling: 1\n")
        files[f"{name}_region_model.yaml"] = files[f"{name}_depth_model.yaml"] = model_yaml
        config.append(f'  - name: "{name}"\n    metafile_path: "{name}.yaml"\n')
    for cls, camera in (("LoaderColorCamera", "color_camera"),
                        ("LoaderDepthCamera", "depth_camera")):
        config.append(f'{cls}:\n  - name: "{camera}"\n    metafile_path: "{camera}.yaml"\n')
    for cls, kind in (("RegionModel", "region"), ("DepthModel", "depth")):
        config.append(f"{cls}:\n")
        for name in ("parent", "child"):
            config.append(f'  - name: "{name}_{kind}_model"\n'
                          f'    metafile_path: "{name}_{kind}_model.yaml"\n'
                          f'    body: "{name}"\n')
    for cls, kind, camera in (("RegionModality", "region", "color_camera"),
                              ("DepthModality", "depth", "depth_camera")):
        config.append(f"{cls}:\n")
        for name in ("parent", "child"):
            config.append(f'  - name: "{name}_{kind}_modality"\n    body: "{name}"\n'
                          f'    {camera}: "{camera}"\n'
                          f'    {kind}_model: "{name}_{kind}_model"\n')
    config.append(
        'Link:\n  - name: "child_link"\n    metafile_path: "child_link.yaml"\n'
        '    body: "child"\n'
        '    modalities: ["child_region_modality", "child_depth_modality"]\n'
        '  - name: "parent_link"\n    body: "parent"\n'
        '    modalities: ["parent_region_modality", "parent_depth_modality"]\n'
        '    child_links: ["child_link"]\n'
        'Optimizer:\n  - name: "structure_optimizer"\n    root_link: "parent_link"\n'
        'StaticDetector:\n  - name: "detector"\n    metafile_path: "detector.yaml"\n'
        '    optimizer: "structure_optimizer"\n'
        'Tracker:\n  - name: "tracker"\n    optimizers: ["structure_optimizer"]\n'
        '    detectors: ["detector"]\n')
    files["config.yaml"] = "".join(config)
    directory.mkdir(parents=True, exist_ok=True)
    for name, text in files.items():
        (directory / name).write_text(text)


def write_rtb(root: Path, writer: FrameWriter) -> None:
    """11w: an RTB dataset: <root>/two_link/model/tracker_config (rtb_config), and per
    sequence <root>/two_link/easy/<seq:03d>/rgb/color_<i>.png, depth_ground_truth/
    depth_<i>.png (1 mm) and poses_gt/{parent,child}.txt (rows of 9 + 3, world frame =
    camera frame): the structure turning its joint by 0.04 rad per frame."""
    from m3t_tpu_torch.common import Intrinsics
    from m3t_tpu_torch.utils.obj_loader import save_obj

    meshes = eval_meshes()
    config = root / "two_link" / "model" / "tracker_config"
    rtb_config(config)
    save_obj(str(config / "parent.obj"), *meshes["quad"])
    save_obj(str(config / "child.obj"), *meshes["tri"])
    intr = Intrinsics(**RTB_INTR)
    for seq in (0, 1):
        base = root / "two_link" / "easy" / f"{seq:03d}"
        parent = [eval_pose((-0.08 + 0.03 * seq + 0.002 * i, -0.02, 0.6), (0.0, 0.0, 0.2 * seq))
                  for i in range(EVAL_FRAMES + 1)]
        child = [p @ eval_pose((0.0, 0.0, 0.0), (0.0, 0.0, 0.04 * i))
                 @ eval_pose((RTB_ARM, 0.0, 0.0)) for i, p in enumerate(parent)]
        for i in range(EVAL_FRAMES + 1):
            colour, depth = writer.render(intr, [(*meshes["quad"], parent[i], EVAL_COLOURS[0]),
                                                 (*meshes["tri"], child[i], EVAL_COLOURS[1])],
                                          depth_scale=0.001)
            writer.write(base / "rgb" / f"color_{i}.png", colour)
            writer.write(base / "depth_ground_truth" / f"depth_{i}.png", depth)
        (base / "poses_gt").mkdir(parents=True, exist_ok=True)
        (base / "poses_gt" / "parent.txt").write_text(pose_rows(parent))
        (base / "poses_gt" / "child.txt").write_text(pose_rows(child))


def write_opt(root: Path, writer: FrameWriter) -> None:
    """11w: an OPT dataset in the generic layout at OPT_INTRINSICS (1920x1080):
    <root>/Model3D/quad/quad.obj, 3D/seq1/color/<i:04d>.png, depth/<i:04d>.png
    (1 mm) from 1, and 3D/seq1/quad.txt (rows of 9 + 3)."""
    from m3t_tpu_torch.eval.opt_evaluator import OPT_INTRINSICS
    from m3t_tpu_torch.utils.obj_loader import save_obj

    mesh = eval_meshes()["quad"]
    (root / "Model3D" / "quad").mkdir(parents=True, exist_ok=True)
    save_obj(str(root / "Model3D" / "quad" / "quad.obj"), *mesh)
    seq = root / "3D" / "seq1"
    poses = [eval_pose((0.02 + 0.002 * i, -0.01, 0.6), (0.1, 0.015 * i, 0.0))
             for i in range(EVAL_FRAMES + 1)]
    for i in range(EVAL_FRAMES):
        colour, depth = writer.render(OPT_INTRINSICS, [(*mesh, poses[i], EVAL_COLOURS[2])],
                                      depth_scale=0.001)
        writer.write(seq / "color" / f"{i + 1:04d}.png", colour)
        writer.write(seq / "depth" / f"{i + 1:04d}.png", depth)
    (seq / "quad.txt").write_text(pose_rows(poses))


def write_choi(ext: Path, writer: FrameWriter) -> None:
    """11w: a Choi sequence at CHOI_INTRINSICS: <ext>/models/kinect_box.obj and
    <ext>/seq_synth_kinect_box_kitchen/color<i:04d>.png, depth<i:04d>.png (0.1 mm) from
    0, with poses_gt.txt (rows of 9 + 3)."""
    from m3t_tpu_torch.eval.choi_evaluator import CHOI_INTRINSICS
    from m3t_tpu_torch.utils.obj_loader import save_obj

    mesh = eval_meshes()["quad"]
    (ext / "models").mkdir(parents=True, exist_ok=True)
    save_obj(str(ext / "models" / "kinect_box.obj"), *mesh)
    seq = ext / "seq_synth_kinect_box_kitchen"
    poses = [eval_pose((-0.01, 0.02 - 0.0015 * i, 0.55), (0.0, 0.0, 0.02 * i))
             for i in range(EVAL_FRAMES + 1)]
    for i in range(EVAL_FRAMES):
        colour, depth = writer.render(CHOI_INTRINSICS, [(*mesh, poses[i], EVAL_COLOURS[0])],
                                      depth_scale=0.0001)
        writer.write(seq / f"color{i:04d}.png", colour)
        writer.write(seq / f"depth{i:04d}.png", depth)
    (seq / "poses_gt.txt").write_text(pose_rows(poses))


def make_eval_model(spec: dict) -> None:
    """Generates one model (run in a process of its own by prepare_eval_models): a Body
    from spec["obj"] as the evaluators load it and a region or depth model of it."""
    from m3t_tpu_torch.body import Body
    from m3t_tpu_torch.depth_model import DepthModel
    from m3t_tpu_torch.region_model import RegionModel

    body = Body(spec["body"], geometry_path=spec["obj"],
                geometry_unit_in_meter=spec["unit"], geometry_counterclockwise=True,
                geometry_enable_culling=spec["culling"])
    if not body.SetUp():
        raise RuntimeError(f"body {spec['body']} failed to set up")
    cls = RegionModel if spec["kind"] == "region" else DepthModel
    if not cls(f"{spec['body']}_{spec['kind']}", body, spec["path"],
               **spec["params"]).SetUp():
        raise RuntimeError(f"model {spec['path']} failed to set up")


def prepare_eval_models(specs, targets) -> float:
    """Phase 11's distinct models, one process each, all started together; then each
    copied under the names of every body with its mesh and settings (a model's cache
    key is its parameters and its body's geometry, not its name).  Returns seconds."""
    begin = time.perf_counter()
    root = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, "-c",
                               f"import chip_smoke; chip_smoke.make_eval_model({spec!r})"],
                              cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for spec in specs]
    outs = [proc.communicate(timeout=600)[0] for proc in procs]
    failed = [(spec["path"], out[-2000:]) for spec, proc, out in zip(specs, procs, outs)
              if proc.returncode != 0]
    if failed:
        raise AssertionError(f"11w: model generation failed: {failed}")
    for source, destinations in targets.items():
        for destination in destinations:
            Path(destination).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(source, destination)
    return time.perf_counter() - begin


def write_eval_datasets(root: Path, rbot_names) -> dict:
    """11w: every dataset of phase 11 under root, and their models; returns the
    directories, the frame counts and the seconds."""
    begin = time.perf_counter()
    writer = FrameWriter(seed=31)
    ds = {name: root / name for name in ("rbot", "rbot_ext", "ycb", "ycb_ext", "rtb",
                                         "opt", "opt_ext", "choi", "choi_ext", "models")}
    for directory in ds.values():
        directory.mkdir(parents=True, exist_ok=True)
    rbot_mesh = write_rbot(ds["rbot"], rbot_names, EVAL_RBOT_SEQUENCES, EVAL_RBOT_FRAMES,
                           writer)
    ycb_mesh = write_ycb(ds["ycb"], ds["ycb_ext"], writer)
    write_rtb(ds["rtb"], writer)
    write_opt(ds["opt"], writer)
    write_choi(ds["choi_ext"], writer)
    written_s = time.perf_counter() - begin
    specs, targets = [], {}
    for kind in ("quad", "tri", "small"):
        names = [n for n, k in rbot_mesh.items() if k == kind]
        path = str(ds["models"] / f"rbot_{kind}.npz")
        specs.append(dict(body=names[0], obj=str(ds["rbot"] / names[0] / f"{names[0]}.obj"),
                          unit=0.001, culling=False, kind="region", path=path,
                          params=EVAL_RBOT_MODEL))
        targets[path] = [ds["rbot_ext"] / f"{n}_model.npz" for n in names]
    config = ds["rtb"] / "two_link" / "model" / "tracker_config"
    for kind, link in (("quad", "parent"), ("tri", "child")):
        names = [n for n, k in ycb_mesh.items() if k == kind]
        for model in ("region", "depth"):
            path = str(ds["models"] / f"{kind}_{model}.npz")
            specs.append(dict(body=names[0],
                              obj=str(ds["ycb"] / "models" / names[0] / "textured.obj"),
                              unit=1.0, culling=True, kind=model, path=path,
                              params=EVAL_MODEL))
            # The generator's INFER_FROM_NAME model path: <name>_rmodel.npz, _dmodel.npz.
            targets[path] = ([ds["ycb_ext"] / "models" / f"{n}_{model}_model.npz"
                              for n in names]
                             + [config / f"{link}_{model}_model_{model[0]}model.npz"])
            if kind == "quad":
                targets[path] += [ds["opt_ext"] / f"quad_{model}_model.npz",
                                  ds["choi_ext"] / f"kinect_box_{model}_model.npz"]
    models_s = prepare_eval_models(specs, targets)
    result = dict(files=writer.files, write_and_check_s=written_s, models_s=models_s,
                  distinct_models=len(specs))
    log(f"11w: {writer.files} PNG frames written and read back equal in {written_s:.1f} s, "
        f"{len(specs)} models generated in parallel in {models_s:.1f} s")
    return ds, result


def nudged_poses(poses):
    """Poses (..., 4, 4) with rotation and translation moved by a relative WITNESS_NUDGE."""
    poses = np.array(poses, np.float32)
    poses[..., :3, :] *= np.float32(1.0 + WITNESS_NUDGE)
    return poses


def rbot_args(ds, names, sequences, device) -> list:
    """The RBOT entry point's arguments for phase 11's dataset: the occlusion sequence's
    partner modelled and region checking on, the cut models and frame count."""
    return [str(ds["rbot"]), str(ds["rbot_ext"]), "--bodies", *names,
            "--sequences", *sequences, "--model-occlusions", "--region-checking",
            "--n-frames", str(EVAL_RBOT_FRAMES), "--model-divides", "1",
            "--model-points", "200", "--model-image-size", "800", "--device", device]


def rbot_case(ds, names, sequences, fused=True, n_frames=EVAL_RBOT_FRAMES):
    """make(device, nudge) -> (evaluator, patches): the RBOT evaluator as the entry point
    builds it; nudged, its ground-truth poses move by WITNESS_NUDGE."""
    from m3t_tpu_torch.eval import rbot_evaluator
    from m3t_tpu_torch.examples import evaluate_rbot_dataset as entry

    def make(device, nudge=False):
        ev = entry.make_evaluator(entry.parse_args(rbot_args(ds, names, sequences, device)))
        ev.use_fused_pipeline = fused
        ev.n_frames = n_frames
        read = rbot_evaluator.read_poses_rbot
        return ev, ([(rbot_evaluator, "read_poses_rbot",
                      lambda *a: nudged_poses(read(*a)))] if nudge else [])
    return make


def ycb_case(ds, sequences=EVAL_YCB_SEQUENCES, fused=True, n_keyframes=None):
    """The YCB-Video evaluator in the reference configuration (evaluate_ycb_dataset.py)
    with phase 11's cut models; nudged, the ground-truth and detector poses move."""
    from m3t_tpu_torch.eval import ycb_evaluator

    def make(device, nudge=False):
        ev = ycb_evaluator.YCBEvaluator(
            "ycb", str(ds["ycb"]), str(ds["ycb_ext"]), list(sequences),
            {seq: list(EVAL_YCB_BODIES) for seq in sequences}, device=device)
        ev.use_fused_pipeline = fused

        def region_modality(m):
            m.n_lines_max, m.scales, m.standard_deviations = 200, [7, 4, 2], [25.0, 15.0, 10.0]

        def depth_modality(m):
            m.n_points_max, m.considered_distances = 200, [0.07, 0.05, 0.04]

        def tracker(t):
            t.n_corr_iterations, t.n_update_iterations = 4, 2

        def model(m):
            for key, value in EVAL_MODEL.items():
                setattr(m, key, value)

        ev.region_modality_setter, ev.depth_modality_setter = region_modality, depth_modality
        ev.tracker_setter = tracker
        ev.region_model_setter = ev.depth_model_setter = model
        ev.SetUp()
        if n_keyframes is not None:
            ev.keyframes = {s: k[:n_keyframes] for s, k in ev.keyframes.items()}
        read = ycb_evaluator.read_quaternion_poses

        def nudged_read(path):
            poses, valid = read(path)
            return nudged_poses(poses), valid
        return ev, ([(ycb_evaluator, "read_quaternion_poses", nudged_read)]
                    if nudge else [])
    return make


def rtb_case(ds, sequences=(0, 1), fused=True, n_rows=None):
    """The RTB evaluator in the reference configuration (6 x 2 iterations) over phase 11's
    structure; n_rows cuts the ground truth (and so the frames); nudged, it moves."""
    from m3t_tpu_torch.eval import rtb_evaluator

    def make(device, nudge=False):
        ev = rtb_evaluator.RTBEvaluator("rtb", str(ds["rtb"]), str(ds["rtb"]), ["two_link"],
                                        ["easy"], ["depth_ground_truth"], list(sequences),
                                        device=device)
        ev.use_fused_pipeline = fused

        def tracker(t):
            t.n_corr_iterations, t.n_update_iterations = 6, 2

        ev.tracker_setter = tracker
        read = rtb_evaluator.RTBEvaluator._load_gt_poses

        def load(gt_dir, body_names):
            gt = read(gt_dir, body_names)
            return {name: (nudged_poses(p) if nudge else p)[:n_rows] for name, p in gt.items()}
        return ev, [(ev, "_load_gt_poses", load)]
    return make


def serve_case(ds, dataset: str, fused=True):
    """The OPT or Choi evaluator in its reference configuration (evaluate_opt_dataset.py,
    evaluate_choi_dataset.py) with phase 11's cut models; nudged, its ground truth (and
    so its detector's pose) moves."""
    from m3t_tpu_torch.eval import choi_evaluator, opt_evaluator

    def make(device, nudge=False):
        if dataset == "opt":
            ev = opt_evaluator.OPTEvaluator("opt", str(ds["opt"]), str(ds["opt_ext"]),
                                            ["quad"], sequence_names=["seq1"],
                                            device=device)
            scales, stds = [6, 4, 1], [15.0, 5.0, 1.5]
            distances, depth_stds = [0.05, 0.02, 0.01], [0.035, 0.035, 0.025]
            read = opt_evaluator.read_matrix_poses
            patches = [(opt_evaluator, "read_matrix_poses",
                        lambda path: nudged_poses(read(path)))]
        else:
            ev = choi_evaluator.ChoiEvaluator("choi", str(ds["choi"]), str(ds["choi_ext"]),
                                              ["kinect_box"], device=device)
            scales, stds, distances, depth_stds = [2, 1], [5.0], [0.01], [0.01, 0.001]
            read = choi_evaluator.ChoiEvaluator._read_gt_poses
            patches = [(ev, "_read_gt_poses", lambda d: nudged_poses(read(d)))]
        ev.use_fused_pipeline = fused

        def region_modality(m):
            m.n_lines_max, m.scales, m.standard_deviations = 200, scales, stds

        def depth_modality(m):
            m.n_points_max, m.use_depth_scaling, m.stride_length = 200, False, 0.005
            m.considered_distances, m.standard_deviations = distances, depth_stds

        def model(m):
            for key, value in EVAL_MODEL.items():
                setattr(m, key, value)

        ev.region_modality_setter, ev.depth_modality_setter = region_modality, depth_modality
        ev.region_model_setter = ev.depth_model_setter = model
        return ev, (patches if nudge else [])
    return make


@contextlib.contextmanager
def patched(patches):
    saved = [(owner, name, owner.__dict__.get(name, None), name in owner.__dict__)
             for owner, name, _ in patches]
    for owner, name, value in patches:
        setattr(owner, name, value)
    try:
        yield
    finally:
        for owner, name, value, had in reversed(saved):
            if had:
                setattr(owner, name, value)
            else:
                delattr(owner, name)


class ScoredPoses:
    """Stands in for an evaluator module's ``metrics``: every call passes through, and
    the pose and ground truth of each scoring call are kept in order."""

    SCORED = {"translation_error": 0, "add_error": 1}  # name -> index of the pose

    def __init__(self, module):
        self._module, self.pairs = module, []

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in self.SCORED:
            return fn
        at = self.SCORED[name]

        def scored(*args, **kwargs):
            self.pairs.append((np.array(args[at], np.float64),
                               np.array(args[at + 1], np.float64)))
            return fn(*args, **kwargs)
        return scored


@contextlib.contextmanager
def launches_per_call(owner, name):
    """The kernel launches of each call of owner.<name> made inside the block."""
    counters, real, per_call = launch_counters(), getattr(owner, name), []

    def counted(*args, **kwargs):
        before = {n: fn.launches for n, fn in counters.items()}
        out = real(*args, **kwargs)
        per_call.append({n: fn.launches - before[n] for n, fn in counters.items()})
        return out

    setattr(owner, name, counted)
    try:
        yield per_call
    finally:
        setattr(owner, name, real)


def run_eval(label, make, device, nudge=False) -> dict:
    """One evaluation: its results, the poses it scored and its seconds; no model may
    be generated during it (phase 11's are all prepared)."""
    ev, patches = make(device, nudge)
    module = sys.modules[type(ev).__module__]
    spy = ScoredPoses(module.metrics)
    out = io.StringIO()
    with patched(patches + [(module, "metrics", spy)]), contextlib.redirect_stdout(out):
        begin = time.perf_counter()
        results = ev.Evaluate()
        seconds = time.perf_counter() - begin
    if "Start generating" in out.getvalue():
        raise AssertionError(f"{label} on {device}: a model was generated during the run")
    return dict(results=results, pairs=spy.pairs, seconds=seconds, text=out.getvalue())


def score_leaves(results, prefix="") -> dict:
    """The numbers of an evaluator's results, by path, without times and curves."""
    leaves = {}
    for key, value in results.items():
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            leaves.update(score_leaves(value, path))
        elif isinstance(value, (int, float)) and "time" not in path:
            leaves[path] = float(value)
    return leaves


def frame_success(pose, gt) -> bool:
    from m3t_tpu_torch.eval import metrics

    return metrics.tracking_success(pose, gt, SUCCESS_T, SUCCESS_R)


# The fused cycles that the evaluators and the serve backend call, by the position of
# their state argument.
EVAL_CYCLES = {"tracking_cycle": 4, "tracking_cycle_rgbd": 8, "tracking_cycle_kinematic": 5}


@contextlib.contextmanager
def cycle_calls(replay=None):
    """Every call of the pipeline's fused cycles inside the block, as (name, args,
    kwargs, result).  With ``replay`` (the calls of an earlier run), call k starts from
    the state (and the occluder poses) of that run's call k, moved to this call's
    device: each cycle of the two runs starts from equal states, as in phase 7."""
    from m3t_tpu_torch import pipeline

    real = {name: getattr(pipeline, name) for name in EVAL_CYCLES}
    calls = []

    def wrap(name):
        at = EVAL_CYCLES[name]

        def cycle(*args, **kwargs):
            args = list(args)
            if replay is not None:
                _, given, given_kwargs, _ = replay[len(calls)]
                dev = args[at][0].device
                args[at] = type(args[at])(*(t.to(dev) for t in given[at]))
                if kwargs.get("occluder_poses") is not None:
                    kwargs["occluder_poses"] = given_kwargs["occluder_poses"].to(dev)
            out = real[name](*args, **kwargs)
            calls.append((name, args, kwargs, out))
            return out
        return cycle

    for name in EVAL_CYCLES:
        setattr(pipeline, name, wrap(name))
    try:
        yield calls
    finally:
        for name, fn in real.items():
            setattr(pipeline, name, fn)


def field_diffs(a, b) -> np.ndarray:
    """(fields, entries): the largest difference of each batch entry in each field of
    two states."""
    return np.stack([(x.cpu() - y.cpu()).abs().reshape(x.shape[0], -1).amax(1).numpy()
                     for x, y in zip(a, b)])


def state_diffs(a, b) -> np.ndarray:
    """The largest difference of each batch entry over every field of two states."""
    return field_diffs(a, b).max(axis=0)


def compare_eval(label, make) -> dict:
    """11x: compare_runs of the evaluation that ``make`` builds (run_eval)."""
    return compare_runs(f"11x {label}", lambda device: run_eval(label, make, device))


def compare_runs(label, run) -> dict:
    """11x and 12x: run(device) -> dict(results, pairs, seconds) on the card and on the
    CPU on the same files, each fused cycle of the card's run started from the state
    that the CPU's run gave that cycle (cycle_calls), every kernel call of the card's
    run held against its plain twin on the same inputs (twin_mismatches).  Per batch
    entry (a run, a hidden partner, a body of a run, or a structure), every cycle's
    state (poses or joint poses, histograms) within PHASE7_ATOL, the same success flag
    in every scored pose (pairs: (pose, ground truth)), the scored poses and the scores
    (results' numbers) within PHASE7_ATOL.  An entry parts where a cycle's state differs
    beyond PHASE7_ATOL; at most EVAL_PARTED_ALLOWED entries may part, each by no more
    than STATE_PARTED_BOUNDS in each field, and only in a cycle where the CPU, run again
    from its own state nudged by a relative WITNESS_NUDGE, parts from itself at that
    entry (a rounding-boundary event that the CPU meets alone); once an entry parted,
    the scored poses may differ by STATE_PARTED_BOUNDS' pose limit and the scores by
    PARTED_SCORE_ATOL.  Returns the comparison, with ``failed`` set where it does not
    hold (the caller fails after every case)."""
    from m3t_tpu_torch import pipeline

    with cycle_calls() as cpu_calls:
        cpu = run("cpu")
    with cycle_calls(replay=cpu_calls) as card_calls, recorded_launches() as kernel_calls:
        card = run("cuda")
    mismatches = twin_mismatches(kernel_calls)
    if len(card_calls) != len(cpu_calls) or len(card["pairs"]) != len(cpu["pairs"]):
        raise AssertionError(f"{label}: {len(card_calls)} cycles and {len(card['pairs'])} "
                             f"scored poses on the card, {len(cpu_calls)} and "
                             f"{len(cpu['pairs'])} on the CPU")
    worst, parted, witnessed, unexplained = np.zeros(0), {}, {}, []
    for k, ((name, _, _, got), (_, cpu_args, cpu_kwargs, want)) in enumerate(
            zip(card_calls, cpu_calls)):
        diffs = state_diffs(got, want)
        worst = diffs if worst.size == 0 else np.maximum(worst, diffs)
        events = np.flatnonzero(diffs > PHASE7_ATOL).tolist()
        if not events:
            continue
        witness_args = list(cpu_args)
        state = cpu_args[EVAL_CYCLES[name]]
        witness_args[EVAL_CYCLES[name]] = type(state)(
            torch.as_tensor(nudged_poses(state[0].numpy())), *state[1:])
        moved = state_diffs(getattr(pipeline, name)(*witness_args, **cpu_kwargs), want)
        fields = field_diffs(got, want)
        for entry in events:
            parted.setdefault(entry, []).append(k)
            within = all(d <= limit
                         for d, limit in zip(fields[:, entry], STATE_PARTED_BOUNDS))
            if within and moved[entry] > PHASE7_ATOL:
                witnessed.setdefault(entry, []).append(k)
            else:
                unexplained.append((entry, k, float(diffs[entry]), float(moved[entry])))
            log(f"{label}: entry {entry} parted in cycle {k} by {diffs[entry]:.3e} (by "
                f"field: {', '.join(f'{d:.3e}' for d in fields[:, entry])}); the CPU from "
                f"its state nudged moves it by {moved[entry]:.3e}")
    flags = [k for k, ((pa, ga), (pb, gb)) in enumerate(zip(card["pairs"], cpu["pairs"]))
             if frame_success(pa, ga) != frame_success(pb, gb)]
    pose_diff = max((float(np.abs(pa - pb).max()) for (pa, _), (pb, _) in
                     zip(card["pairs"], cpu["pairs"])), default=0.0)
    leaves = {dev: score_leaves(r["results"]) for dev, r in (("card", card), ("cpu", cpu))}
    counts = [k for k in leaves["cpu"] if k.rsplit("/", 1)[-1].startswith("n_")
              and leaves["card"].get(k) != leaves["cpu"][k]]
    score_diff = max((abs(leaves["card"].get(k, np.inf) - v) for k, v in leaves["cpu"].items()),
                     default=0.0)
    score_atol = PARTED_SCORE_ATOL if parted else PHASE7_ATOL
    pose_atol = STATE_PARTED_BOUNDS[0] if parted else PHASE7_ATOL
    failed = bool(flags or counts or unexplained or mismatches
                  or len(parted) > EVAL_PARTED_ALLOWED
                  or score_diff > score_atol or pose_diff > pose_atol)
    result = dict(failed=failed, cycles=len(cpu_calls), entries=len(worst),
                  scored_poses=len(cpu["pairs"]),
                  max_abs_state_diff=float(worst.max()) if worst.size else None,
                  max_abs_pose_diff=pose_diff, max_abs_score_diff=float(score_diff),
                  pose_atol=pose_atol, score_atol=score_atol,
                  parted=parted, parted_allowed=EVAL_PARTED_ALLOWED,
                  witness_parted=witnessed, unexplained=unexplained,
                  flag_mismatches=flags, count_mismatches=counts,
                  kernel_calls=len(kernel_calls), twin_mismatches=mismatches,
                  card_s=card["seconds"], cpu_s=cpu["seconds"])
    log(f"{label}: card vs CPU: {json.dumps(result)}")
    return result


def card_eval(label, make, cycle_owner, cycle_name, want_every_call=()) -> dict:
    """One evaluation on the card with every kernel launch counted from 0 and peak memory
    read: the launches in all, and in each call of cycle_owner.<cycle_name> (the fused
    cycle, or the tracker's step), each of which must launch every kernel named in
    want_every_call."""
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with launches_per_call(cycle_owner, cycle_name) as per_call:
        run = run_eval(label, make, "cuda")
    launches = {n: fn.launches for n, fn in counters.items()}
    missing = [(k, name) for k, call in enumerate(per_call) for name in want_every_call
               if call[name] <= 0]
    if not per_call or missing:
        raise AssertionError(f"{label}: {len(per_call)} calls of {cycle_name}; calls "
                             f"without a kernel that each must launch: {missing}")
    run.update(launches=launches, calls=len(per_call),
               launches_per_call={n: [c[n] for c in per_call] for n in launches},
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    return run


def run_phase11(root: Path):
    """Phase 11: the evaluators and their entry points on the card (see the module's
    docstring), on datasets written under root.  Returns the "eval" record of the JSON
    line and the datasets' directories (ds), which phase 12 reuses."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.eval import metrics
    from m3t_tpu_torch.examples.evaluate_rbot_dataset import ALL_BODIES

    begin = time.perf_counter()
    names = ALL_BODIES[:18]
    ds, datasets = write_eval_datasets(root, names)
    out = {"datasets": datasets}
    # 11r: RBOT at the width of its evaluation: 18 bodies x 4 sequences and the
    # occlusion sequence's hidden partners, B = 90, through the entry point's
    # configuration; then the entry point itself in a process of its own.
    run = card_eval("11r rbot", rbot_case(ds, names, EVAL_RBOT_SEQUENCES), pipeline,
                    "tracking_cycle",
                    ("sample_lines", "bin_counts", "query_eval", "newton_step",
                     "scene_coeffs"))
    res = run["results"]
    n_runs = len(res["per_run"])
    rbot = dict(batch=n_runs + len(names), runs=n_runs, frames=EVAL_RBOT_FRAMES,
                tracking_success=res["tracking_success"], launches=run["launches"],
                launches_per_frame={n: v / EVAL_RBOT_FRAMES
                                    for n, v in run["launches"].items()},
                cycle_launches_per_frame={n: sorted(set(v)) for n, v in
                                          run["launches_per_call"].items()},
                peak_memory_bytes=run["peak_memory_bytes"], seconds=run["seconds"])
    if n_runs != len(names) * len(EVAL_RBOT_SEQUENCES) or res["tracking_success"] < 0.9:
        raise AssertionError(f"11r: {n_runs} runs, tracking success "
                             f"{res['tracking_success']}")
    log(f"11r: {json.dumps(rbot)}")
    begin_entry = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "m3t_tpu_torch.examples.evaluate_rbot_dataset",
         *rbot_args(ds, names, EVAL_RBOT_SEQUENCES, "cuda")],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    rbot["entry_point"] = dict(rc=proc.returncode, last_line=last,
                               seconds=time.perf_counter() - begin_entry)
    if proc.returncode != 0 or last != f"tracking success: {res['tracking_success']:.4f}":
        raise AssertionError(f"11r: the entry point exited {proc.returncode} and printed "
                             f"{last!r} (in process {res['tracking_success']:.4f}): "
                             f"{proc.stderr[-3000:]}")
    log(f"11r: python -m m3t_tpu_torch.examples.evaluate_rbot_dataset printed "
        f"{last!r} in {rbot['entry_point']['seconds']:.1f} s")
    out["rbot"] = rbot
    # 11y, 11k, 11o: YCB-Video fused RGB-D, RTB fused kinematic with depth, OPT and
    # Choi through the serve path.
    fused = {
        "ycb": (ycb_case(ds), pipeline, "tracking_cycle_rgbd",
                ("sample_lines", "bin_counts", "sample_windows", "newton_step"), "add_auc",
                0.8),
        "rtb": (rtb_case(ds), pipeline, "tracking_cycle_kinematic",
                ("sample_lines", "bin_counts", "sample_windows"), "add_auc", 0.8),
        "opt": (serve_case(ds, "opt"), metrics, "execute_tracking_step_maybe_fused",
                ("sample_lines", "bin_counts", "sample_windows", "newton_step"), "auc", 0.7),
        "choi": (serve_case(ds, "choi"), metrics, "execute_tracking_step_maybe_fused",
                 ("sample_lines", "bin_counts", "sample_windows", "newton_step"), None,
                 None)}
    for label, (make, owner, name, want, score, floor) in fused.items():
        run = card_eval(f"11 {label}", make, owner, name, want)
        res = run["results"]
        record = dict(launches=run["launches"], calls=run["calls"], seconds=run["seconds"],
                      peak_memory_bytes=run["peak_memory_bytes"], scores=score_leaves(res))
        if label in ("opt", "choi"):
            per = res["per_run"] if label == "opt" else res["per_body"]
            record["fused_steps"] = next(iter(per.values()))["execution_times"]["fused"]
            if not record["fused_steps"]:
                raise AssertionError(f"11o {label}: the steps did not serve fused")
        if label == "choi":
            worst = max(v for k, v in score_leaves(res).items() if "/rmse_" in k)
            if not worst < 10.0:
                raise AssertionError(f"11o choi: RMSE up to {worst} mm or deg")
        elif res[score] < floor:
            raise AssertionError(f"11 {label}: {score} {res[score]} < {floor}")
        out[label] = record
        log(f"11 {label}: {json.dumps(record)}")
    # 11h: RBOT, YCB-Video and RTB on the host path, a few frames each.
    counters = launch_counters()
    host = {}
    for label, make in (
            ("rbot", rbot_case(ds, names[:1], ["a_regular"], fused=False,
                               n_frames=EVAL_HOST_FRAMES)),
            ("ycb", ycb_case(ds, EVAL_YCB_SEQUENCES[:1], fused=False,
                             n_keyframes=EVAL_HOST_FRAMES)),
            ("rtb", rtb_case(ds, (0,), fused=False, n_rows=EVAL_HOST_FRAMES + 1))):
        before = {n: fn.launches for n, fn in counters.items()}
        run = run_eval(f"11h {label}", make, "cuda")
        leaves = score_leaves(run["results"])
        host[label] = dict(seconds=run["seconds"], scored_poses=len(run["pairs"]),
                           launches={n: fn.launches - before[n]
                                     for n, fn in counters.items()},
                           scores={k: v for k, v in leaves.items() if k.count("/") == 1})
        if not run["pairs"] or not all(np.isfinite(p).all() for p, _ in run["pairs"]):
            raise AssertionError(f"11h {label}: no finite scored poses")
        log(f"11h {label}: {json.dumps(host[label])}")
    out["host"] = host
    # 11x: card against CPU on the same files.
    out["card_vs_cpu"] = {
        "rbot": compare_eval("rbot", rbot_case(ds, names[:2], ["a_regular", "d_occlusion"],
                                               n_frames=EVAL_CPU_RBOT_FRAMES)),
        "ycb": compare_eval("ycb", ycb_case(ds)),
        "rtb": compare_eval("rtb", rtb_case(ds)),
        "opt": compare_eval("opt", serve_case(ds, "opt")),
        "choi": compare_eval("choi", serve_case(ds, "choi"))}
    if "cv2" in sys.modules:
        raise AssertionError("phase 11 imported cv2")
    out["phase11_s"] = time.perf_counter() - begin
    log(f"phase 11 took {out['phase11_s']:.1f} s")
    return out, ds


# ----------------------------------------------------------------------------------------
# Phase 12: the other entry points of examples/ (a recorded sequence, generated trackers,
# the parameter studies and the optimizer timing), on phase 11's datasets and models
# ----------------------------------------------------------------------------------------

REC_FRAMES = 12        # 12r: frames recorded, then replayed
REC_SIZE = (640, 480)  # 12r: the size of the video device's frames
GEN_ITERATIONS = 10    # 12g: --max-iterations of the generated trackers
STUDY_CPU_FRAMES = 5   # 12x: RBOT frames per sequence of the CPU comparison
# 12r, 12g: the launches of one region tracking step through the fused backend (9l's)
STEP_LAUNCHES = {"sample_lines": 6, "bin_counts": 2, "sample_windows": 0, "query_eval": 0,
                 "newton_step": 10}


def recorded_pose(i: int) -> np.ndarray:
    """12r's known path: phase 11's four-sphere cluster 0.55 m away, moving 2 mm along
    x and turning 0.02 rad per frame."""
    return eval_pose((-0.02 + 0.002 * i, 0.01, 0.55), (0.3, 0.4 + 0.02 * i, 0.1))


def video_intrinsics():
    """The OpenCV camera's intrinsics for a device that reports none
    (hardware_camera.OpenCVColorCamera.SetUp): a 60 degree field of view at REC_SIZE."""
    from m3t_tpu_torch.common import Intrinsics

    w, h = REC_SIZE
    f = w / (2.0 * np.tan(np.deg2rad(30.0)))
    return Intrinsics(f, f, w / 2 - 0.5, h / 2 - 0.5, w, h)


@contextlib.contextmanager
def video_capture_stand_in(frames):
    """In place of OpenCV for the block, a module named cv2 holding only a
    VideoCapture that yields ``frames`` (as tests/test_hardware_cameras.py fakes it; the
    card's machine has no OpenCV): the camera's set-up probe reads frames[0], and its
    k-th UpdateImage (from 0) frames[k]."""
    import types

    class VideoCapture:
        def __init__(self, index):
            self.index, self.n_reads = index, 0

        def isOpened(self):  # noqa: N802
            return True

        def read(self):
            frame = frames[min(max(self.n_reads - 1, 0), len(frames) - 1)]
            self.n_reads += 1
            return True, frame.copy()

    stand_in = types.ModuleType("cv2")
    stand_in.VideoCapture = VideoCapture
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = stand_in
    try:
        yield
    finally:
        if saved is None:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


@contextlib.contextmanager
def twin_checked(label):
    """Every kernel call made inside the block, held after the block against its plain
    twin on the same inputs (recorded_launches, twin_mismatches), so that the block's
    timings leave the check out; its peak memory holds the recorded inputs.  Fails on
    any mismatch; yields a dict that then holds the number of calls checked."""
    checked = {}
    with recorded_launches() as calls:
        yield checked
    checked["kernel_calls"] = len(calls)
    mismatches = twin_mismatches(calls)
    if mismatches:
        raise AssertionError(f"{label}: {len(mismatches)} of {len(calls)} kernel calls "
                             f"unequal to their plain twins: {sorted(set(mismatches))}")


@contextlib.contextmanager
def step_records():
    """Every Tracker.ExecuteStartingStep and ExecuteTrackingStep call inside the block:
    the kernel launches it made, by method."""
    from m3t_tpu_torch import tracker

    counters = launch_counters()
    records = {"ExecuteStartingStep": [], "ExecuteTrackingStep": []}
    real = {name: vars(tracker.Tracker)[name] for name in records}

    def wrap(name):
        def step(self, iteration):
            before = {n: fn.launches for n, fn in counters.items()}
            ok = real[name](self, iteration)
            records[name].append({n: fn.launches - before[n] for n, fn in counters.items()})
            return ok
        return step

    for name in records:
        setattr(tracker.Tracker, name, wrap(name))
    try:
        yield records
    finally:
        for name, fn in real.items():
            setattr(tracker.Tracker, name, fn)


def run_main(call, patches=()):
    """call() (an entry point's main, which returns its exit code) with ``patches`` in
    place, its printed text captured; every Tracker step recorded (step_records) and
    peak device memory read."""
    out = io.StringIO()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with patched(list(patches)), step_records() as steps, contextlib.redirect_stdout(out):
        begin = time.perf_counter()
        rc = call()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - begin
    return dict(rc=rc, text=out.getvalue(), steps=steps, seconds=seconds,
                peak_memory_bytes=torch.cuda.max_memory_allocated())


def record_sequence(root: Path, writer: FrameWriter):
    """12r: record_camera_sequence through a stand-in video device whose frames show
    phase 11's four-sphere cluster along recorded_pose; the PNG files must read back as
    the frames, and the loader metafile written beside them must give the device's
    intrinsics.  Returns the directory."""
    from m3t_tpu_torch.examples import record_camera_sequence
    from m3t_tpu_torch.utils import png, yaml_io

    intr = video_intrinsics()
    vertices, triangles = eval_meshes()["quad"]
    frames = [writer.render(intr, [(vertices, triangles, recorded_pose(i),
                                    EVAL_COLOURS[0])])[0] for i in range(REC_FRAMES)]
    directory = root / "recorded"
    with video_capture_stand_in(frames):
        run = run_main(lambda: record_camera_sequence.main(
            [str(directory), "--n-frames", str(REC_FRAMES)]))
    names = sorted(p.name for p in directory.iterdir())
    want = sorted(["color_camera.yaml"]
                  + [f"color_camera_image_{i}.png" for i in range(REC_FRAMES)])
    fs = yaml_io.open_yaml_file_storage(str(directory / "color_camera.yaml"))
    if (run["rc"] != 0 or run["text"] != f"Recorded {REC_FRAMES} frames to {directory}\n"
            or names != want or yaml_io.read_intrinsics(fs, "intrinsics") != intr
            or any(not np.array_equal(png.read_png(directory / f"color_camera_image_{i}.png"),
                                      frame) for i, frame in enumerate(frames))):
        raise AssertionError(f"12r: the recording exited {run['rc']}, printed "
                             f"{run['text']!r} and wrote {names}")
    log(f"12r: record_camera_sequence wrote {REC_FRAMES} PNG frames at {REC_SIZE} and its "
        f"metafile in {run['seconds']:.2f} s (the script paces 30 frames per second)")
    return directory


def replay_files(root: Path, ds) -> dict:
    """The replay's body (the recorded cluster's mesh), its detector metafile (the first
    frame's pose 4 mm off in x) and an external directory holding phase 11's region
    model of that mesh under the name the entry point looks for."""
    from m3t_tpu_torch.utils.obj_loader import save_obj

    obj = root / "recorded_cluster.obj"
    save_obj(str(obj), *eval_meshes()["quad"])
    start = recorded_pose(0)
    start[0, 3] += 0.004
    data = ", ".join(f"{v:.9g}" for v in start.reshape(-1))
    detector = root / "recorded_detector.yaml"
    detector.write_text("%YAML:1.2\nlink2world_pose: !!opencv-matrix\n  rows: 4\n  cols: 4\n"
                        f"  dt: f\n  data: [{data}]\n")
    ext = root / "recorded_ext"
    ext.mkdir(exist_ok=True)
    shutil.copyfile(ds["models"] / "quad_region.npz", ext / "body_region_model.npz")
    return dict(obj=obj, detector=detector, ext=ext)


def replay(directory: Path, files: dict, host_path: bool, device="cuda") -> dict:
    """12r: run_on_recorded_sequence over the recording through its metafile (phase 11's
    cut model: 1 subdivision, 200 points, 400 px), on the fused path or --host-path:
    run_main's record, with the tracked body's final pose and its translation error."""
    from m3t_tpu_torch.examples import run_on_recorded_sequence as entry

    built = []
    real_build = entry.build_tracker

    def build(args):
        built.append(real_build(args))
        return built[-1]

    argv = [str(directory), str(files["obj"]), str(files["detector"]), str(files["ext"]),
            "--camera-metafile", str(directory / "color_camera.yaml"),
            "--n-frames", str(REC_FRAMES), "--n-divides", "1", "--model-image-size", "400",
            "--device", device] + (["--host-path"] if host_path else [])
    run = run_main(lambda: entry.main(argv), [(entry, "build_tracker", build)])
    pose = np.array(built[0][1].body2world_pose, np.float64)
    run.update(pose=pose, translation_error_m=float(np.linalg.norm(
        pose[:3, 3] - recorded_pose(REC_FRAMES - 1)[:3, 3])))
    return run


def step_summary(steps: dict) -> dict:
    """The tracking steps and the launches per step of every kernel (the distinct
    values over the steps)."""
    tracking = steps["ExecuteTrackingStep"]
    names = kernel_modules()
    return dict(steps=len(tracking),
                launches={n: sum(s[n] for s in tracking) for n in names},
                launches_per_step={n: sorted({s[n] for s in tracking}) for n in names},
                starting_step_launches={n: sum(s[n] for s in steps["ExecuteStartingStep"])
                                        for n in names})


def run_recorded(root: Path, ds, writer: FrameWriter) -> dict:
    """12r: the recording, then its replay fused and on the host path (launches per
    tracking step as phase 9l's, none in the starting step; none on the host path; every
    kernel call equal to its twin, which runs the cycles eagerly), and fused once more
    graphed (held by its launches), each tracked body within 5 mm of the last frame's
    pose."""
    directory = record_sequence(root, writer)
    files = replay_files(root, ds)
    out = {}
    for label, host_path, want in (("fused", False, STEP_LAUNCHES),
                                   ("host_path", True, dict.fromkeys(STEP_LAUNCHES, 0)),
                                   ("fused graphed", False, STEP_LAUNCHES)):
        with (contextlib.nullcontext({"kernel_calls": 0}) if label == "fused graphed"
              else twin_checked(f"12r {label}")) as checked:
            run = replay(directory, files, host_path)
        summary = step_summary(run["steps"])
        record = dict(summary, rc=run["rc"], seconds=run["seconds"],
                      translation_error_m=run["translation_error_m"],
                      peak_memory_bytes=run["peak_memory_bytes"],
                      twin_checked_calls=checked["kernel_calls"])
        wrong = [n for n, v in want.items() if summary["launches_per_step"][n] != [v]]
        if (run["rc"] != 0 or "Start generating" in run["text"]
                or SERVE_NOTICE in run["text"] or summary["steps"] != REC_FRAMES
                or wrong or any(summary["starting_step_launches"].values())
                or not record["translation_error_m"] < 0.005):
            raise AssertionError(f"12r {label}: {json.dumps(record)}; printed "
                                 f"{run['text'][-2000:]!r}")
        out[label] = record
        log(f"12r {label}: {json.dumps(record)}")
    out["directory"], out["files"] = directory, files
    return out


def generated_config(directory: Path, recorded: Path, files: dict, ds) -> Path:
    """12g: a generator config with one link, as tests/test_torch_generator.py's
    one_link.yaml is written, over 12r's recording: the recorded cluster as body "pen"
    with a region model and modality, a loader camera through the recording's metafile,
    the replay's static detector, and a tracker that serves through the fused cycle."""
    directory.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(files["obj"], directory / "pen.obj")
    shutil.copyfile(ds["models"] / "quad_region.npz", directory / "pen_region_model_rmodel.npz")
    model = "".join(f"{k}: {v}\n" for k, v in EVAL_MODEL.items())
    texts = {
        "pen.yaml": '%YAML:1.2\ngeometry_path: "INFER_FROM_NAME"\ngeometry_unit_in_meter: 1.0\n'
                    "geometry_counterclockwise: 1\ngeometry_enable_culling: 1\n",
        "region_model.yaml": f'%YAML:1.2\nmodel_path: "INFER_FROM_NAME"\n{model}',
        "tracker.yaml": "%YAML:1.2\nn_corr_iterations: 5\nn_update_iterations: 2\n"
                        "use_fused_cycle: 1\n",
        "config.yaml": f"""%YAML:1.2
Body:
  - name: "pen"
    metafile_path: "pen.yaml"
LoaderColorCamera:
  - name: "color_camera"
    metafile_path: "{recorded / 'color_camera.yaml'}"
RegionModel:
  - name: "pen_region_model"
    metafile_path: "region_model.yaml"
    body: "pen"
RegionModality:
  - name: "pen_region"
    body: "pen"
    color_camera: "color_camera"
    region_model: "pen_region_model"
Link:
  - name: "pen_link"
    body: "pen"
    modalities: ["pen_region"]
Optimizer:
  - name: "optimizer"
    root_link: "pen_link"
StaticDetector:
  - name: "detector"
    metafile_path: "{files['detector']}"
    optimizer: "optimizer"
Tracker:
  - name: "tracker"
    metafile_path: "tracker.yaml"
    optimizers: ["optimizer"]
    detectors: ["detector"]
"""}
    for name, text in texts.items():
        (directory / name).write_text(text)
    return directory / "config.yaml"


def drive_publisher(config: Path, points: list) -> int:
    """run_pen_paper_demo's main() with its DrawingPublisher added as the reference adds
    a publisher, before the tracker's last SetUp; the trajectory goes to points."""
    from m3t_tpu_torch.examples import run_pen_paper_demo
    from m3t_tpu_torch.generator import GenerateConfiguredTracker

    tracker = GenerateConfiguredTracker(str(config), device="cuda")
    if not tracker.SetUp():
        return 1
    publisher = run_pen_paper_demo.DrawingPublisher(
        "drawing_publisher", tracker.body_ptrs[0], tracker.camera_ptrs[0], [0.0, 0.0, 0.1])
    tracker.AddPublisher(publisher)
    ok = tracker.SetUp() and tracker.RunTrackerProcess(
        execute_detection=True, start_tracking=True, max_iterations=GEN_ITERATIONS)
    points.extend(publisher.trajectory)
    return 0 if ok else 1


def run_generated(root: Path, recorded: dict, ds) -> dict:
    """12g: run_generated_tracker and run_pen_paper_demo over generated_config with
    --max-iterations GEN_ITERATIONS, launches per tracking step as 12r's, every kernel
    call equal to its twin.  The demo's
    main() adds its publisher after Tracker.SetUp, which unsets the tracker, so it
    exits 1 with no trajectory (a fault of the JAX script that the port keeps, ROADMAP
    Queue C); its DrawingPublisher is then driven with the tracker set up again after it
    is added: one tip point per iteration."""
    from m3t_tpu_torch.examples import run_generated_tracker, run_pen_paper_demo

    config = generated_config(root / "generated", recorded["directory"], recorded["files"],
                              ds)
    argv = [str(config), "--max-iterations", str(GEN_ITERATIONS), "--device", "cuda"]
    points = []
    with twin_checked("12g") as checked:
        generated = run_main(lambda: run_generated_tracker.main(argv))
        demo = run_main(lambda: run_pen_paper_demo.main(argv))
        wired = run_main(lambda: drive_publisher(config, points))
    out = {"twin_checked_calls": checked["kernel_calls"],"run_generated_tracker": dict(step_summary(generated["steps"]),
                                         rc=generated["rc"], seconds=generated["seconds"]),
           "run_pen_paper_demo": dict(rc=demo["rc"], printed=demo["text"].splitlines()[-1:],
                                      steps=len(demo["steps"]["ExecuteTrackingStep"])),
           "drawing_publisher": dict(step_summary(wired["steps"]), rc=wired["rc"],
                                     seconds=wired["seconds"], trajectory_points=len(points),
                                     trajectory_ends=[points[0], points[-1]] if points else [])}
    wrong = [(label, n) for label in ("run_generated_tracker", "drawing_publisher")
             for n, v in STEP_LAUNCHES.items() if out[label]["launches_per_step"][n] != [v]]
    if (generated["rc"] != 0 or out["run_generated_tracker"]["steps"] != GEN_ITERATIONS
            or demo["rc"] != 1 or demo["text"].splitlines()[-1:] != ["trajectory points: 0"]
            or wired["rc"] != 0 or len(points) != GEN_ITERATIONS or wrong):
        raise AssertionError(f"12g: {json.dumps(out)}; launches off at {wrong}")
    log(f"12g: {json.dumps(out)}")
    return out


def bound_evaluator(cls, **attributes):
    """cls with ``attributes`` set after its constructor: how a study, which builds its
    own evaluator, is pointed at phase 11's prepared models (and RBOT's frame count)."""
    class Bound(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            for key, value in attributes.items():
                setattr(self, key, value)

    Bound.__name__ = Bound.__qualname__ = cls.__name__
    return Bound


def model_settings(params: dict):
    def setter(model):
        for key, value in params.items():
            setattr(model, key, value)
    return setter


STUDY_ROW = re.compile(r"^(?:\[\d+/\d+\] .*: ((?:\w+ = -?\d+\.\d+(?:, )?)+) \(\d+\.\d s\)"
                       r"|\{.*\} -> (-?\d+\.\d+))$")


def printed_rows(text: str) -> list:
    """The scores of each row a study printed: run_study's "[i/n] <run>: name = value,
    ..." and parameter_study.py's "<run> -> value"."""
    rows = []
    for line in text.splitlines():
        match = STUDY_ROW.match(line)
        if match and match.group(1):
            rows.append({k: float(v) for k, v in
                         (part.split(" = ") for part in match.group(1).split(", "))})
        elif match:
            rows.append({"score": float(match.group(2))})
    return rows


def opt_published_layout(ds, writer: FrameWriter) -> None:
    """12p: phase 11's OPT sequence laid out as the published run "qu_tr_1_b" that the OPT
    study composes (<body[:2]>_<pattern>_<orientation>): its colour frames linked, the
    depth frames rendered again from the published depth camera's pose
    (DEPTH2COLOR_POSE), and its ground truth column-major in 3D/poses/."""
    from m3t_tpu_torch.common import np_pose_inverse
    from m3t_tpu_torch.eval.opt_evaluator import DEPTH2COLOR_POSE, OPT_INTRINSICS, read_matrix_poses

    seq = ds["opt"] / "3D" / "seq1"
    run = ds["opt"] / "3D" / "qu_tr_1_b"
    poses = read_matrix_poses(str(seq / "quad.txt"))
    mesh = eval_meshes()["quad"]
    color2depth = np_pose_inverse(DEPTH2COLOR_POSE)
    for i in range(EVAL_FRAMES):
        (run / "color").mkdir(parents=True, exist_ok=True)
        os.link(seq / "color" / f"{i + 1:04d}.png", run / "color" / f"{i + 1:04d}.png")
        _, depth = writer.render(OPT_INTRINSICS, [(*mesh, color2depth @ poses[i],
                                                   EVAL_COLOURS[2])], depth_scale=0.001)
        writer.write(run / "depth" / f"{i + 1:04d}.png", depth)
    (ds["opt"] / "3D" / "poses").mkdir(exist_ok=True)
    (ds["opt"] / "3D" / "poses" / "qu_tr_1_b.txt").write_text("\n".join(
        " ".join(f"{v:.9f}" for v in p[:3, :].T.reshape(-1)) for p in poses) + "\n")


def study_cases(ds, names) -> dict:
    """12p's six studies: label -> (entry point, arguments without --device, swept
    grid entry and its two values (parameter_study.py: its --param), the evaluator's
    module and class, the attributes set on it, the module attributes set (the YCB
    study's BODY_NAMES), the fused call counted per cycle (owner, name), and whether
    every cycle must launch each of K1, K2 (and K3, and K5 on a rigid cycle))."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.eval import (choi_evaluator, metrics, opt_evaluator, rbot_evaluator,
                                    rtb_evaluator, ycb_evaluator)
    from m3t_tpu_torch.examples import (parameter_study, parameter_study_choi_dataset,
                                        parameter_study_opt_dataset,
                                        parameter_study_rbot_dataset,
                                        parameter_study_rtb_dataset,
                                        parameter_study_ycb_dataset)

    rbot_model = model_settings(EVAL_RBOT_MODEL)
    model = model_settings(EVAL_MODEL)
    rbot = [str(ds["rbot"]), str(ds["rbot_ext"]), "--bodies", *names,
            "--sequences", *EVAL_RBOT_SEQUENCES]
    region = ("sample_lines", "bin_counts")
    rigid = region + ("newton_step",)
    return {
        "parameter_study rbot": (
            parameter_study, ["rbot", *rbot], ("n_lines_max", [100, 200]),
            rbot_evaluator, "RBOTEvaluator",
            dict(region_model_setter=rbot_model, n_frames=EVAL_RBOT_FRAMES), {},
            (pipeline, "tracking_cycle"), rigid),
        "rbot": (
            parameter_study_rbot_dataset, [*rbot, "--fused", "--n-frames",
                                           str(EVAL_RBOT_FRAMES)],
            ("region_modality.n_lines_max", [100, 200]), rbot_evaluator, "RBOTEvaluator",
            dict(region_model_setter=rbot_model), {}, (pipeline, "tracking_cycle"), rigid),
        "ycb": (
            parameter_study_ycb_dataset, [str(ds["ycb"]), str(ds["ycb_ext"]), "--sequences",
                                          *map(str, EVAL_YCB_SEQUENCES)],
            ("tracker.n_corr_iterations", [4, 2]), ycb_evaluator, "YCBEvaluator",
            dict(region_model_setter=model, depth_model_setter=model),
            {"BODY_NAMES": list(EVAL_YCB_BODIES)}, (pipeline, "tracking_cycle_rgbd"),
            rigid + ("sample_windows",)),
        "rtb": (
            parameter_study_rtb_dataset, [str(ds["rtb"]), str(ds["rtb"]), "--objects",
                                          "two_link", "--difficulties", "easy", "--depths",
                                          "depth_ground_truth", "--sequences", "0", "1"],
            ("region_modality.scales", [[9, 7, 5, 2], [7, 4, 2]]), rtb_evaluator,
            "RTBEvaluator", {}, {}, (pipeline, "tracking_cycle_kinematic"),
            region + ("sample_windows",)),
        "opt": (
            parameter_study_opt_dataset, [str(ds["opt"]), str(ds["opt_ext"]), "--bodies",
                                          "quad", "--orientations", "b", "--patterns", "tr_1"],
            ("region_modality.learning_rate_f", [0.2, 0.5]), opt_evaluator, "OPTEvaluator",
            dict(region_model_setter=model, depth_model_setter=model), {},
            (metrics, "execute_tracking_step_maybe_fused"), ()),
        "choi": (
            parameter_study_choi_dataset, [str(ds["choi"]), str(ds["choi_ext"]), "--bodies",
                                           "kinect_box"],
            ("tracker.n_corr_iterations", [4, 2]), choi_evaluator, "ChoiEvaluator",
            dict(region_model_setter=model, depth_model_setter=model), {},
            (metrics, "execute_tracking_step_maybe_fused"), rigid + ("sample_windows",)),
    }


def run_study(case, values, device="cuda", argv_extra=(), bound_extra=None) -> dict:
    """One study's main() on device over ``values`` of its swept grid entry: its printed
    rows, the poses its evaluator scored (ScoredPoses), and per row (each Evaluate) its
    seconds and the launches of every fused cycle or tracking step."""
    (module, argv, (swept, _), evaluator_module, cls_name, attributes, module_patches,
     (owner, name), _) = case
    rows, counters = [], launch_counters()
    spy = ScoredPoses(evaluator_module.metrics)
    patches = [(evaluator_module, "metrics", spy)]
    patches += [(module, key, value) for key, value in module_patches.items()]
    if module.__name__.endswith(".parameter_study"):
        sweep = ["--param", swept, json.dumps(values)]
    else:
        grid = json.loads(json.dumps(module.GRIDS))
        component, param = swept.split(".")
        grid[component][param] = values
        patches.append((module, "GRIDS", grid))
        sweep = []
    with launches_per_call(owner, name) as per_call:
        class Study(bound_evaluator(getattr(evaluator_module, cls_name),
                                    **dict(attributes, **(bound_extra or {})))):
            def Evaluate(self):  # noqa: N802
                first = len(per_call)
                before = {n: fn.launches for n, fn in counters.items()}
                torch.cuda.synchronize()
                begin = time.perf_counter()
                results = super().Evaluate()
                torch.cuda.synchronize()
                rows.append(dict(
                    seconds=time.perf_counter() - begin, cycles=len(per_call) - first,
                    launches={n: fn.launches - before[n] for n, fn in counters.items()},
                    launches_per_cycle={n: sorted({c[n] for c in per_call[first:]})
                                        for n in counters}))
                return results

        # The study looks its evaluator up in the evaluator's module, or (RTB) in its own.
        owners = [m for m in (evaluator_module, module) if hasattr(m, cls_name)]
        run = run_main(lambda: module.main([*argv, *argv_extra, *sweep, "--device", device]),
                       patches + [(m, cls_name, Study) for m in owners])
    printed = printed_rows(run["text"])
    if run["rc"] != 0 or len(printed) != len(values) or len(rows) != len(values):
        raise AssertionError(f"study {module.__name__} on {device}: exit {run['rc']}, rows "
                             f"{printed}: {run['text'][-3000:]!r}")
    for row, scores in zip(rows, printed):
        row["scores"] = scores
    return dict(rows=rows, pairs=spy.pairs, seconds=run["seconds"], text=run["text"],
                results={f"row{i}": scores for i, scores in enumerate(printed)})


def run_studies(ds, names) -> dict:
    """12p: each study over its two-value grid on the card: per row its printed scores,
    seconds, cycles (fused cycles or tracking steps) and the launches of each kernel per
    cycle; on the fused paths every cycle launches K1 and K2 (and K3 with depth, K5 on
    the rigid cycles), and
    every kernel call equals its twin.  Two
    faults of the JAX studies show on the card as they do in the CPU tests (ROADMAP
    Queue C): parameter_study.py's RBOT rows and the YCB study's n_corr_iterations rows
    print the same scores, since those fused evaluators never call the setters that
    would apply the swept values.  The OPT study's published layout puts its depth
    camera at the published depth-to-colour pose, so its tracker serves on the host
    path and launches no kernel."""
    out = {}
    for label, case in study_cases(ds, names).items():
        swept, values = case[2]
        want_every_cycle = case[-1]
        with twin_checked(f"12p {label}") as checked:
            result = run_study(case, values)
        rows = result["rows"]
        missing = [(i, n) for i, row in enumerate(rows) for n in want_every_cycle
                   if not row["cycles"] or 0 in row["launches_per_cycle"][n]]
        launched = {n: sum(row["launches"][n] for row in rows) for n in kernel_modules()}
        record = dict(swept=swept, values=values, rows=rows, launches=launched,
                      twin_checked_calls=checked["kernel_calls"],
                      scored_poses=len(result["pairs"]), seconds=result["seconds"])
        host_path = label == "opt"
        faulty = label in ("parameter_study rbot", "ycb")
        if (missing or (SERVE_NOTICE in result["text"]) != host_path
                or (host_path and any(launched.values()))
                or (faulty and rows[0]["scores"] != rows[1]["scores"])
                or not result["pairs"]
                or not all(np.isfinite(p).all() for p, _ in result["pairs"])):
            raise AssertionError(f"12p {label}: {json.dumps(record)}; cycles without a kernel "
                                 f"that each must launch: {missing}")
        out[label] = record
        log(f"12p {label}: {json.dumps(record)}")
    return out


def compare_studies(ds, names) -> dict:
    """12x: each study's first row on the card against the same study with --device cpu
    (compare_runs): the RBOT studies over two bodies in a_regular and d_occlusion for
    STUDY_CPU_FRAMES frames, the others over 12p's files."""
    out = {}
    for label, case in study_cases(ds, names).items():
        argv_extra, bound_extra = (), None
        if label in ("rbot", "parameter_study rbot"):
            argv_extra = ("--bodies", *names[:2], "--sequences", "a_regular", "d_occlusion")
            if label == "rbot":
                argv_extra += ("--n-frames", str(STUDY_CPU_FRAMES))
            else:
                bound_extra = {"n_frames": STUDY_CPU_FRAMES}
        first = case[2][1][:1]
        out[label] = compare_runs(f"12x {label}", lambda device, case=case, first=first,
                                  extra=argv_extra, bind=bound_extra:
                                  run_study(case, first, device, extra, bind))
    return out


def run_optimization_time() -> dict:
    """12o: optimization_time.main over chains of 1, 2, 5, 10 and 20 links, 50 solves
    each: host time (the Optimizer's numpy Newton step), not the card's."""
    from m3t_tpu_torch.examples import optimization_time

    run = run_main(lambda: optimization_time.main(
        ["--max-chain", "20", "--n-runs", "50", "--device", "cuda"]))
    table = [dict(chain=int(chain), dof=int(dof), host_ms_per_solve=float(ms))
             for chain, dof, ms in (line.split() for line in run["text"].splitlines()[1:])]
    if run["rc"] != 0 or [r["dof"] for r in table] != [6, 7, 10, 15, 25]:
        raise AssertionError(f"12o: exit {run['rc']}: {run['text']!r}")
    log(f"12o (host time): {json.dumps(table)}")
    return dict(table=table, seconds=run["seconds"])


def run_phase12(root: Path, ds) -> dict:
    """Phase 12: the other entry points of examples/ on the card (see the module's
    docstring), on phase 11's datasets and models under root.  Returns the "phase12"
    record of the JSON line."""
    from m3t_tpu_torch.examples.evaluate_rbot_dataset import ALL_BODIES

    begin = time.perf_counter()
    names = ALL_BODIES[:18]
    writer = FrameWriter(seed=43)
    recorded = run_recorded(root, ds, writer)
    out = {"recorded": {k: recorded[k] for k in ("fused", "host_path", "fused graphed")},
           "generated": run_generated(root, recorded, ds)}
    opt_published_layout(ds, writer)
    out["studies"] = run_studies(ds, names)

    def replayed(device):
        run = replay(recorded["directory"], recorded["files"], False, device)
        return dict(results={}, seconds=run["seconds"],
                    pairs=[(run["pose"], recorded_pose(REC_FRAMES - 1))])

    out["card_vs_cpu"] = {"recorded": compare_runs("12x recorded", replayed),
                          **compare_studies(ds, names)}
    out["optimization_time"] = run_optimization_time()
    if "cv2" in sys.modules:
        raise AssertionError("phase 12 imported cv2")
    out["phase12_s"] = time.perf_counter() - begin
    log(f"phase 12 took {out['phase12_s']:.1f} s")
    return out


# Phase 13: the benchmark runner, python -m m3t_tpu_torch.bench, bench.py's counterpart.
BENCH_FLAGS = {"region": (), "rgbd": ("--rgbd",), "occlusion": ("--occlusion",),
               "kinematic": ("--kinematic",), "kinematic_rgbd": ("--kinematic-rgbd",),
               "ycb": ("--ycb",), "latency": ("--latency",)}
# The keys of bench.py's printed JSON objects (bench.py:187-198, 407-415), and the
# runner's "device".
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "spread", "windows", "unstable",
              "device"}
BENCH_LATENCY_KEYS = {"metric", "value", "unit", "vs_baseline", "latency_ms_per_cycle",
                      "spread_ms_per_cycle", "unstable", "device"}
BENCH_TIMEOUT_S = 240.0
BENCH_CYCLES = 3  # 13k: cycles after StartModality
# 13k: kernel launches per cycle of each bench mode (the kinematic modes start from
# uniform histograms: no StartModality launch; their KKT step launches no newton_step).
BENCH_LAUNCHES = {
    "region": {"sample_lines": 6, "bin_counts": 2, "newton_step": 10},
    "rgbd": {"sample_lines": 6, "bin_counts": 2, "sample_windows": 5, "newton_step": 10},
    "ycb": {"sample_lines": 5, "bin_counts": 2, "sample_windows": 12, "newton_step": 8},
    "occlusion": {"sample_lines": 6, "bin_counts": 2, "query_eval": 5, "newton_step": 10,
                  "scene_coeffs": 5},
    "kinematic": {"sample_lines": 6, "bin_counts": 2, "query_eval": 5, "scene_coeffs": 5},
    "kinematic_rgbd": {"sample_lines": 6, "bin_counts": 2, "sample_windows": 5,
                       "query_eval": 5, "scene_coeffs": 5},
    "latency": {"sample_lines": 6, "bin_counts": 2, "newton_step": 10}}
# Phase 8c's cycle: one focused scene per correspondence iteration over the B x C batch,
# queried three times (region checks and modeled occlusions, depth modeled occlusions,
# silhouette check), and one Newton step of every body after each camera sum.
MULTICAMERA_LAUNCHES = {"sample_lines": 6, "bin_counts": 2, "sample_windows": 5,
                        "query_eval": 15, "newton_step": 10, "scene_coeffs": 5}


def run_bench_cli(mode: str, card: str) -> dict:
    """13b: python -m m3t_tpu_torch.bench in mode with --iters 10 --windows 2 as a
    subprocess: exit 0 and a last stdout line with bench.py's keys and a finite, positive
    value."""
    argv = [sys.executable, "-m", "m3t_tpu_torch.bench", *BENCH_FLAGS[mode], "--iters",
            "10", "--windows", "2"]
    begin = time.perf_counter()
    proc = subprocess.run(argv, cwd=Path(__file__).resolve().parent, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    seconds = time.perf_counter() - begin
    if proc.returncode != 0:
        raise AssertionError(f"13b {mode}: exit {proc.returncode}: {proc.stderr[-3000:]}")
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    want = BENCH_LATENCY_KEYS if mode == "latency" else BENCH_KEYS
    if set(result) != want or not (np.isfinite(result["value"]) and result["value"] > 0):
        raise AssertionError(f"13b {mode}: printed {result}")
    log(f"13b {mode} ({card}): {json.dumps(result)} in {seconds:.1f} s")
    return dict(result=result, seconds=seconds)


def run_bench_workload(mode: str) -> dict:
    """13k: bench mode's workload through build_workload at B=512 (latency at 1, 8 and
    64), its kernel launches counted from 0 over StartModality and BENCH_CYCLES cycles
    and held per cycle against BENCH_LAUNCHES, every kernel call against its twin
    (twin_checked); the largest translation error is logged, not asserted (bench.py's
    structure never moves and its YCB texture terms match random pixels)."""
    from m3t_tpu_torch import bench, pipeline

    counters = launch_counters()
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    with twin_checked(f"13k {mode}") as checked:
        works = bench.build_workload(mode, N_BODIES, "cuda")
        states = []
        for work in works:
            state = work.state
            for _ in range(BENCH_CYCLES):
                state = work.cycle(state)
            work.sync(state)
            states.append(state)
    launches = {name: fn.launches for name, fn in counters.items()}
    kinematic = mode.startswith("kinematic")
    want = {name: len(works) * (BENCH_CYCLES * BENCH_LAUNCHES[mode].get(name, 0)
                                + (0 if kinematic else
                                   {"sample_lines": 1, "bin_counts": 2}.get(name, 0)))
            for name in counters}
    if launches != want:
        raise AssertionError(f"13k {mode}: kernel launches {launches}, expected {want}")
    target = np.array([0.0, 0.0, 0.6])
    errors = []
    for work, state in zip(works, states):
        if kinematic:
            poses = pipeline.kinematic_body_poses(work.inputs["kin"], state)[:, 0]
        else:
            poses = state.body2camera_pose
        errors.append(float(np.linalg.norm(poses[:, :3, 3].cpu().numpy() - target,
                                           axis=1).max()))
    out = dict(bodies=[work.body_frames for work in works], cycles=BENCH_CYCLES,
               launches=launches, kernel_calls=checked["kernel_calls"],
               max_translation_error_m=max(errors))
    log(f"13k {mode}: {json.dumps(out)}")
    return out


def run_phase13(card: str) -> dict:
    """Phase 13: the benchmark runner in all seven modes, as a user runs it (13b) and
    through build_workload with its launches and twins held (13k)."""
    begin = time.perf_counter()
    out = {"cli": {mode: run_bench_cli(mode, card) for mode in BENCH_FLAGS},
           "workloads": {mode: run_bench_workload(mode) for mode in BENCH_FLAGS}}
    out["phase13_s"] = time.perf_counter() - begin
    log(f"phase 13 took {out['phase13_s']:.1f} s")
    return out


# Phase 14: the fused cycles graphed (m3t_tpu_torch.graphs, the port's jax.jit) against
# their eager twins.
GRAPH_CYCLES = 3  # 14: eager cycles, and as many graphed ones from their states


def unequal_fields(got, want) -> dict:
    """The fields of two states (or tuples of tensors) that are not equal bit for bit,
    with their largest difference."""
    names = getattr(want, "_fields", range(len(want)))
    return {str(n): float((g.double() - w.double()).abs().max())
            for n, g, w in zip(names, got, want) if not torch.equal(g, w)}


def eager_and_graphed(label, card, step, state, want_per_step: dict,
                      fields=tuple) -> dict:
    """14: GRAPH_CYCLES eager steps from state, then a graphed step from the state each
    eager step started from (the first captures the graph, the others replay it), every
    graphed state equal to the eager one bit for bit (fields(state): its tensors); the
    kernel launches of both forms per step (want_per_step), the graphs captured and
    each form's peak memory."""
    from m3t_tpu_torch import graphs

    counters = launch_counters()

    def measured(run):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {n: c.launches for n, c in counters.items()}
        out = run()
        torch.cuda.synchronize()
        return (out, {n: c.launches - before[n] for n, c in counters.items()},
                torch.cuda.max_memory_allocated())

    def eager_chain():
        states = [state]
        with graphs.disable_graphs():
            for _ in range(GRAPH_CYCLES):
                states.append(step(states[-1]))
        return states

    graphs.clear_graphs()
    gc.collect()  # the last path's tensors go before this one's peak memory is read
    eager, eager_launches, eager_peak = measured(eager_chain)
    graphed, graph_launches, graph_peak = measured(lambda: [step(s) for s in eager[:-1]])
    unequal = {}
    for i, (g, e) in enumerate(zip(graphed, eager[1:])):
        if unequal_fields(fields(g), fields(e)):
            unequal[i + 1] = unequal_fields(fields(g), fields(e))
    infos = graphs.captured()
    want = {n: GRAPH_CYCLES * want_per_step.get(n, 0) for n in counters}
    per_replay = {n: sum(i.launches.get(n, 0) for i in infos) for n in counters}
    segments = [i.segments for i in infos]
    if unequal or eager_launches != want or graph_launches != want \
            or per_replay != {n: want_per_step.get(n, 0) for n in counters} \
            or any(n != 1 for n in segments):
        raise AssertionError(f"14 {label} ({card}): graphed steps unequal to eager "
                             f"{unequal}; launches eager {eager_launches}, graphed "
                             f"{graph_launches}, per replay {per_replay}, expected {want}; "
                             f"segments per graph {segments} (one process: 1)")
    out = dict(path=label, card=card, equal_steps=GRAPH_CYCLES, launches_per_step=per_replay,
               graphs=len(infos), segments_per_graph=segments,
               peak_memory_bytes={"eager": eager_peak, "graph": graph_peak})
    log(f"14 {label} ({card}): {json.dumps(out)}")
    graphs.clear_graphs()
    return out


def serve_graphed(label, card, inp, seq, models, rgbd: bool):
    """14: phase 9l's serve graph (one body), twice: one copy steps eagerly and the
    other graphed, in lockstep, each step from the same graph state (fused_serve.
    read_graph_state and load_graph_state: the link's pose and the histograms; the
    cameras, which read their next frame at every step, advance alike in the two
    copies), held as eager_and_graphed holds a cycle."""
    from m3t_tpu_torch import fused_serve, graphs

    n_frames = len(seq["scan_colour"])
    copies, frame = {}, {}
    for form in ("eager", "graph"):
        copies[form] = serve_graph(inp, seq, models, 1, rgbd, "cuda")
        frame[form] = n_frames
        with graphs.disable_graphs(), contextlib.redirect_stdout(io.StringIO()):
            if not (copies[form].SetUp() and copies[form].RunTrackerProcess(
                    execute_detection=True, start_tracking=True, max_iterations=n_frames)):
                raise AssertionError(f"14 {label}: the serve graph failed to start")

    def step(graph_state):
        form = "graph" if graphs.graphs_enabled() else "eager"
        fused_serve.load_graph_state(copies[form], graph_state)
        serve_steps(copies[form], frame[form], 1)
        frame[form] += 1
        return fused_serve.read_graph_state(copies[form])

    def fields(graph_state):
        (link,), ((hist_f, hist_b),) = (graph_state["links"].values(),
                                        graph_state["histograms"].values())
        return tuple(torch.as_tensor(np.asarray(a)) for a in (link[2], hist_f, hist_b))

    want = dict(STEP_LAUNCHES, sample_windows=5 if rgbd else 0)
    return eager_and_graphed(label, card, step,
                             fused_serve.read_graph_state(copies["eager"]), want,
                             fields=fields)


def unequal_graph_states(got: dict, want: dict) -> dict:
    """The link poses, joint poses and histograms of two fused_serve.read_graph_state
    results that are not equal bit for bit, with their largest difference."""
    out = {}
    for part in ("links", "histograms"):
        for name, values in want[part].items():
            for i, (g, w) in enumerate(zip(got[part][name], values)):
                if w is not None and not np.array_equal(g, w):
                    out[f"{name}[{i}]"] = float(np.abs(np.asarray(g, np.float64) - w).max())
    return out


def host_path_graphed(label, card, graph, inp, models, n_steps: int = 2) -> dict:
    """14h: a phase-10 graph (occluded_scene_graph or structure_graph) twice on the card,
    one copy stepped eagerly (disable_graphs) and one with its host-path functions
    graphed, n_steps steps (detection, the starting step and a tracking step), the
    graphed copy loaded with the eager copy's state before each step (fused_serve.
    read_graph_state and load_graph_state): every link pose, joint pose and histogram
    equal bit for bit after every step, no kernel launched; the graphs captured (the
    graphed copy's first step captures)."""
    from m3t_tpu_torch import fused_serve, graphs

    graphs.clear_graphs()
    copies = {}
    for form in ("eager", "graph"):
        copies[form] = graph(inp, models, "cuda")[0]
        with contextlib.redirect_stdout(io.StringIO()):
            if not copies[form].SetUp():
                raise AssertionError(f"14h {label}: Tracker.SetUp failed")
            copies[form].ExecuteDetection(start_tracking=True)
    counters = launch_counters()
    for counter in counters.values():
        counter.launches = 0
    unequal = {}
    for i in range(n_steps):
        fused_serve.load_graph_state(copies["graph"],
                                     fused_serve.read_graph_state(copies["eager"]))
        states = {}
        for form, srv in copies.items():
            with (graphs.disable_graphs() if form == "eager" else contextlib.nullcontext()), \
                    contextlib.redirect_stdout(io.StringIO()):
                ok = (srv.UpdateCameras(i) and srv.CalculateConsistentPoses()
                      and srv.ExecuteDetectingStep(i) and srv.ExecuteStartingStep(i)
                      and srv.ExecuteTrackingStep(i))
            if not ok:
                raise AssertionError(f"14h {label}: step {i} failed ({form})")
            states[form] = fused_serve.read_graph_state(srv)
        diff = unequal_graph_states(states["graph"], states["eager"])
        if diff:
            unequal[i] = diff
    launches = {name: counter.launches for name, counter in counters.items()}
    captured = graphs.captured()
    out = dict(path=label, card=card, steps=n_steps, equal_steps=n_steps - len(unequal),
               unequal=unequal, kernel_launches=launches, graphs=len(captured),
               replays=sum(i.replays for i in captured))
    log(f"14h {label} ({card}): {json.dumps(out)}")
    graphs.clear_graphs()
    if unequal or any(launches.values()):
        raise AssertionError(f"14h {label} ({card}): the graphed host path is not the "
                             f"eager one: unequal {unequal}, launches {launches}")
    return out


def run_phase14(card: str, inp, seq, models, mc, kmc) -> dict:
    """Phase 14: every bench mode's workload at B=512 (S=256), the RGB-D scan step of
    phase 8s, the multi-camera cycles of phases 8c and 8k, --latency at B=1, 8 and 64
    and the serve graphs of phase 9l, each through eager_and_graphed; 14h, the host path
    of phases 10o and 10k (host_path_graphed)."""
    from m3t_tpu_torch import bench

    begin = time.perf_counter()
    out = {}
    for mode in ("region", "rgbd", "ycb", "occlusion", "kinematic", "kinematic_rgbd"):
        (work,) = bench.build_workload(mode, N_BODIES, "cuda")
        out[mode] = eager_and_graphed(mode, card, work.cycle, work.state,
                                      BENCH_LAUNCHES[mode])
        del work
    bt = sequences_batch(seq, N_BODIES, torch.device("cuda"))
    out["scan_rgbd_step"] = eager_and_graphed(
        "scan_rgbd_step", card, lambda state: scan_step_cycle(seq, bt, state),
        sequences_start(seq, bt), dict(BENCH_LAUNCHES["rgbd"]))
    for label, path_inp, cycle, launches in (
            ("multicamera", mc, multicamera_cycle(mc, "rgbd_pcfg"), MULTICAMERA_LAUNCHES),
            ("kinematic_multicamera", kmc, kinematic_multicamera_cycle(kmc, "rgbd_pcfg"),
             BENCH_LAUNCHES["kinematic_rgbd"])):
        bt = path_inp["kind"].batch(path_inp, N_BODIES, torch.device("cuda"))
        out[label] = eager_and_graphed(
            label, card, lambda state: cycle(path_inp, bt, state),
            path_inp["kind"].start(path_inp, bt), launches)
    del bt
    for work in bench.build_workload("latency", N_BODIES, "cuda"):
        out[f"latency_B{work.body_frames}"] = eager_and_graphed(
            f"latency B={work.body_frames}", card, work.cycle, work.state,
            BENCH_LAUNCHES["latency"])
    for rgbd in (False, True):
        label = "serve_latency_rgbd" if rgbd else "serve_latency"
        out[label] = serve_graphed(label, card, inp, seq, models, rgbd)
    for label, graph in (("host_occluded", occluded_scene_graph),
                         ("host_structures", structure_graph)):
        out[label] = host_path_graphed(label, card, graph, inp, models)
    out["phase14_s"] = time.perf_counter() - begin
    log(f"phase 14 took {out['phase14_s']:.1f} s ({card})")
    return out


def segments_rank(rank: int, world: int, init_method: str) -> None:
    """Phase 14d, one of `world` gloo processes on the one card, forming a (1, world)
    mesh: the dry run's multi-camera rigid and articulated cycles on this rank's camera
    (m3t_tpu_torch.parallel.dryrun's problem, rigid_call and kinematic_call), GRAPH_CYCLES
    eager cycles and a graphed one from the state each eager one started from (the
    first captures the graph, the others replay it), every graphed state equal to the
    eager one bit for bit, one segment more than the cycle's Newton steps (an all_reduce
    between each two) and the eager cycle's launches per replay.  Prints one JSON line;
    raises on any failure."""
    import torch.distributed as dist

    from m3t_tpu_torch import graphs
    from m3t_tpu_torch.parallel import dryrun, sharding

    torch.cuda.set_device(0)
    sharding.initialize_distributed(init_method, world, rank, "gloo")
    try:
        mesh = sharding.make_mesh(n_camera=world)
        inp = dryrun.problem(torch.device("cuda"), mesh.n_data)
        n_steps = inp["pcfg"].n_corr_iterations * inp["pcfg"].n_update_iterations
        counters = launch_counters()
        out, failed = {}, []
        for label, make in (("rigid", dryrun.rigid_call),
                            ("articulated", dryrun.kinematic_call)):
            graphs.clear_graphs()
            call = make(inp, mesh)

            def counted(state):
                before = {n: c.launches for n, c in counters.items()}
                state = call.step(state)
                torch.cuda.synchronize()
                return state, {n: c.launches - before[n] for n, c in counters.items()}

            eager = [(call.state, None)]
            with graphs.disable_graphs():
                for _ in range(GRAPH_CYCLES):
                    eager.append(counted(eager[-1][0]))
            graphed = [counted(state) for state, _ in eager[:-1]]
            (info,) = graphs.captured()
            unequal = {i + 1: unequal_fields(g, e) for i, ((g, _), (e, _))
                       in enumerate(zip(graphed, eager[1:])) if unequal_fields(g, e)}
            launches = [n for _, n in eager[1:]]
            case = dict(equal_cycles=GRAPH_CYCLES - len(unequal), unequal=unequal,
                        segments=info.segments, newton_steps=n_steps,
                        replays=info.replays, launches_per_replay=info.launches,
                        eager_launches=launches[0],
                        graphed_launches=[n for _, n in graphed])
            per_replay = {n: info.launches.get(n, 0) for n in counters}
            if unequal or info.segments != n_steps + 1 or info.replays != GRAPH_CYCLES - 1 \
                    or any(n != launches[0] for n in launches + case["graphed_launches"]) \
                    or per_replay != launches[0]:
                failed.append(label)
            out[label] = case
        print(json.dumps({"segments": dict(rank=rank, mesh=[mesh.n_data, mesh.n_camera],
                                           failed=failed, **out)}), flush=True)
        if failed:
            raise AssertionError(f"14d rank {rank}: {failed} failed: {out}")
    finally:
        dist.destroy_process_group()


def run_segments(card: str, world: int = 2, timeout: float = 300.0) -> dict:
    """Phase 14d: segments_rank in `world` processes on the one card over gloo (two NCCL
    ranks cannot share one card), each in its own session with its output in a file;
    every process is stopped when one fails or the time runs out.  Every rank must exit
    0."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    begin = time.perf_counter()
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.segments_rank({rank}, "
                               f"{world}, 'tcp://127.0.0.1:{port}')"],
        stdout=logs[rank], stderr=subprocess.STDOUT, text=True, start_new_session=True,
        cwd=Path(__file__).resolve().parent) for rank in range(world)]
    try:
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline \
                and not any(p.poll() not in (None, 0) for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    ranks, texts = [], []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
        ranks += [json.loads(line)["segments"] for line in texts[-1].splitlines()
                  if line.startswith('{"segments"')]
    codes = [p.returncode for p in procs]
    result = dict(card=card, exit_codes=codes, ranks=ranks,
                  seconds=time.perf_counter() - begin)
    log(f"14d: {json.dumps(result)}")
    if any(codes) or len(ranks) != world:
        raise AssertionError(f"14d: exit codes {codes}: "
                             + " | ".join(t[-2000:] for t in texts))
    return result


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from m3t_tpu_torch import graphs
    from m3t_tpu_torch.ops import _cuda

    card = card_name()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    begin = time.perf_counter()
    so = _cuda.build()
    log(f"kernels built in {time.perf_counter() - begin:.1f} s: {so.name}")
    for line in so.with_suffix(".log").read_text().splitlines():
        if any(key in line for key in ("==", "entry function", "registers", "spill",
                                        "error")):
            log(f"ptxas: {line.strip()}")

    seconds = {}  # host seconds of each stretch of phases, logged as each ends
    mark = [time.perf_counter()]

    def took(label):
        now = time.perf_counter()
        seconds[label] = now - mark[0]
        mark[0] = now
        log(f"{label} took {seconds[label]:.1f} s")

    models, generation_s = generate_models()
    inp = flagship_inputs("cuda", N_BODIES, models)
    kin = kinematic(inp)
    took("phases 1, 0m and the kernels' build")
    kernel_cases = check_kernels(inp, kin)
    took("phase 2")
    # Every rigid cycle launches newton_step once per Newton step (5 x 2; YCB 4 x 2), the
    # articulated cycles never; StartModality takes no step.
    region_launches = {"sample_lines": 6, "bin_counts": 2, "sample_windows": 0,
                       "query_eval": 0, "newton_step": 10}
    at_init = {"sample_lines": 1, "bin_counts": 2}
    paths, tensors = {}, {}
    paths["region"], tensors["region"] = run_path(
        "region", inp, region_cycle, region_launches, at_init)
    paths["rgbd"], tensors["rgbd"] = run_path(
        "rgbd", inp, rgbd_cycle("rgbd_pcfg"), dict(region_launches, sample_windows=5),
        at_init)
    # YCB parameters: 4 correspondence iterations (scales 7, 4, 2, 2), each with one
    # window fetch for the depth correspondences and one for the measured occlusions of
    # either modality.
    paths["ycb"], tensors["ycb"] = run_path(
        "ycb", inp, rgbd_cycle("ycb_pcfg"),
        {"sample_lines": 5, "bin_counts": 2, "sample_windows": 12, "query_eval": 0,
         "newton_step": 8},
        at_init)
    # bench.py --occlusion: one combined scene evaluation per correspondence iteration.
    paths["occlusion"], tensors["occlusion"] = run_path(
        "occlusion", occlusion_path(inp), region_cycle,
        dict(region_launches, query_eval=5, scene_coeffs=5), at_init)
    # bench.py --kinematic and --kinematic-rgbd: the region path's launches plus one
    # combined scene evaluation per correspondence iteration (and the RGB-D path's
    # window fetches), and no newton_step.
    paths["kinematic"], tensors["kinematic"] = run_path(
        "kinematic", kin, kinematic_cycle("pcfg"), BENCH_LAUNCHES["kinematic"], at_init)
    paths["kinematic_rgbd"], tensors["kinematic_rgbd"] = run_path(
        "kinematic_rgbd", kin, kinematic_cycle("rgbd_pcfg"),
        BENCH_LAUNCHES["kinematic_rgbd"], at_init)
    # No depth crop on the RGB-D paths: no aten operation of a cycle reads the frame.
    reads = {label: depth_frame_reads(path_inp, cycle, tensors[label])
             for label, path_inp, cycle in (
                 ("rgbd", inp, rgbd_cycle("rgbd_pcfg")), ("ycb", inp, rgbd_cycle("ycb_pcfg")),
                 ("kinematic_rgbd", kin, kinematic_cycle("rgbd_pcfg")))}
    log(f"aten operations per cycle that read the depth frame: {json.dumps(reads)}")
    if any(reads.values()):
        raise AssertionError(f"an RGB-D path reads the depth frame outside "
                             f"sample_windows: {reads}")
    for label, n in reads.items():
        paths[label]["depth_frame_reads_per_cycle"] = n
    del tensors
    took("phases 3-6k")
    # Phase 8: the scale-out paths, a frame of its own per (sequence, step) and per
    # (body, camera); each path's tensors go before the next path runs, so that its peak
    # memory is its own.  8s: the sequence scans, one tracking cycle per step.
    seq, mc, kmc = sequences(inp), multicamera(inp), kinematic_multicamera(kin)
    paths["scan"] = run_scan("scan", seq, False, region_launches, at_init)[0]
    paths["scan_rgbd"], phase8 = run_scan(
        "scan_rgbd", seq, True, dict(region_launches, sample_windows=5), at_init)
    with twin_checked("8s scan step") as checked:
        scan_step_cycle(seq, *phase8)
    paths["scan_rgbd"]["twin_checked_calls"] = checked["kernel_calls"]
    del phase8
    # 8c: two cameras over B bodies, all four scene checks: three scene evaluations per
    # correspondence iteration (region checks and modeled occlusions, depth modeled
    # occlusions, silhouette check) over the B x C flat batch.
    mc_cycle = multicamera_cycle(mc, "rgbd_pcfg")
    paths["multicamera"], phase8 = run_path("multicamera", mc, mc_cycle,
                                            MULTICAMERA_LAUNCHES, at_init)
    with twin_checked("8c multicamera cycle") as checked:
        mc_cycle(mc, *phase8)
    paths["multicamera"]["twin_checked_calls"] = checked["kernel_calls"]
    del phase8
    # 8k: two cameras over S structures, per-link scenes in each camera.
    kmc_cycle = kinematic_multicamera_cycle(kmc, "rgbd_pcfg")
    paths["kinematic_multicamera"] = run_path(
        "kinematic_multicamera", kmc, kmc_cycle, BENCH_LAUNCHES["kinematic_rgbd"],
        at_init)[0]
    took("phase 8 but 8x and 8d")
    # Phase 9: the reference-shaped serve path, Tracker.RunTrackerProcess through the
    # fused serve backend: the region and RGB-D graphs at B=512 (9s, 9d) and at B=1
    # (9l), launching per step what the bare cycle of the same path launches.
    for label, bodies, rgbd in (("serve", N_BODIES, False), ("serve_rgbd", N_BODIES, True),
                                ("serve_latency", 1, False),
                                ("serve_latency_rgbd", 1, True)):
        paths[label] = run_serve(label, inp, seq, models, bodies, rgbd,
                                 dict(region_launches, sample_windows=5 if rgbd else 0))
    took("phase 9 but 9x")
    card_vs_cpu = {"region": check_card_against_cpu("region", inp, region_cycle)}
    # 9x: the serve graphs at B=8, and at B=1, the batch at which 9l launches the kernels.
    for n_bodies, prefix in ((8, "serve"), (1, "serve latency")):
        for rgbd in (False, True):
            label = f"{prefix} {'rgbd' if rgbd else 'region'}"
            card_vs_cpu[label] = check_serve_card_against_cpu(label, inp, seq, models, rgbd,
                                                              n_bodies=n_bodies)
    occlusions = walled(dict(inp, rgbd_pcfg=inp["rgbd_pcfg"]._replace(
        region_measure_occlusions=True, depth_measure_occlusions=True)))
    check_masks_drop("measured occlusions", occlusions)
    card_vs_cpu["rgbd with measured occlusions"] = check_card_against_cpu(
        "rgbd with measured occlusions", occlusions, rgbd_cycle("rgbd_pcfg"))
    scene = occluded(inp)
    check_masks_drop("scene checks", scene)
    # The three cases of this slice's paths meet rounding-boundary events at their first
    # entries (see check_card_against_cpu): each may part at one named entry.
    for label, path_inp, cycle, parted_allowed in (
            ("region with scene checks", scene, region_cycle, 0),
            ("rgbd with scene checks", scene, rgbd_cycle("rgbd_pcfg"), 0),
            ("ycb with texture", inp, rgbd_cycle("ycb_pcfg"), 1),
            ("kinematic with scenes", kin, kinematic_cycle("pcfg"), 1),
            # Two structures part in cycle 1 since the divisions that reach a trunc or a
            # comparison round as jitted JAX's do (structure 1 before), the second by
            # 1.0866e-4 in histogram_b (NVIDIA H100 80GB HBM3, 700 W).
            ("kinematic rgbd", kin, kinematic_cycle("rgbd_pcfg"), 2),
            # Phase 8x: the scale-out paths at B=8 (S=4) and C=2.  The articulated case
            # carries twice the link views of "kinematic rgbd" and may part, as it does,
            # at one named structure per camera.
            ("scan rgbd step", seq, scan_step_cycle, 0),
            ("multicamera with texture", mc, multicamera_cycle(mc, "texture_pcfg", True),
             0),
            ("kinematic multicamera", kmc, kinematic_multicamera_cycle(kmc, "rgbd_pcfg"),
             len(kmc["cam2ref"]))):
        card_vs_cpu[label] = check_card_against_cpu(label, path_inp, cycle,
                                                    parted_allowed=parted_allowed)
    took("phases 7, 8x and 9x")
    # Phase 10: the host path through RunTrackerProcess, an occluded scene with every
    # scene check (10o) and articulated structures with constraints (10k), then the
    # same graphs on the card against the CPU (10x).
    phase10_begin = time.perf_counter()
    paths["host_occluded"] = run_host_path("host_occluded", occluded_scene_graph, inp,
                                           models, "models occlusions")
    paths["host_structures"] = run_host_path("host_structures", structure_graph, inp,
                                             models, "has constraints")
    paths["host_occluded"]["normal_image"] = check_normal_image(inp, models)
    paths["host_occluded"]["render_windows"] = check_render_windows(inp, models)
    # The occluded graph's witnessed parting at host_optimizer2, step 0, moves histogram_b
    # by 2.6374e-3 on the card and 2.6374e-3 on the nudged CPU (NVIDIA H100 80GB HBM3,
    # 700 W), since the divisions that reach a trunc or a comparison round as jitted
    # JAX's do: its histogram_b limit is 3e-3.
    for label, graph, bounds in (
            ("host occluded", occluded_scene_graph,
             dict(HOST_PARTED_BOUNDS, histogram_b=3e-3)),
            ("host structures", structure_graph, HOST_PARTED_BOUNDS)):
        card_vs_cpu[label] = check_host_card_against_cpu(label, graph, inp, models,
                                                         bounds=bounds)
    phase10_s = time.perf_counter() - phase10_begin
    log(f"phase 10 took {phase10_s:.1f} s")
    # Phase 11: the evaluators and their entry points on synthetic datasets (11w), RBOT
    # at B=90 (11r), YCB-Video, RTB, OPT and Choi (11y, 11k, 11o), the host modes (11h),
    # and card against CPU on the same files (11x).
    # Phase 12: the other entry points of examples/ on phase 11's datasets: a recorded
    # sequence (12r), generated trackers (12g), the parameter studies (12p), card against
    # CPU (12x) and the optimizer timing (12o).
    graphs.clear_graphs()
    root = Path(tempfile.mkdtemp(prefix="m3t_eval_"))
    try:
        log("phase 11: the evaluators")
        evaluation, ds = run_phase11(root)
        log("phase 12: the other entry points")
        phase12 = run_phase12(root, ds)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # Phase 13: the benchmark runner in its seven modes, as subprocesses (13b) and
    # through build_workload with every launch and kernel call held (13k).
    graphs.clear_graphs()
    log("phase 13: the benchmark runner")
    phase13 = run_phase13(card)
    # Phase 14: the fused cycles graphed (the port's jax.jit) against their eager twins.
    log("phase 14: graphed against eager")
    phase14 = run_phase14(card, inp, seq, models, mc, kmc)
    # 14d: the multi-camera cycles on a (1, 2) mesh of two gloo processes, graphs of
    # several segments with an all_reduce between each two.
    log("phase 14d: a graph's segments around the camera all_reduce")
    phase14["segments"] = run_segments(card)
    log(f"held on the CPU only, for want of cv2 on this machine: {CV2_ONLY}")
    disagree = {label: case for label, case in card_vs_cpu.items()
                if len(case["parted"]) > case["parted_allowed"] or case["twin_mismatches"]
                or case.get("beyond_bounds") or case.get("unexplained")}
    disagree.update({f"11x {label}": case
                     for label, case in evaluation["card_vs_cpu"].items() if case["failed"]})
    disagree.update({f"12x {label}": case
                     for label, case in phase12["card_vs_cpu"].items() if case["failed"]})
    if disagree:
        raise AssertionError(f"card and CPU disagree beyond atol {PHASE7_ATOL}: {disagree}")
    took("phases 10-14 and the disagreement check")
    dryrun = run_dryrun()
    took("phase 8d")

    print(json.dumps({"kernel_cases": kernel_cases, "paths": paths,
                      "card_vs_cpu": card_vs_cpu, "dryrun": dryrun, "card": card,
                      "model_generation_s": generation_s,
                      "phase10_s": phase10_s, "eval": evaluation, "phase12": phase12,
                      "phase13": phase13, "phase14": phase14, "seconds": seconds}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
