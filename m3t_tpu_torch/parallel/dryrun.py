"""Dry run of the scale-out paths over N processes: the multi-camera rigid cycle with
depth and scene checks, the multi-camera articulated cycle and the sequence scan, on a
(data, camera) mesh of torch.distributed processes at tiny shapes, held against one
process that runs the same inputs alone (the port's counterpart of the JAX package's
__graft_entry__.dryrun_multichip and tools/multihost_dryrun.py).

    python -m m3t_tpu_torch.parallel.dryrun --processes N [--device cpu|cuda]
                                            [--backend gloo|nccl]

N processes form a (N // 2, 2) mesh when N is even, else (N, 1).  Every process builds
the same global inputs from a seed and runs its shard; rank 0 gathers the shards, runs
the whole batch in one process (mesh=None) and compares every output within TOLERANCE.
The exit code is 0 only when every process exited 0 and nothing differed.  --device cuda
puts rank r on card r mod the card count; NCCL needs a card per rank, gloo reduces CUDA
tensors through the host.  Neither the device nor the backend is ever swapped for
another when it fails.  On the card the multi-camera cycles run graphed, CYCLES times
each: the first call captures the graph (a camera group of two ranks splits it into
segments at its all_reduces), the others replay it.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import socket
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

TOLERANCE = 1e-6  # sharded against one process: max abs difference of every output
TIMEOUT_S = 600.0  # every process is stopped, and the run fails, after this
WIDTH, HEIGHT, FOCAL = 160, 128, 200.0
DEPTH_SCALE = 0.001
N_LINES, N_POINTS, N_FRAMES = 64, 64, 2
CYCLES = 3  # each multi-camera cycle's count: a capture and two replays on the card


def problem(device, n_data: int, seed: int = 0) -> dict:
    """The global inputs of every path, the same in every process: B = 2 * n_data
    spheres (and as many two-link structures and sequences) seen by two cameras, the
    second 20 degrees to the side and off its optical axis, frames per (body,
    camera) with their own noise, jittered initial poses."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.common import Intrinsics
    from m3t_tpu_torch.ops import kinematics, occlusion
    from m3t_tpu_torch.ops.depth_fn import DepthConfig
    from m3t_tpu_torch.ops.region_fn import RegionConfig
    from m3t_tpu_torch.utils import procedural

    data = Path(pipeline.__file__).parent / "data"
    b = 2 * n_data
    rng = np.random.default_rng(seed)
    intr_t = Intrinsics(FOCAL, FOCAL, WIDTH / 2 - 0.5, HEIGHT / 2 - 0.5, WIDTH, HEIGHT)
    intr = intr_t[:4]
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.6
    cam2ref = np.stack([np.eye(4, dtype=np.float32),
                        procedural.orbit_camera(pose0[:3, 3], 20.0, 5.0)])
    ref2cam = np.linalg.inv(cam2ref)
    sphere = procedural.sphere_triangles(0.06, 2)

    def frames(triangles, poses_ref, n, shift=(0.0, 0.0, 0.0)):
        """(n, C, H, W, 3) uint8 and (n, C, H, W) uint16: the triangles at the
        reference-frame poses (a list of (4, 4), shifted by ``shift``) in each camera,
        each (entry, camera) frame with its own noise."""
        colour, depth = [], []
        for cam in ref2cam:
            verts = []
            for pose in poses_ref:
                p = pose.copy()
                p[:3, 3] += shift
                p = cam @ p
                verts.append(triangles @ p[:3, :3].T + p[:3, 3])
            verts = np.concatenate(verts)
            eye = np.eye(4, dtype=np.float32)
            colour.append(procedural.render_synthetic_color_frame(verts, intr_t, eye))
            depth.append(procedural.render_synthetic_depth_frame(verts, intr_t, eye,
                                                                 DEPTH_SCALE))
        colour = np.stack(colour)[None].astype(np.int16)
        noise = rng.integers(-8, 9, (n,) + colour.shape[1:])
        return (np.clip(colour + noise, 0, 255).astype(np.uint8),
                np.broadcast_to(np.stack(depth)[None], (n,) + np.shape(depth)).copy())

    pcfg = pipeline.PipelineConfig(
        cfg=RegionConfig(n_lines_max=N_LINES), scales=(2, 1),
        standard_deviations=(5.0, 1.5), n_corr_iterations=2, n_update_iterations=2,
        crop_size=128, use_depth=True, depth_cfg=DepthConfig(n_points_max=N_POINTS),
        considered_distances=(0.03, 0.02), depth_standard_deviations=(0.05, 0.03),
        region_model_occlusions=True, region_checking=True, region_measure_occlusions=True,
        depth_model_occlusions=True, depth_silhouette_check=True,
        depth_measure_occlusions=True, focused_image_size=64)
    poses = np.tile(pose0, (b, 1, 1))
    poses[:, :2, 3] += rng.uniform(-0.004, 0.004, (b, 2)).astype(np.float32)
    images, depth_images = frames(sphere, [pose0], b)
    model = pipeline.RegionModelArrays.from_npz(
        str(data / "bench_sphere_region_model.npz"), N_LINES, device=device)
    depth_model = pipeline.DepthModelArrays.from_npz(
        str(data / "bench_sphere_depth_model.npz"), N_POINTS, device=device)
    sphere_body = occlusion.SceneBody(*procedural.icosphere(2, 0.06), body_id=1, region_id=1)
    cube = occlusion.SceneBody(*procedural.cube(0.03), body_id=2, region_id=2)
    cube_pose = np.eye(4, dtype=np.float32)
    cube_pose[:3, 3] = (-0.04, 0.0, 0.45)

    with np.load(data / "bench_kinematic_model.npz") as f:
        arrays = {k: f[k] for k in f.files}
    arrays["free"] = np.ones_like(arrays["free"])
    jp0 = arrays.pop("joint2parent")
    kin = kinematics.KinematicModel.from_numpy(arrays, device)
    links = kinematics.forward_kinematics(kin, torch.as_tensor(jp0, device=device))[0]
    joint2parent = np.tile(jp0, (b, 1, 1, 1))
    joint2parent[:, 0, :2, 3] += rng.uniform(-0.004, 0.004, (b, 2)).astype(np.float32)
    kin_images, kin_depth = frames(sphere, list(links.cpu().numpy()), b)

    scan_frames = [frames(sphere, [pose0], b, shift=(0.001 * t, 0.0, 0.0))
                   for t in range(N_FRAMES + 1)]

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dict(
        pcfg=pcfg, intr=intr, cam2ref=t(cam2ref), poses=t(poses), images=t(images),
        depth_images=t(depth_images), model=model.expand(b),
        depth_model=depth_model.expand(b),
        scene_geom=occlusion.build_scene_geometry([[sphere_body, cube]],
                                                  device=device).expand(b),
        occluder_poses=t(cube_pose).expand(b, 1, 4, 4), kin=kin.expand(b),
        joint2parent=t(joint2parent), kin_images=t(kin_images), kin_depth=t(kin_depth),
        kin_scene=occlusion.build_kinematic_scene_geometry(
            [[sphere_body, sphere_body]] * b, decimate_to=64, device=device),
        link_model=model.expand(2 * b), link_depth_model=depth_model.expand(2 * b),
        scan_images=t(np.stack([f[0][:, 0] for f in scan_frames])),
        scan_depth=t(np.stack([f[1][:, 0] for f in scan_frames])))


# Each output's data-axis and camera-axis dimensions (None: replicated over cameras).
LAYOUT = {"rigid_pose": (0, None), "rigid_histogram_f": (0, 1), "rigid_histogram_b": (0, 1),
          "kinematic_joint2parent": (0, None), "kinematic_histogram_f": (0, 2),
          "kinematic_histogram_b": (0, 2), "scan_poses": (1, None),
          "scan_histogram_f": (0, None), "scan_rgbd_poses": (1, None)}


def _local(inp: dict, mesh, name: str, camera_dim=None):
    """This rank's shard of inp[name]: its data slice, and its camera slice along
    camera_dim."""
    from m3t_tpu_torch.parallel import sharding

    x = sharding.shard_over(inp[name], mesh, "data")
    return x if camera_dim is None else sharding.shard_over(x, mesh, "camera", camera_dim)


class CycleCall(NamedTuple):
    """A multi-camera cycle and the arguments of one call; args[at] is the state."""

    cycle: Callable
    args: tuple
    at: int

    @property
    def state(self):
        return self.args[self.at]

    def step(self, state):
        """The cycle from state, on the call's other arguments."""
        return self.cycle(*self.args[:self.at], state, *self.args[self.at + 1:])


def rigid_call(inp: dict, mesh) -> CycleCall:
    """The multi-camera rigid cycle (depth, every scene check) on this rank's shard of
    inp (mesh=None: the whole batch), from StartModality on the first camera frames."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.parallel import sharding

    pcfg, intr = inp["pcfg"], inp["intr"]
    cam2ref = sharding.shard_over(inp["cam2ref"], mesh, "camera")
    images, model = _local(inp, mesh, "images", 1), _local(inp, mesh, "model")
    state = pipeline.initialize_multicamera_histograms(pcfg, intr, images, cam2ref, model,
                                                       _local(inp, mesh, "poses"))
    cycle = pipeline.make_sharded_cycle(pcfg, mesh, intr, intr, with_depth=True,
                                        with_scene=True)
    extra = (_local(inp, mesh, "depth_images", 1), DEPTH_SCALE,
             _local(inp, mesh, "depth_model"), _local(inp, mesh, "scene_geom"),
             _local(inp, mesh, "occluder_poses"))
    return CycleCall(cycle, (images, cam2ref, model, state) + extra, 3)


def kinematic_call(inp: dict, mesh) -> CycleCall:
    """The multi-camera articulated cycle (depth, per-link scenes) on this rank's shard,
    from per-(structure, link, camera) histograms: the links as bodies of the rigid
    StartModality."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.parallel import sharding

    pcfg, intr = inp["pcfg"], inp["intr"]
    cam2ref = sharding.shard_over(inp["cam2ref"], mesh, "camera")
    kin, jp = _local(inp, mesh, "kin"), _local(inp, mesh, "joint2parent")
    s, nl = jp.shape[:2]
    kin_images = _local(inp, mesh, "kin_images", 1)
    link_model = _local(inp, mesh, "link_model")
    link_poses = pipeline._kinematic_flat_poses(kin, jp)[1]
    start = pipeline.initialize_multicamera_histograms(
        pcfg, intr, pipeline._repeat_each(kin_images, nl), cam2ref, link_model, link_poses)
    state = pipeline.KinematicMultiCameraState(
        jp, *(h.reshape((s, nl) + h.shape[1:]) for h in start[1:]))
    cycle = pipeline.make_sharded_kinematic_cycle(pcfg, mesh, intr, intr, with_depth=True,
                                                  with_scene=True)
    return CycleCall(cycle, (kin_images, cam2ref, link_model, kin, state,
                             _local(inp, mesh, "kin_depth", 1), DEPTH_SCALE,
                             _local(inp, mesh, "link_depth_model"),
                             _local(inp, mesh, "kin_scene"), None), 4)


def run_paths(inp: dict, mesh) -> dict:
    """Every path on this rank's shard of inp (mesh=None: the whole batch), as numpy.
    Each multi-camera cycle runs CYCLES times: on the card the first call captures its
    graph and the others replay it."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.parallel import sharding

    pcfg, intr = inp["pcfg"], inp["intr"]
    out = {}
    call = rigid_call(inp, mesh)
    state = call.state
    for _ in range(CYCLES):
        state = call.step(state)
    out.update(rigid_pose=state.body2reference_pose, rigid_histogram_f=state.histogram_f,
               rigid_histogram_b=state.histogram_b)
    call = kinematic_call(inp, mesh)
    kstate = call.state
    for _ in range(CYCLES):
        kstate = call.step(kstate)
    out.update(kinematic_joint2parent=kstate.joint2parent,
               kinematic_histogram_f=kstate.histogram_f,
               kinematic_histogram_b=kstate.histogram_b)

    # The scans take global tensors and track this rank's slice of the sequences.
    scan_pcfg = pcfg._replace(use_depth=False, region_model_occlusions=False,
                              region_checking=False, region_measure_occlusions=False,
                              depth_model_occlusions=False, depth_silhouette_check=False,
                              depth_measure_occlusions=False)
    start = pipeline.initialize_histograms(scan_pcfg, intr, inp["scan_images"][0],
                                           inp["model"], inp["poses"])
    final, poses = sharding.track_sequences_scan(scan_pcfg, intr, inp["scan_images"][1:],
                                                 inp["model"], start, mesh)
    out.update(scan_poses=poses, scan_histogram_f=final.histogram_f)
    _, poses = sharding.track_sequences_scan_rgbd(
        scan_pcfg._replace(use_depth=True), intr, intr, DEPTH_SCALE, inp["scan_images"][1:],
        inp["scan_depth"][1:], inp["model"], inp["depth_model"], start, mesh)
    out["scan_rgbd_poses"] = poses
    return {k: v.cpu().numpy() for k, v in out.items()}


def assemble(shards) -> dict:
    """The global outputs from every rank's (data_index, camera_index, outputs); the
    ranks of one data index must agree exactly on what is replicated over cameras."""
    n_data = 1 + max(d for d, _, _ in shards)
    n_camera = 1 + max(c for _, c, _ in shards)
    grid = {(d, c): out for d, c, out in shards}
    whole = {}
    for name, (data_dim, camera_dim) in LAYOUT.items():
        rows = []
        for d in range(n_data):
            blocks = [grid[d, c][name] for c in range(n_camera)]
            if camera_dim is None:
                for c, block in enumerate(blocks[1:], 1):
                    if not np.array_equal(block, blocks[0]):
                        raise AssertionError(f"{name}: camera ranks 0 and {c} of data index "
                                             f"{d} disagree")
                rows.append(blocks[0])
            else:
                rows.append(np.concatenate(blocks, camera_dim))
        whole[name] = np.concatenate(rows, data_dim)
    return whole


def _worker(rank: int, world: int, init_method: str, device: str, backend: str,
            n_camera: int) -> None:
    from m3t_tpu_torch.parallel import sharding

    torch.set_num_threads(1)
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    sharding.initialize_distributed(init_method, world, rank, backend)
    try:
        mesh = sharding.make_mesh(n_camera=n_camera)
        inp = problem(dev, mesh.n_data)
        begin = time.perf_counter()
        local = run_paths(inp, mesh)
        sharded_s = time.perf_counter() - begin
        shards = [None] * world
        dist.all_gather_object(shards, (mesh.data_index, mesh.camera_index, local))
        print(f"[dryrun] rank {rank}/{world}: mesh ({mesh.n_data}, {mesh.n_camera}) at "
              f"({mesh.data_index}, {mesh.camera_index}), {backend} on {dev}, paths in "
              f"{sharded_s:.1f} s", flush=True)
        if rank == 0:
            whole = assemble(shards)
            single = run_paths(inp, None)
            diffs = {name: float(np.abs(whole[name].astype(np.float64)
                                        - single[name]).max()) for name in LAYOUT}
            shapes = {name: list(whole[name].shape) for name in LAYOUT}
            ok = all(d <= TOLERANCE for d in diffs.values()) and all(
                whole[n].shape == single[n].shape for n in LAYOUT)
            print(json.dumps({"dryrun": dict(processes=world, mesh=[mesh.n_data, n_camera],
                                              backend=backend, device=str(dev),
                                              max_abs_diff=diffs, shapes=shapes,
                                              tolerance=TOLERANCE, ok=ok)}), flush=True)
            if not ok:
                raise AssertionError(f"sharded and single-process outputs differ beyond "
                                     f"{TOLERANCE}: {diffs}")
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--processes", type=int, required=True)
    parser.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("dryrun: --device cuda but torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    n_camera = 2 if args.processes % 2 == 0 else 1
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(rank, args.processes, init_method,
                                               args.device, args.backend, n_camera))
             for rank in range(args.processes)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S
    try:
        # A rank that fails leaves the others waiting in a collective: stop them all.
        while any(p.is_alive() for p in procs):
            failed = [p for p in procs if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    print(f"[dryrun] exit codes {codes}", flush=True)
    return 0 if all(code == 0 for code in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
