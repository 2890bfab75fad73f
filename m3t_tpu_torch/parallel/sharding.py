"""Scale-out over torch.distributed (port of m3t_tpu/parallel/sharding.py).

The reference's only parallelism is OpenMP threads in one process.  The port's scaling
dimensions are those of the JAX package: independent bodies and sequences data-parallel
over the processes of a mesh ("data"), and per-body multi-camera fusion, whose
gradient and Hessian terms are summed over the processes of a camera group ("camera",
pipeline.make_sharded_cycle).  Where the JAX package lays a device mesh out and lets
shard_map slice global arrays, a torch.distributed process holds only its own shard: a
:class:`Mesh` names this rank's place in the (data, camera) grid and the process groups
it reduces over, :func:`shard_over` cuts a rank's shard out of global tensors, and
:func:`track_sequences_scan` tracks B sequences over T frames on the device.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


class Mesh(NamedTuple):
    """This rank's place in a (data, camera) grid of processes, laid out row-major
    (rank = data_index * n_camera + camera_index), and its two process groups: the
    ranks of its data index (one per camera) and those of its camera index.  The groups
    are None in a single process."""

    n_data: int
    n_camera: int
    data_index: int
    camera_index: int
    camera_group: object  # torch.distributed ProcessGroup over the n_camera ranks
    data_group: object    # torch.distributed ProcessGroup over the n_data ranks


def initialize_distributed(init_method: str | None = None, world_size: int | None = None,
                           rank: int | None = None, backend: str | None = None) -> None:
    """torch.distributed.init_process_group for a multi-process mesh; nothing when
    init_method is None (m3t_tpu/parallel/sharding.py:21-29).  The caller names the
    backend ("gloo", or "nccl" with one card per rank): none is chosen for it, and a
    failure to initialise raises."""
    if init_method is None:
        return
    if backend is None:
        raise ValueError("initialize_distributed: name the backend ('gloo' or 'nccl')")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    log.info("torch.distributed: rank %d of %d, backend %s", dist.get_rank(),
             dist.get_world_size(), backend)


def make_mesh(n_data: int | None = None, n_camera: int = 1) -> Mesh:
    """The (data, camera) mesh over the processes of the default group, row-major as
    ``np.array(devices).reshape(n_data, n_camera)`` (m3t_tpu/parallel/sharding.py:32).
    n_data defaults to world_size // n_camera, and the grid must hold every rank.
    new_group is collective, so every rank creates every group, in the same order."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_camera
    if n_data * n_camera != world:
        raise ValueError(f"a ({n_data}, {n_camera}) mesh needs {n_data * n_camera} "
                         f"processes, the group has {world}")
    data_index, camera_index = divmod(rank, n_camera)
    camera_group = data_group = None
    if world > 1:
        for d in range(n_data):
            group = dist.new_group([d * n_camera + c for c in range(n_camera)])
            if d == data_index:
                camera_group = group
        for c in range(n_camera):
            group = dist.new_group([d * n_camera + c for d in range(n_data)])
            if c == camera_index:
                data_group = group
    return Mesh(n_data, n_camera, data_index, camera_index, camera_group, data_group)


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple):
        leaves = [_tree_map(fn, x) for x in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(leaves)
    raise TypeError(f"shard_over: cannot cut a {type(tree).__name__}")


def shard_over(tree, mesh: Mesh | None, axis: str = "data", dim: int = 0):
    """This rank's shard of every tensor in ``tree`` (a tensor, None, or NamedTuples and
    tuples of them): the rank's equal slice of dimension ``dim`` along the
    mesh axis ``axis`` ("data" or "camera"), as a view.  The JAX function places global
    arrays on a device mesh; here each process keeps its own slice.  mesh=None returns
    the tree."""
    if mesh is None:
        return tree
    if axis not in ("data", "camera"):
        raise ValueError(f"shard_over: axis must be 'data' or 'camera', not {axis!r}")
    n, index = ((mesh.n_data, mesh.data_index) if axis == "data"
                else (mesh.n_camera, mesh.camera_index))

    def cut(a):
        size = a.shape[dim]
        if size % n:
            raise ValueError(f"shard_over: dimension {dim} of size {size} does not split "
                             f"into {n} shards")
        return a.narrow(dim, index * (size // n), size // n)

    return _tree_map(cut, tree)


def track_sequences_scan(pcfg, intr, frames, model, state, mesh: Mesh | None = None):
    """Track B independent sequences over T frames on the device (the dataset-scale
    evaluation path, m3t_tpu/parallel/sharding.py:60): one pipeline.tracking_cycle per
    time step over the batch of sequences, with no host synchronisation in the loop.

    frames (T, B, H, W, 3) or planar (T, B, 3, H, W) uint8 on the state's device; model
    and state (TrackingState) of the B sequences.  With a mesh, every argument is global
    and this rank tracks its data-axis slice of the sequences (the ranks of one data
    index, one per camera, track the same slice, as the JAX scan is replicated over
    "camera").  Returns (final TrackingState, poses (T, B, 4, 4)) of the sequences this
    rank tracked.
    """
    from m3t_tpu_torch import pipeline

    frames = shard_over(frames, mesh, "data", dim=1)
    model, state = shard_over((model, state), mesh, "data")
    return _scan(lambda state, t: pipeline.tracking_cycle(pcfg, intr, frames[t], model,
                                                          state),
                 state, frames.shape[0])


def track_sequences_scan_rgbd(pcfg, intr, depth_intr, depth_scale, frames, depth_frames,
                              model, depth_model, state, mesh: Mesh | None = None):
    """The RGB-D variant of :func:`track_sequences_scan` (the YCB-Video / ICG class,
    m3t_tpu/parallel/sharding.py:95): one pipeline.tracking_cycle_rgbd per time step.
    depth_frames (T, B, Hd, Wd) uint16.  The on-device analogue of the reference's
    ``#pragma omp parallel for`` over YCB sequences (ycb_evaluator.cpp:210).  Returns
    (final TrackingState, poses (T, B, 4, 4))."""
    from m3t_tpu_torch import pipeline

    frames, depth_frames = shard_over((frames, depth_frames), mesh, "data", dim=1)
    model, depth_model, state = shard_over((model, depth_model, state), mesh, "data")
    return _scan(lambda state, t: pipeline.tracking_cycle_rgbd(
        pcfg, intr, depth_intr, depth_scale, frames[t], depth_frames[t], model, depth_model,
        state), state, frames.shape[0])


def _scan(cycle, state, n_steps: int):
    """n_steps of cycle(state, t), the poses of every step written into one tensor."""
    poses = torch.empty((n_steps,) + state.body2camera_pose.shape,
                        dtype=state.body2camera_pose.dtype,
                        device=state.body2camera_pose.device)
    for t in range(n_steps):
        state = cycle(state, t)
        poses[t] = state.body2camera_pose
    return state, poses
