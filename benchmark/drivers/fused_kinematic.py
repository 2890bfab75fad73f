"""Evaluation-scale articulated RGB-D tracking: ``pipeline.initialize_kinematic_histograms``
at set-up, then one ``pipeline.tracking_cycle_kinematic`` per step over every structure,
each on colour and depth frames of its own, with per-link region and depth terms, the
links' focused scenes and the structures' KKT step; the joint state read to the host
after every step and the link positions computed from it (as the RTB evaluator reads
them to score a frame).

The structure comes from the object graph the evaluators build (``Link``s on ``Body``s,
a ``Constraint`` and an ``Optimizer``), through ``kin_ops.build_kinematic_model``.
States are compared with the reference as (link body2camera poses flattened to B = S *
NL bodies, histogram_f, histogram_b).
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from benchmark.harness import check, cycle, models, roofline_scene, sphere_depth
from benchmark.harness.driver import ClosedLoop
from benchmark.traffic import generator


class Side(NamedTuple):
    """What computes the start and each step: ``start(images, joint2parent) -> state``,
    ``cycle(images, depth_images, state) -> state`` (states (joint2parent (S, NL, 4,
    4), histogram_f (S, NL, n), histogram_b)) and ``poses(joint2parent) -> (S, NL, 4,
    4)`` link body2camera poses."""

    start: object
    cycle: object
    poses: object


def _rotation(axis: str, degrees: float) -> np.ndarray:
    """(4, 4) rotation by ``degrees`` about the frame's x, y or z axis."""
    a = np.radians(degrees)
    c, s = np.cos(a), np.sin(a)
    i, j = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}[axis]
    pose = np.eye(4)
    pose[i, i] = pose[j, j] = c
    pose[i, j], pose[j, i] = -s, s
    return pose


def joint_poses(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """The configuration's structure as float32 (body2joint (NL, 4, 4), joint2parent (NL,
    4, 4)): the root's joint pose is its pose in the camera frame (its body2joint the
    identity), a child's body sits ``link_offset_m`` along its joint's x axis, and its
    joint is its parent's centre turned by the joint's angle about the joint's axis."""
    st = config["structure"]
    nl = len(st["parent"])
    body2joint = np.tile(np.eye(4), (nl, 1, 1))
    joint2parent = np.tile(np.eye(4), (nl, 1, 1))
    root = np.eye(4)
    for axis, degrees in st["root_rotation_deg"]:
        root = root @ _rotation(axis, degrees)
    root[:3, 3] = st["root_position_m"]
    joint2parent[0] = root
    for link in range(1, nl):
        body2joint[link, 0, 3] = st["link_offset_m"]
        joint2parent[link] = _rotation(st["joint_axes"][link], st["joint_angles_deg"][link])
    return body2joint.astype(np.float32), joint2parent.astype(np.float32)


def scene_meshes(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """Each link's mesh: the icosphere of ``body_subdivisions`` at the body radius."""
    return models.icosphere(int(config["body_subdivisions"]), float(config["body_radius"]))


def object_graph(config: dict):
    """(optimizer, bodies): the structure as the evaluators' object graph, a Link on a
    set-up icosphere Body per link, the hard constraints and an Optimizer on the root."""
    from m3t_tpu_torch.body import Body
    from m3t_tpu_torch.constraint import Constraint
    from m3t_tpu_torch.link import Link
    from m3t_tpu_torch.optimizer import Optimizer

    st = config["structure"]
    body2joint, joint2parent = joint_poses(config)
    vertices, triangles = scene_meshes(config)
    bodies, links = [], []
    for link, parent in enumerate(st["parent"]):
        body = Body(f"rtb_link{link}", vertices=vertices, triangles=triangles)
        if not body.SetUp():
            raise RuntimeError(f"body of link {link} failed to set up")
        bodies.append(body)
        links.append(Link(f"rtb_link{link}", body, body2joint_pose=body2joint[link],
                          joint2parent_pose=joint2parent[link],
                          free_directions=[bool(f) for f in st["free"][link]]))
        if parent >= 0:
            links[parent].AddChildLink(links[-1])
    links[0].set_link2world_pose(joint2parent[0])
    if not all(link.SetUp() for link in links):
        raise RuntimeError("a link of the structure failed to set up")
    optimizer = Optimizer("rtb_optimizer", links[0], config["tikhonov_rotation"],
                          config["tikhonov_translation"])
    for i, c in enumerate(st["constraints"]):
        constraint = Constraint(f"rtb_constraint{i}", links[c["link1"]], links[c["link2"]],
                                body22joint2_pose=body2joint[c["link2"]],
                                constraint_directions=[bool(d) for d in c["directions"]])
        if not (constraint.SetUp() and optimizer.AddConstraint(constraint)):
            raise RuntimeError(f"constraint {i} failed to set up")
    if not optimizer.SetUp():
        raise RuntimeError("the structure's optimizer failed to set up")
    return optimizer, bodies


def pipeline_config(pipeline, region_fn, depth_fn, config: dict):
    """The program's PipelineConfig for the configuration: the region settings, depth
    fusion and the modeled occlusions of both modalities through the focused scene."""
    pcfg = cycle.pipeline_config(pipeline, region_fn, config)
    return pcfg._replace(
        cfg=pcfg.cfg._replace(modeled_occlusion_radius=config["modeled_occlusion_radius"],
                              modeled_occlusion_threshold=config[
                                  "modeled_occlusion_threshold"]),
        use_depth=True,
        depth_cfg=depth_fn.DepthConfig(
            n_points_max=config["n_points"], stride_length=config["stride_length"],
            modeled_occlusion_radius=config["depth_modeled_occlusion_radius"],
            modeled_occlusion_threshold=config["depth_modeled_occlusion_threshold"]),
        considered_distances=tuple(config["considered_distances"]),
        depth_standard_deviations=tuple(config["depth_standard_deviations"]),
        **{k: config[k] for k in ("region_model_occlusions", "depth_model_occlusions",
                                  "region_measure_occlusions", "depth_measure_occlusions",
                                  "region_checking", "depth_silhouette_check",
                                  "occlusion_queries", "focused_image_size", "z_min",
                                  "z_max")})


def program_side(driver) -> Side:
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import depth_fn, region_fn
    from m3t_tpu_torch.ops import kinematics as kin_ops
    from m3t_tpu_torch.ops import occlusion

    config, dev, s = driver.config, driver.device, driver.n
    pcfg = pipeline_config(pipeline, region_fn, depth_fn, config)
    intr = driver.intr
    optimizer, bodies = object_graph(config)
    kin = kin_ops.build_kinematic_model([optimizer], device=dev).expand(s)
    nl = kin.n_links
    region = cycle.region_model(pipeline, config, s * nl, dev)
    depth = pipeline.DepthModelArrays.from_models(
        [SimpleNamespace(set_up=True, **sphere_depth.sphere_depth_model(config))],
        config["n_points"], device=dev).expand(s * nl)
    # One structure's scenes (scene l tracks link l, focused on it), one per structure.
    one = occlusion.build_kinematic_scene_geometry(
        [bodies], referenced=[[link] for link in range(nl)], device=dev)
    scene = type(one)(*(a.repeat((s,) + (1,) * (a.dim() - 1)) for a in one))
    depth_scale = float(config["depth_scale"])

    def start(images, joint2parent):
        return pipeline.initialize_kinematic_histograms(pcfg, intr, images, region, kin,
                                                        joint2parent)

    def step(images, depth_images, state):
        return pipeline.tracking_cycle_kinematic(
            pcfg, intr, images, region, kin, state, scene_geom=scene, depth_intr=intr,
            depth_scale=depth_scale, depth_images=depth_images, depth_model=depth)

    return Side(start, step, lambda joints: pipeline.kinematic_body_poses(
        kin, pipeline.KinematicTrackingState(joints, None, None)))


def reference_side(driver, tf32: bool = False) -> Side:
    """The plain reference, in float32 or (tf32) with its matmuls in TF32."""
    from benchmark.reference import kinematic

    config, dev = driver.config, driver.device
    settings = kinematic.Settings.from_config(config)
    body2joint, _ = joint_poses(config)
    structure = kinematic.Structure.from_config(config, body2joint, dev)
    vertices, triangles = scene_meshes(config)
    models_ = kinematic.Models.from_arrays(
        cycle.region_arrays(config), sphere_depth.sphere_depth_model(config),
        vertices[triangles], dev)

    def precision():
        return check.TF32Matmuls() if tf32 else contextlib.nullcontext()

    def start(images, joint2parent):
        with precision():
            return kinematic.start(settings, structure, models_, images, joint2parent)

    def step(images, depth_images, state):
        with precision():
            return kinematic.cycle(settings, structure, models_, images, depth_images,
                                   tuple(state))

    return Side(start, step, lambda joints: kinematic.forward_kinematics(structure, joints))


def _flat(side: Side, state) -> tuple:
    """(link poses (B, 4, 4), histogram_f (B, n), histogram_b (B, n)) of a state."""
    poses = side.poses(state[0])
    n = state[1].shape[-1]
    return (poses.reshape(-1, 4, 4), state[1].reshape(-1, n), state[2].reshape(-1, n))


class Driver(ClosedLoop):
    def __init__(self, cell, config, traffic, seed, device, side=None):
        super().__init__(cell, config, traffic, seed, device, side)
        self.n = traffic["batch"]
        self.nl = len(config["structure"]["parent"])
        self.units_per_step = self.n * self.nl
        self.intr = cycle.intrinsics(config)
        self.body2joint, self.joint2parent = joint_poses(config)
        self.parent = np.asarray(config["structure"]["parent"])

    def initial_joints(self, start: np.ndarray) -> np.ndarray:
        """The generator's start (the root's x/y jitter) with each child joint turned by
        a ``joint_jitter_deg``-uniform angle about its axis, drawn from the seed."""
        rng = np.random.default_rng(np.random.SeedSequence([abs(int(self.seed)), 2]))
        st = self.config["structure"]
        angles = rng.uniform(-self.traffic["joint_jitter_deg"],
                             self.traffic["joint_jitter_deg"], (self.n, self.nl))
        out = start.astype(np.float64)
        for link in range(1, self.nl):
            turn = np.stack([_rotation(st["joint_axes"][link], a) for a in angles[:, link]])
            out[:, link] = out[:, link] @ turn
        return out.astype(np.float32)

    def setup(self) -> None:
        structure = {"parent": self.parent[None], "body2joint": self.body2joint[None],
                     "joint2parent": self.joint2parent[None]}
        self.seq = generator.sequences(self.traffic, self.config, self.seed, self.device,
                                       structure=structure)
        self.joints0 = torch.as_tensor(self.initial_joints(self.seq.start),
                                       device=self.device)
        self.side = (self.side_factory or program_side)(self)
        state = self.side.start(self.seq.colour[0], self.joints0)
        self.start = _flat(self.side, state)
        self.state = state
        self.warm_up()
        self.read_capture_s()

    def step(self, traced: bool) -> None:
        index, frame = self.window_step(), self.frame(self.t + 1)
        state_in = self.state
        self.mark("step")
        self.mark("cycle")
        self.state = self.side.cycle(self.seq.colour[frame], self.seq.depth[frame],
                                     state_in)
        self.mark("cycle_end")
        joints = self.state[0].cpu().numpy()
        positions = generator.forward_kinematics(self.parent, joints.astype(np.float64),
                                                 self.body2joint)[..., :3, 3]
        self.t += 1
        out = _flat(self.side, self.state) if index in self.checkpoints else None
        self.record(frame, positions, state_in, out, index)

    def outcome(self):
        return super().outcome(self.seq.truth)

    def kernel_work(self) -> dict:
        """The kernels' work in one more cycle, run eagerly from the window's last state
        (after the window): K1, K3 and K4."""
        frame = self.frame(self.t + 1)
        with roofline_scene.recorded_calls() as calls:
            self.side.cycle(self.seq.colour[frame], self.seq.depth[frame], self.state)
        return roofline_scene.cycle_work(calls)

    def free(self) -> None:
        self.side = self.state = None
        self.free_program()

    def reference(self):
        """The reference's start and cycle, each giving the flattened state."""
        ref = reference_side(self)
        return SimpleNamespace(
            start=lambda *a: _flat(ref, ref.start(*a)),
            cycle=lambda *a: _flat(ref, ref.cycle(*a)))

    def start_inputs(self) -> tuple:
        return self.seq.colour[0], self.joints0

    def frame_inputs(self, frame: int) -> tuple:
        return self.seq.colour[frame], self.seq.depth[frame]
