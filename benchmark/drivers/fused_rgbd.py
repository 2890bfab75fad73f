"""Evaluation-scale YCB-class RGB-D + texture tracking: ``pipeline.initialize_histograms``
at set-up, then one ``pipeline.tracking_cycle_rgbd`` per step over every slot of every
sequence, each slot on its sequence's colour and depth frames (one frame a slot, as the
YCB evaluator's ``batch_images`` stacks them), with measured occlusions on both
modalities, the multi-region bodies' slots tied by ``pose_group``, the depth terms on
each body's primary slot alone (``depth_n_points``) and the texture terms of host-made
matches (``texture_points``); the poses read to the host after every step (as the
evaluator reads them to score a frame).

A sequence's frame shows the configuration's objects, each a body of one or more
spheres; each sphere of a body is a slot (a sub-body with its own region model), the
body's first sphere its primary slot.  Slots are sequence-major: slot ``s * J + j`` is
slot j of sequence s.  States are compared with the reference as (slot poses (B, 4, 4),
histogram_f (B, n), histogram_b (B, n)).
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from benchmark.harness import check, cycle, multi_sphere, roofline_scene
from benchmark.harness.driver import ClosedLoop
from benchmark.traffic import generator


class Side(NamedTuple):
    """What computes the start and each step: ``start(colour, poses) -> state`` and
    ``cycle(colour, depth, texture, state) -> state``; colour (S, 3, H, W) and depth (S,
    H, W) are the sequences' frames, texture the slots' matches (keyframe points (B, K, 3)
    in the body frame, image points (B, K, 2), valid (B, K)), states (poses (B, 4, 4),
    histogram_f (B, n), histogram_b (B, n))."""

    start: object
    cycle: object


class Slots(NamedTuple):
    """A sequence's slots, in order (each a list of J entries): the object, the sphere of
    the object and whether it is the object's primary slot; ``group`` the index of the
    object's primary slot."""

    object: list
    sphere: list
    primary: list
    group: list


def slots(config: dict) -> Slots:
    rows = [(o, k) for o, obj in enumerate(config["objects"])
            for k in range(len(obj["spheres_m"]))]
    first = {}
    for j, (o, _) in enumerate(rows):
        first.setdefault(o, j)
    return Slots([o for o, _ in rows], [k for _, k in rows], [k == 0 for _, k in rows],
                 [first[o] for o, _ in rows])


def slot_models(config: dict) -> tuple[list, list]:
    """Each slot's region model (its sphere's, off the body's origin where the body has
    several) and depth model (its body's: the union of its spheres), as numpy arrays
    (harness/multi_sphere.py); equal models are one object."""
    layout = slots(config)
    region, depth = {}, {}
    region_rows, depth_rows = [], []
    for o, k in zip(layout.object, layout.sphere):
        spheres = config["objects"][o]["spheres_m"]
        key = tuple(spheres[k])
        if key not in region:
            region[key] = multi_sphere.offset_sphere_region_model(config, key)
        region_rows.append(region[key])
        key = tuple(map(tuple, spheres))
        if key not in depth:
            depth[key] = multi_sphere.union_depth_model(config, spheres)
        depth_rows.append(depth[key])
    return region_rows, depth_rows


class Scene(NamedTuple):
    """One traffic mix made from a seed.  ``colour`` (F, S, 3, H, W) uint8 and ``depth``
    (F, S, H, W) uint16: each of the S sequences has a ring of F frames of its own.
    ``truth`` (F, S, NO, 3): each object's position in each frame.  ``start`` (S, NO, 4,
    4): the objects' initial poses.  ``texture`` (F, S, NO, KV, 2) image points of each
    object's ``points`` (S, NO, KV, 3) (body frame) in each frame."""

    colour: torch.Tensor
    depth: torch.Tensor
    truth: np.ndarray
    start: np.ndarray
    points: np.ndarray
    texture: np.ndarray


def _spheres(config: dict):
    """(object of each sphere (K,), sphere centres in their body's frame (K, 3), colours
    (K, 3)) of the scene, object by object."""
    owner, centres, colours = [], [], []
    for o, obj in enumerate(config["objects"]):
        owner += [o] * len(obj["spheres_m"])
        centres += obj["spheres_m"]
        colours += obj["colours_bgr"]
    return np.asarray(owner), np.asarray(centres, np.float64), np.asarray(colours,
                                                                        np.float32)


def _project(config: dict, points):
    fu, fv, ppu, ppv = cycle.intrinsics(config)
    return np.stack([points[..., 0] * fu / points[..., 2] + ppu,
                     points[..., 1] * fv / points[..., 2] + ppv], -1)


def keyframe_points(config: dict, rng, places, n_valid: int, candidates: int = 2048):
    """(S, NO, n_valid, 3) body-frame points on each object's surface that the camera
    sees at the objects' places (S, NO, 3) (identity rotations): facing the camera and
    hidden by no other sphere of the scene, drawn from ``rng``."""
    owner, centres, _ = _spheres(config)
    r = float(config["body_radius"])
    world = places[:, owner] + centres                                # (S, K, 3)
    s, n_objects = places.shape[:2]
    out = np.zeros((s, n_objects, n_valid, 3))
    for o in range(n_objects):
        mine = np.flatnonzero(owner == o)
        which = rng.integers(0, len(mine), (s, candidates))
        direction = rng.normal(size=(s, candidates, 3))
        direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
        sphere = mine[which]                                          # (S, C)
        on = centres[sphere] + r * direction                          # body frame
        camera_frame = places[:, o, None] + on
        seen = (direction * -camera_frame).sum(-1) > 0.0
        for other in range(len(owner)):
            blocked = multi_sphere.hidden(np.zeros(3), camera_frame, world[:, other, None],
                                          r)
            seen &= ~(blocked & (sphere != other))
        if (seen.sum(1) < n_valid).any():
            raise RuntimeError(f"object {o} shows fewer than {n_valid} points")
        order = np.argsort(~seen, axis=1, kind="stable")[:, :n_valid]
        out[:, o] = np.take_along_axis(on, order[..., None], 1)
    return out


def scene(traffic: dict, config: dict, seed: int, device) -> Scene:
    """The frames, truths, initial poses and texture matches of a traffic mix.

    Sequence n's objects sit at ``offset_m``-uniform x/y offsets (one for the whole
    scene) from their places in the configuration and move ``step_m`` along x per frame.
    An object's initial pose is frame 0's with a ``jitter_m``-uniform x/y error of its
    own.  The texture matches: ``texture_valid`` keyframe points per object, their image
    points the projections in each frame plus ``texture_noise_px`` Gaussian noise, of
    which ``texture_outlier_share`` are uniform within the object's crop."""
    rng, device_seed = generator.seeded(seed)
    n, n_frames = traffic["batch"], traffic["ring_frames"]
    objects = config["objects"]
    n_objects = len(objects)
    offsets = np.zeros((n, 3))
    offsets[:, :2] = rng.uniform(-traffic["offset_m"], traffic["offset_m"], (n, 2))
    jitter = np.zeros((n, n_objects, 3))
    jitter[..., :2] = rng.uniform(-traffic["jitter_m"], traffic["jitter_m"],
                                  (n, n_objects, 2))
    motion = np.arange(n_frames)[:, None, None, None] * np.asarray(traffic["step_m"])
    place = np.asarray([obj["position_m"] for obj in objects], np.float64)
    truth = place + offsets[:, None] + motion                          # (F, S, NO, 3)
    start = np.tile(np.eye(4, dtype=np.float32), (n, n_objects, 1, 1))
    start[..., :3, 3] = truth[0] + jitter

    owner, centres, colours = _spheres(config)
    generator_ = torch.Generator(device=device).manual_seed(device_seed)
    balls = torch.as_tensor((truth[:, :, owner] + centres).reshape(n_frames * n, -1, 3),
                            dtype=torch.float32, device=device)
    colour, depth = generator.render(
        balls, config["body_radius"], colours, cycle.intrinsics(config), config["width"],
        config["height"], traffic["noise"], generator_, config["depth_scale"],
        config["background_depth"])
    colour = colour.reshape((n_frames, n) + colour.shape[1:])
    depth = depth.reshape((n_frames, n) + depth.shape[1:])

    kv = int(config["texture_valid"])
    points = keyframe_points(config, rng, truth[0], kv)              # (S, NO, KV, 3)
    texture = _project(config, points[None] + truth[:, :, :, None])
    texture += rng.normal(0.0, config["texture_noise_px"], texture.shape)
    n_out = int(round(config["texture_outlier_share"] * kv))
    centre = _project(config, truth)                                   # (F, S, NO, 2)
    half = 0.5 * config["crop_size"]
    low = np.maximum(centre - half, 0.0)
    high = np.minimum(centre + half, [config["width"] - 1, config["height"] - 1])
    which = np.argsort(rng.random(texture.shape[:-1]), axis=-1)[..., :n_out]
    span = (high - low)[..., None, :]
    uniform = low[..., None, :] + rng.random(which.shape + (2,)) * span
    np.put_along_axis(texture, np.repeat(which[..., None], 2, -1), uniform, -2)
    return Scene(colour, depth, truth, start, points, texture)


def pipeline_config(pipeline, region_fn, depth_fn, config: dict):
    """The program's PipelineConfig for the configuration: the region settings, depth
    fusion, the texture terms and measured occlusions on both modalities."""
    pcfg = cycle.pipeline_config(pipeline, region_fn, config)
    return pcfg._replace(
        cfg=pcfg.cfg._replace(measured_occlusion_radius=config["measured_occlusion_radius"],
                              measured_occlusion_threshold=config[
                                  "measured_occlusion_threshold"]),
        crop_size=int(config["crop_size"]),
        use_depth=True,
        depth_cfg=depth_fn.DepthConfig(
            n_points_max=config["n_points"], stride_length=config["stride_length"],
            measured_occlusion_radius=config["depth_measured_occlusion_radius"],
            measured_occlusion_threshold=config["depth_measured_occlusion_threshold"]),
        considered_distances=tuple(config["considered_distances"]),
        depth_standard_deviations=tuple(config["depth_standard_deviations"]),
        use_texture=True,
        texture_standard_deviations=tuple(config["texture_standard_deviations"]),
        tukey_norm_constant=config["tukey_norm_constant"],
        region_measure_occlusions=config["region_measure_occlusions"],
        depth_measure_occlusions=config["depth_measure_occlusions"])


def program_side(driver, grouped: bool = True, **changes) -> Side:
    """The program; ``changes`` replace fields of its PipelineConfig and ``grouped``
    False leaves out ``pose_group`` (the CPU tests' faults)."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import depth_fn, region_fn, texture_fn

    config, dev = driver.config, driver.device
    pcfg = pipeline_config(pipeline, region_fn, depth_fn, config)._replace(**changes)
    region_rows, depth_rows = driver.models
    row = torch.as_tensor(driver.slot_row, device=dev)
    # Each slot holds its own copy of its models, as the evaluator's from_models stacks
    # them (one copy of a field that two fields share), with the depth offsets at the
    # measured-occlusion radii (the modalities' offset ids, region_modality.py and
    # depth_modality.py).
    def per_slot(arrays, rows, n: int, offset: int):
        stacked = arrays.from_models([SimpleNamespace(set_up=True, **m) for m in rows], n,
                                     device=dev, measured_offset_id=offset,
                                     modeled_offset_id=offset)
        copies = {}
        return arrays(*(copies.setdefault(id(a), a[row]) for a in stacked))

    region = per_slot(pipeline.RegionModelArrays, region_rows, config["n_lines"],
                      offset_id(config["measured_occlusion_radius"],
                                config["region_model"]))
    depth = per_slot(pipeline.DepthModelArrays, depth_rows, config["n_points"],
                     offset_id(config["depth_measured_occlusion_radius"],
                               config["depth_model"]))
    group = torch.as_tensor(driver.group, device=dev) if grouped else None
    n_points = torch.as_tensor(driver.n_points, dtype=torch.int32, device=dev)
    seq = torch.as_tensor(driver.slot_seq, device=dev)
    intr, depth_scale = driver.intr, float(config["depth_scale"])

    def start(colour, poses):
        return pipeline.initialize_histograms(pcfg, intr, colour.index_select(0, seq),
                                              region, poses)

    def step(colour, depth_frames, texture, state):
        return pipeline.tracking_cycle_rgbd(
            pcfg, intr, intr, depth_scale, colour.index_select(0, seq),
            depth_frames.index_select(0, seq), region, depth, state,
            texture_points=texture_fn.TexturePoints(*texture), pose_group=group,
            depth_n_points=n_points)

    return Side(start, step)


def offset_id(radius: float, model: dict) -> int:
    """The depth offset a modality reads for a check of ``radius``."""
    return min(int(radius / model["stride_depth_offset"] + 0.5), 29)


def reference_side(driver, tf32: bool = False) -> Side:
    """The plain reference, in float32 or (tf32) with its matmuls in TF32."""
    from benchmark.reference import rgbd

    config, dev = driver.config, driver.device
    settings = rgbd.Settings.from_config(config)
    models_ = rgbd.Models.from_arrays(settings, *driver.models, dev)
    layout = rgbd.Layout.from_slots(driver.layout.group, driver.n_points[:driver.j], dev)

    def precision():
        return check.TF32Matmuls() if tf32 else contextlib.nullcontext()

    def start(colour, poses):
        with precision():
            return rgbd.start(settings, layout, models_, colour, poses)

    def step(colour, depth_frames, texture, state):
        with precision():
            return rgbd.cycle(settings, layout, models_, colour, depth_frames,
                              rgbd.Texture(*texture), tuple(state))

    return Side(start, step)


class Driver(ClosedLoop):
    def __init__(self, cell, config, traffic, seed, device, side=None):
        super().__init__(cell, config, traffic, seed, device, side)
        self.n = traffic["batch"]
        self.layout = slots(config)
        self.j = len(self.layout.object)
        self.n_objects = len(config["objects"])
        self.units_per_step = self.n * self.n_objects
        self.intr = cycle.intrinsics(config)
        index = np.arange(self.n * self.j)
        self.slot_seq = index // self.j
        self.slot_row = index % self.j
        self.group = self.slot_seq * self.j + np.asarray(self.layout.group)[self.slot_row]
        primary = np.asarray(self.layout.primary)[self.slot_row]
        self.n_points = np.where(primary, int(config["n_points"]), 0)
        self.primary = np.flatnonzero(primary)                       # (S * NO,)
        self.models = slot_models(config)

    def texture(self, frame: int) -> tuple:
        """The slots' texture matches in a ring frame: each object's points on its
        primary slot, the other slots' rows invalid."""
        return self.tex_points, self.tex_uv[frame], self.tex_valid

    def _texture_rows(self) -> None:
        k, kv = int(self.config["texture_rows"]), int(self.config["texture_valid"])
        b = self.n * self.j
        f = self.traffic["ring_frames"]
        points = np.zeros((b, k, 3), np.float32)
        uv = np.zeros((f, b, k, 2), np.float32)
        valid = np.zeros((b, k), bool)
        points[self.primary, :kv] = self.seq.points.reshape(-1, kv, 3)
        uv[:, self.primary, :kv] = self.seq.texture.reshape(f, -1, kv, 2)
        valid[self.primary, :kv] = True
        dev = self.device
        self.tex_points = torch.as_tensor(points, device=dev)
        self.tex_uv = torch.as_tensor(uv, device=dev)
        self.tex_valid = torch.as_tensor(valid, device=dev)

    def setup(self) -> None:
        self.seq = scene(self.traffic, self.config, self.seed, self.device)
        self._texture_rows()
        objects = np.asarray(self.layout.object)
        starts = self.seq.start[:, objects].reshape(-1, 4, 4)        # (B, 4, 4)
        self.poses0 = torch.as_tensor(starts, device=self.device)
        self.side = (self.side_factory or program_side)(self)
        self.start = self.side.start(self.seq.colour[0], self.poses0)
        self.state = self.start
        self.warm_up()
        self.read_capture_s()

    def step(self, traced: bool) -> None:
        index, frame = self.window_step(), self.frame(self.t + 1)
        state_in = self.state
        self.mark("step")
        self.mark("cycle")
        self.state = self.side.cycle(self.seq.colour[frame], self.seq.depth[frame],
                                     self.texture(frame), state_in)
        self.mark("cycle_end")
        positions = self.state[0][:, :3, 3].cpu()[self.primary]
        self.t += 1
        self.record(frame, positions.reshape(self.n, self.n_objects, 3), state_in,
                    self.state, index)

    def outcome(self):
        return super().outcome(self.seq.truth)

    def kernel_work(self) -> dict:
        """The kernels' work in one more cycle, run eagerly from the window's last state
        (after the window): K1 and every K3 call, the measured-occlusion windows
        included."""
        frame = self.frame(self.t + 1)
        with roofline_scene.recorded_calls() as calls:
            self.side.cycle(*self.frame_inputs(frame), self.state)
        return roofline_scene.cycle_work(calls)

    def free(self) -> None:
        self.side = self.state = None
        self.free_program()

    def reference(self) -> Side:
        return reference_side(self)

    def start_inputs(self) -> tuple:
        return self.seq.colour[0], self.poses0

    def frame_inputs(self, frame: int) -> tuple:
        return self.seq.colour[frame], self.seq.depth[frame], self.texture(frame)
