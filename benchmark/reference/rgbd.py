"""Plain RGB-D + texture tracking: one M3T tracking cycle of rigid bodies, each made of
one or more region sub-bodies, from colour and depth frames and texture matches.

Written from what M3T's RegionModality, DepthModality, TextureModality, Link and
Optimizer do, in plain PyTorch, for S sequences that show the same layout of bodies: J
slots a sequence, each slot a sub-body with a region model of its own, the slots of one
body summing their terms into the body's one Link (ycb_evaluator.cpp:427-453,
link.cpp:184-193).  A body's depth model and texture matches sit on its primary slot; the
other slots have no depth points and no valid matches.  In blocks of sequences:

- per correspondence iteration, for every slot at its body's pose:
  - its region lines (``reference/region.py``), a line dropped where the depth frame, in
    a strided window ``2 radius`` metres wide around its contour point, holds a depth
    nearer than the point's by more than the threshold (IsLineUnoccludedMeasured,
    region_modality.cpp:1343-1389);
  - its depth points, up to the slot's budget: the closest view's points, each dropped
    in the same way (IsPointUnoccludedMeasured, depth_modality.cpp:736-776), and matched
    to the nearest depth-frame point of a strided window around its projection within
    the considered distance (FindCorrespondence, depth_modality.cpp:826-884);
- per update iteration: each slot's region, point-to-plane and texture gradients and
  Hessians in the body frame (region_modality.cpp:485-558, depth_modality.cpp:333-381,
  texture_modality.cpp:397-444: Tukey's loss of each match's reprojection error over
  its square, over the variance), summed over the body's slots (link.cpp:184-193), the
  Tikhonov-regularised Newton step (optimizer.cpp:144-167), every slot of the body moved
  by it;
- at the final poses each slot's histograms from the colours along its lines, the lines
  that the measured-occlusion check drops left out (AddLinePixelColorsToTempHistograms,
  region_modality.cpp:1025-1155).

The frames are read whole, where the program reads crops around each body.  A line's or
a point's occlusion depth is its own depth less its model's depth offset at the check's
radius (offset ``int(radius / stride_depth_offset + 0.5)``, region_modality.cpp and
depth_modality.cpp) and less the threshold.  Nothing here
comes from the program: ``Settings``, ``Layout`` and ``Models`` are built from the
configuration file and from the arrays the benchmark makes (``harness/models.py``,
``harness/sphere_depth.py``, ``harness/multi_sphere.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import kinematic as kin
from benchmark.reference import region as rr

# Sequences computed together: bounds the per-pixel temporaries.
BLOCK = 8
# Strides of the measured-occlusion windows (region_modality.h:145, depth_modality.h:113).
N_OCCLUSION_STRIDES = 5
# Depth offsets a model point holds (model.h:58).
N_DEPTH_OFFSETS = 30


class Settings(NamedTuple):
    """A configuration's region, depth, occlusion and texture settings and camera."""

    region: rr.Settings
    n_points: int
    stride_length: float
    considered_distances: tuple
    depth_standard_deviations: tuple
    region_occlusion_radius: float
    region_occlusion_threshold: float
    depth_occlusion_radius: float
    depth_occlusion_threshold: float
    texture_standard_deviations: tuple
    tukey_norm_constant: float
    depth_scale: float
    region_offset_id: int
    depth_offset_id: int

    @staticmethod
    def from_config(config: dict) -> "Settings":
        def offset_id(radius: float, model: dict) -> int:
            step = model["stride_depth_offset"]
            return min(int(radius / step + 0.5), N_DEPTH_OFFSETS - 1)

        return Settings(
            rr.Settings.from_config(config), int(config["n_points"]),
            float(config["stride_length"]), tuple(config["considered_distances"]),
            tuple(config["depth_standard_deviations"]),
            float(config["measured_occlusion_radius"]),
            float(config["measured_occlusion_threshold"]),
            float(config["depth_measured_occlusion_radius"]),
            float(config["depth_measured_occlusion_threshold"]),
            tuple(config["texture_standard_deviations"]),
            float(config["tukey_norm_constant"]), float(config["depth_scale"]),
            offset_id(config["measured_occlusion_radius"], config["region_model"]),
            offset_id(config["depth_measured_occlusion_radius"], config["depth_model"]))

    def depth_iteration(self, corr_iteration: int) -> tuple[float, float]:
        """(considered distance, standard deviation) of a correspondence iteration."""
        i = min(corr_iteration, len(self.considered_distances) - 1)
        j = min(corr_iteration, len(self.depth_standard_deviations) - 1)
        return float(self.considered_distances[i]), float(self.depth_standard_deviations[j])

    def texture_deviation(self, corr_iteration: int) -> float:
        i = min(corr_iteration, len(self.texture_standard_deviations) - 1)
        return float(self.texture_standard_deviations[i])


class Layout(NamedTuple):
    """A sequence's J slots: the slot that holds each slot's body (its primary slot) and
    each slot's depth point budget, both (J,) int64."""

    group: torch.Tensor
    n_points: torch.Tensor

    @staticmethod
    def from_slots(group, n_points, device) -> "Layout":
        return Layout(torch.as_tensor(group, dtype=torch.int64, device=device),
                      torch.as_tensor(n_points, dtype=torch.int64, device=device))

    @property
    def j(self) -> int:
        return self.group.shape[0]


class Models(NamedTuple):
    """Each slot's region model (rr.Model fields with a leading J) and depth model
    (kin.DepthModel fields with a leading J), and the depth offsets of their points at
    the measured-occlusion checks' radii, (J, V, L) and (J, V, P)."""

    region: rr.Model
    depth: kin.DepthModel
    region_offsets: torch.Tensor
    depth_offsets: torch.Tensor

    @staticmethod
    def from_arrays(s: Settings, region_rows, depth_rows, device) -> "Models":
        def stack(rows, name):
            return torch.stack([torch.as_tensor(r[name], dtype=torch.float32, device=device)
                                for r in rows])

        return Models(rr.Model(*(stack(region_rows, f) for f in rr.Model._fields)),
                      kin.DepthModel(*(stack(depth_rows, f)
                                       for f in kin.DepthModel._fields)),
                      stack(region_rows, "depth_offsets")[..., s.region_offset_id],
                      stack(depth_rows, "depth_offsets")[..., s.depth_offset_id])


class Texture(NamedTuple):
    """Each slot's texture matches: keyframe points (B, K, 3) in the body frame, their
    matched image points (B, K, 2) and which are matches (B, K)."""

    points: torch.Tensor
    image_uv: torch.Tensor
    valid: torch.Tensor


def _view(orientations, row, pose):
    """(B,) index of the view of model row ``row`` (B,) whose camera direction best
    matches the body's (region_model.cpp:105-127)."""
    t = pose[:, :3, 3]
    towards = t / torch.linalg.vector_norm(t, dim=1, keepdim=True)
    in_body = (pose[:, :3, :3].transpose(1, 2) @ towards[:, :, None])   # (B, 3, 1)
    return torch.argmax((orientations[row] @ in_body)[..., 0], dim=1)


def project(s: rr.Settings, model: rr.Model, row, pose) -> tuple[rr.Lines, torch.Tensor]:
    """The closest view's contour points of each slot's region model (row ``row`` (B,))
    at its pose, projected (``reference/region.py``'s ``project``), and the view's index
    (B,)."""
    view = _view(model.orientations, row, pose)
    center = model.centers[row, view, :s.n_lines]
    normal = model.normals[row, view, :s.n_lines]
    rot, t = pose[:, :3, :3], pose[:, :3, 3]
    cam = center @ rot.transpose(1, 2) + t[:, None]
    z = cam[..., 2]
    zs = torch.where(z > 0, z, torch.ones_like(z))
    u = s.fu * cam[..., 0] / zs + s.ppu
    v = s.fv * cam[..., 1] / zs + s.ppv
    n2 = (normal @ rot.transpose(1, 2))[..., :2]
    length = torch.linalg.vector_norm(n2, dim=-1)
    n2 = n2 / torch.where(length > 0, length, torch.ones_like(length))[..., None]
    iu, iv = torch.trunc(u + 0.5), torch.trunc(v + 0.5)
    valid = ((z > 0) & (iu >= 0) & (iu <= s.width - 1) & (iv >= 0) & (iv <= s.height - 1))
    return rr.Lines(center, u, v, n2[..., 0], n2[..., 1], z,
                    model.foreground_distances[row, view, :s.n_lines],
                    model.background_distances[row, view, :s.n_lines], valid), view


def _depth_at(depth_frames, frame_of, rows, cols):
    """Raw depth values (float32) of frames (S, H, W) uint16 at integer-valued pixels
    (B, ...), each slot reading its sequence's frame ``frame_of`` (B,); a pixel outside
    the frame (a window's sample past its last, which the caller masks) reads the
    nearest edge."""
    _, h, w = depth_frames.shape
    frame = frame_of.reshape((-1,) + (1,) * (rows.dim() - 1)).expand(rows.shape)
    raw = depth_frames.view(torch.int16)[frame, rows.long().clamp(0, h - 1),
                                         cols.long().clamp(0, w - 1)]
    return (raw.to(torch.int32) & 0xFFFF).to(torch.float32)


def measured_unoccluded(s: Settings, depth_frames, frame_of, u, v, z, offset,
                        radius: float, threshold: float):
    """(B, N) bool: no sample of the depth frame in the strided window ``2 radius``
    metres wide around each point's (u, v) (B, N) at depth z lies nearer than ``z -
    offset - threshold`` (a sample of 0 is no measurement)."""
    r = s.region
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    diameter = 2.0 * radius * r.fu / z_safe
    rows, cols, ok = kin._samples(*kin._window(diameter, N_OCCLUSION_STRIDES, u, v, r.width,
                                               r.height), N_OCCLUSION_STRIDES + 1)
    d = _depth_at(depth_frames, frame_of, rows, cols)
    limit = ((z - offset - threshold) / s.depth_scale)[..., None, None]
    occluding = ok & (d > 0) & (d < limit)
    return ~occluding.flatten(-2).any(-1)


def depth_view(models: Models, row, pose, n_points: int):
    """(centers, normals) (B, P, 3) and depth offsets (B, P) of each slot's depth model's
    closest view."""
    model = models.depth
    view = _view(model.orientations, row, pose)
    return (model.centers[row, view, :n_points], model.normals[row, view, :n_points],
            models.depth_offsets[row, view, :n_points])


def depth_correspondences(s: Settings, models: Models, row, budget, pose, depth_frames,
                          frame_of, corr_iteration: int) -> kin.DepthPoints:
    """Each point of the closest view under the slot's budget (B,), projected, checked
    against measured occlusions and matched to the nearest depth-frame point of its
    window within the considered distance."""
    r = s.region
    cd, _ = s.depth_iteration(corr_iteration)
    center, normal, offset = depth_view(models, row, pose, s.n_points)
    cam = center @ pose[:, :3, :3].transpose(1, 2) + pose[:, None, :3, 3]
    z = cam[..., 2]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    u = cam[..., 0] * r.fu / z_safe + r.ppu
    v = cam[..., 1] * r.fv / z_safe + r.ppv
    iu, iv = torch.trunc(u + 0.5), torch.trunc(v + 0.5)
    index = torch.arange(center.shape[1], device=pose.device)
    valid = ((index < budget[:, None]) & (z > 0) & (iu >= 0) & (iu <= r.width - 1)
             & (iv >= 0) & (iv <= r.height - 1))
    valid = valid & measured_unoccluded(s, depth_frames, frame_of, u, v, z, offset,
                                        s.depth_occlusion_radius,
                                        s.depth_occlusion_threshold)

    max_n_strides = max(int(cd / s.stride_length + 0.5), 1)
    k = max_n_strides + 1
    diameter = 2.0 * cd * (r.fu / z_safe)
    rows, cols, ok = kin._samples(*kin._window(diameter, max_n_strides, u, v, r.width,
                                               r.height), k)
    d = _depth_at(depth_frames, frame_of, rows, cols) * s.depth_scale
    px = (cols - r.ppu) * d / r.fu
    py = (rows - r.ppv) * d / r.fv
    dist2 = ((px - cam[..., 0, None, None]) ** 2 + (py - cam[..., 1, None, None]) ** 2
             + (d - cam[..., 2, None, None]) ** 2)
    usable = ok & (d > 0) & ((d - z[..., None, None]).abs() < cd)
    dist2 = torch.where(usable, dist2, torch.full_like(dist2, math.inf)).flatten(-2)
    best = dist2.argmin(-1, keepdim=True)

    def pick(x):
        return torch.gather(x.flatten(-2), -1, best)[..., 0]

    found = pick(dist2.unflatten(-1, (k, k))) < cd * cd
    correspondence = torch.stack([pick(px), pick(py), pick(d)], -1)
    return kin.DepthPoints(center, normal, correspondence, valid & found)


def texture_gradient_hessian(s: Settings, texture: Texture, pose, deviation: float):
    """((B, 6), (B, 6, 6)) of the matches' robust reprojection log-likelihood over the
    body-frame twist (rotation first): each match weighted by Tukey's loss of its
    reprojection error e over e^2, over the variance."""
    r = s.region
    rot, t = pose[:, :3, :3], pose[:, :3, 3]
    p = texture.points
    cam = p @ rot.transpose(1, 2) + t[:, None]
    x, y, z = cam.unbind(-1)
    front = z > 1e-6
    zs = torch.where(front, z, torch.ones_like(z))
    residual = torch.stack([r.fu * x / zs + r.ppu, r.fv * y / zs + r.ppv], -1) - \
        texture.image_uv
    e2 = (residual * residual).sum(-1)
    e = torch.sqrt(e2)
    c = s.tukey_norm_constant
    loss = torch.where(e <= c, c * c / 6.0 * (1.0 - (1.0 - (e / c) ** 2) ** 3),
                       torch.full_like(e, c * c / 6.0))
    weight = torch.where(e > 1e-30, loss / e2.clamp_min(1e-30), torch.ones_like(e))
    weight = torch.where(front & texture.valid, weight / deviation ** 2,
                         torch.zeros_like(weight))
    # d(u, v)/d(camera point), then through the point's twist: dX = R (w x p + v).
    zero = torch.zeros_like(zs)
    d_cam = torch.stack([torch.stack([r.fu / zs, zero, -r.fu * x / (zs * zs)], -1),
                         torch.stack([zero, r.fv / zs, -r.fv * y / (zs * zs)], -1)], -2)
    d_trans = d_cam @ rot[:, None]                                   # (B, K, 2, 3)
    d_rot = -d_trans @ kin._skew(p)
    jac = torch.cat([d_rot, d_trans], -1)                            # (B, K, 2, 6)
    gradient = -torch.einsum("bk,bkc,bkci->bi", weight, residual, jac)
    hessian = -torch.einsum("bk,bkci,bkcj->bij", weight, jac, jac)
    return gradient, hessian


def _blocks(n: int):
    return [slice(i, min(i + BLOCK, n)) for i in range(0, n, BLOCK)]


def _slot_frames(layout: Layout, n_sequences: int, device):
    """(B,) the sequence of each of the block's slots."""
    return torch.arange(n_sequences, device=device).repeat_interleave(layout.j)


def start(s: Settings, layout: Layout, models: Models, colour, poses):
    """(poses, histogram_f, histogram_b): every slot's histograms made at its starting
    pose (B, 4, 4); colour (S, 3, H, W) uint8, the sequences' frames."""
    hist_f, hist_b = [], []
    j = layout.j
    for part in _blocks(colour.shape[0]):
        n = part.stop - part.start
        frame_of = _slot_frames(layout, n, poses.device)
        row = torch.arange(j, device=poses.device).repeat(n)
        bins = rr.pixel_bins(s.region, colour[part])[frame_of]
        lines, _ = project(s.region, models.region, row,
                           poses[part.start * j:part.stop * j])
        count_f, count_b = rr.colour_counts(s.region, lines, bins)
        uniform = torch.full_like(count_f, 1.0 / count_f.shape[-1])
        hist_f.append(rr.blend(uniform, count_f, 1.0))
        hist_b.append(rr.blend(uniform, count_b, 1.0))
    return poses, torch.cat(hist_f), torch.cat(hist_b)


def _cycle_block(s: Settings, layout: Layout, models: Models, colour, depth_frames,
                 texture: Texture, state):
    r = s.region
    pose, hist_f, hist_b = state
    n = colour.shape[0]
    dev = pose.device
    j = layout.j
    frame_of = _slot_frames(layout, n, dev)
    row = torch.arange(j, device=dev).repeat(n)
    budget = layout.n_points.repeat(n)
    group = (torch.arange(n, device=dev) * j).repeat_interleave(j) + layout.group.repeat(n)
    bins = rr.pixel_bins(r, colour)[frame_of]

    def body_sum(x):
        """Each slot's term summed over its body's slots, given to every one of them."""
        return torch.zeros_like(x).index_add_(0, group, x)[group]

    def lines_at(at):
        lines, view = project(r, models.region, row, at)
        offset = models.region_offsets[row, view, :r.n_lines]
        return lines._replace(valid=lines.valid & measured_unoccluded(
            s, depth_frames, frame_of, lines.u, lines.v, lines.z, offset,
            s.region_occlusion_radius, s.region_occlusion_threshold))

    for corr_iteration in range(r.n_corr_iterations):
        scale, deviation = r.iteration(corr_iteration)
        _, depth_deviation = s.depth_iteration(corr_iteration)
        texture_deviation = s.texture_deviation(corr_iteration)
        lines = lines_at(pose)
        corr = rr.correspondences(r, lines, bins, hist_f, hist_b, scale)
        points = depth_correspondences(s, models, row, budget, pose, depth_frames,
                                       frame_of, corr_iteration)
        for update in range(r.n_update_iterations):
            gradient, hessian = rr.gradient_hessian(r, lines, corr, pose, deviation,
                                                    update < r.n_global_iterations)
            depth_g, depth_h = kin.depth_gradient_hessian(points, pose, depth_deviation)
            tex_g, tex_h = texture_gradient_hessian(s, texture, pose, texture_deviation)
            pose = rr.newton_step(r, body_sum(gradient + depth_g + tex_g),
                                  body_sum(hessian + depth_h + tex_h), pose)
    count_f, count_b = rr.colour_counts(r, lines_at(pose), bins)
    return (pose, rr.blend(hist_f, count_f, r.learning_rate_f),
            rr.blend(hist_b, count_b, r.learning_rate_b))


def cycle(s: Settings, layout: Layout, models: Models, colour, depth_frames,
          texture: Texture, state):
    """The state (poses (B, 4, 4), histogram_f (B, n^3), histogram_b) after one tracking
    cycle on the sequences' frames: colour (S, 3, H, W) uint8, depth_frames (S, H, W)
    uint16; texture the slots' matches."""
    out = []
    j = layout.j
    for part in _blocks(colour.shape[0]):
        slots = slice(part.start * j, part.stop * j)
        out.append(_cycle_block(s, layout, models, colour[part], depth_frames[part],
                                Texture(*(x[slots] for x in texture)),
                                tuple(x[slots] for x in state)))
    return tuple(torch.cat(parts) for parts in zip(*out))
