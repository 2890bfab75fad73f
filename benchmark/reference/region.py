"""Plain region tracking: one M3T tracking cycle of a rigid body from a colour frame.

Written from what M3T's RegionModality, Optimizer and ColorHistograms do, in plain
PyTorch, for a batch of bodies (leading dimension B) and their contour lines (L):

- the closest view of the region model (region_model.cpp:105-127);
- per correspondence iteration, at its scale: each line projected into the image, its
  pixels walked along the dominant axis of its normal, each pixel's foreground share
  from the two colour histograms, the pixels multiplied into segments, the segments
  into the distribution of the contour's position along the line, and its moments
  (region_modality.cpp:390-465, 1231-1291, 1433-1658);
- per update iteration: the gradient and Hessian of the lines' log-likelihood in the
  body frame (cpp:485-558) and the Tikhonov-regularised Newton step, applied on the
  right of the pose (optimizer.cpp:144-167, link.cpp:236-238);
- at the final pose, the colours along each contour normal, inward into the foreground
  and outward into the background, counted into the histograms at their learning rates
  (cpp:1025-1155, color_histograms.cpp:61-69, 187-195).

The image is read whole, where the program reads crops around each body.  Nothing here
comes from the program: ``Settings`` and ``Model`` are built from the configuration file
and from the arrays the benchmark makes (``harness/models.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Bodies computed together: bounds the per-pixel temporaries.
BLOCK = 128


class Settings(NamedTuple):
    """A configuration's tracking settings and camera."""

    n_lines: int
    scales: tuple
    standard_deviations: tuple
    n_corr_iterations: int
    n_update_iterations: int
    function_length: int
    distribution_length: int
    function_amplitude: float
    function_slope: float
    learning_rate: float
    n_global_iterations: int
    min_continuous_distance: float
    n_histogram_bins: int
    unconsidered_line_length: float
    max_considered_line_length: float
    learning_rate_f: float
    learning_rate_b: float
    tikhonov_rotation: float
    tikhonov_translation: float
    fu: float
    fv: float
    ppu: float
    ppv: float
    width: int
    height: int

    @staticmethod
    def from_config(config: dict) -> "Settings":
        return Settings(**{name: (tuple(config[name]) if isinstance(config[name], list)
                                  else config[name]) for name in Settings._fields})

    def iteration(self, corr_iteration: int) -> tuple[int, float]:
        """(scale, standard deviation) of a correspondence iteration: the last of each
        list repeats."""
        i = min(corr_iteration, len(self.scales) - 1)
        j = min(corr_iteration, len(self.standard_deviations) - 1)
        return int(self.scales[i]), float(self.standard_deviations[j])

    def step_function(self) -> tuple[list, list]:
        """The smoothed step's foreground and background values along its
        ``function_length`` positions (region_modality.cpp:910-923)."""
        half = (self.function_length - 1) / 2.0
        f = [0.5 - self.function_amplitude * math.tanh((i - half) / (2.0 * self.function_slope))
             for i in range(self.function_length)]
        return f, [1.0 - x for x in f]

    def min_variance(self) -> float:
        """The least variance a line's distribution is given (cpp:931-935)."""
        laplace = 1.0 / (2.0 * math.atanh(2.0 * self.function_amplitude) ** 2)
        return max(laplace, self.function_slope)


class Model(NamedTuple):
    """The region model on the device: views (V, 3), points (V, N, 3), distances (V, N)."""

    orientations: torch.Tensor
    centers: torch.Tensor
    normals: torch.Tensor
    foreground_distances: torch.Tensor
    background_distances: torch.Tensor

    @staticmethod
    def from_arrays(arrays: dict, device) -> "Model":
        return Model(*(torch.as_tensor(arrays[name], dtype=torch.float32, device=device)
                       for name in Model._fields))


class Lines(NamedTuple):
    """The closest view's contour points at a pose, projected: (B, L) unless noted."""

    center: torch.Tensor       # (B, L, 3) body frame
    u: torch.Tensor
    v: torch.Tensor
    nu: torch.Tensor           # unit image normal
    nv: torch.Tensor
    z: torch.Tensor
    foreground: torch.Tensor   # metres
    background: torch.Tensor
    valid: torch.Tensor        # line index, depth and centre pixel


def closest_view(model: Model, pose):
    """(B,) index of the view whose camera direction best matches the body's."""
    t = pose[:, :3, 3]
    towards = t / torch.linalg.vector_norm(t, dim=1, keepdim=True)
    in_body = (pose[:, :3, :3].transpose(1, 2) @ towards[:, :, None])[:, :, 0]
    return torch.argmax(in_body @ model.orientations.T, dim=1)


def project(s: Settings, model: Model, pose) -> Lines:
    view = closest_view(model, pose)
    center = model.centers[view, :s.n_lines]
    normal = model.normals[view, :s.n_lines]
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
    return Lines(center, u, v, n2[..., 0], n2[..., 1], z,
                 model.foreground_distances[view, :s.n_lines],
                 model.background_distances[view, :s.n_lines], valid)


def pixel_bins(s: Settings, images):
    """(B, H, W) int64 histogram bin of every pixel of planar (B, 3, H, W) uint8 frames:
    each channel's top bits, in the frame's channel order."""
    n = s.n_histogram_bins
    shift = 8 - (n.bit_length() - 1)
    c = images.to(torch.int64) >> shift
    return (c[:, 0] * n + c[:, 1]) * n + c[:, 2]


def _at(bins, u, v):
    """bins[b, v, u] for integer (B, ...) coordinates, clamped into the frame."""
    b, h, w = bins.shape
    u = u.clamp(0, w - 1).long()
    v = v.clamp(0, h - 1).long()
    flat = bins.reshape(b, -1)
    return torch.gather(flat, 1, (v * w + u).reshape(b, -1)).reshape(u.shape)


class Correspondence(NamedTuple):
    """A line's distribution at one scale, and what its step reads: (B, L) unless noted."""

    distribution: torch.Tensor   # (B, L, D)
    mean: torch.Tensor
    variance: torch.Tensor
    delta_r: torch.Tensor
    per_scale: torch.Tensor      # |dominant normal component| / scale
    valid: torch.Tensor


def correspondences(s: Settings, lines: Lines, bins, hist_f, hist_b, scale: int):
    n_seg = s.function_length + s.distribution_length - 1
    length = n_seg * scale
    horizontal = lines.nv.abs() < lines.nu.abs()
    along = torch.where(horizontal, lines.nu, lines.nv)
    across = torch.where(horizontal, lines.nv, lines.nu)
    c_along = torch.where(horizontal, lines.u, lines.v)
    c_across = torch.where(horizontal, lines.v, lines.u)
    size_along = torch.where(horizontal, s.width, s.height)
    size_across = torch.where(horizontal, s.height, s.width)
    nonzero = along != 0
    slope = across / torch.where(nonzero, along, torch.ones_like(along))

    # The line's pixels: one per step along the dominant axis, the other coordinate
    # truncated from the line through the centre.
    first = torch.trunc(c_along - (length / 2.0 - 1.0))
    across_0 = c_across + slope * (first - c_along) + 0.5
    k = torch.arange(length, device=bins.device, dtype=torch.float32)
    a = first[..., None] + k
    b = torch.trunc(across_0[..., None] + k * slope[..., None])
    end = torch.trunc(across_0 + (length - 1) * slope)
    inside = ((first >= 0) & (first + length - 1 <= size_along - 1)
              & (torch.trunc(across_0) >= 0) & (torch.trunc(across_0) <= size_across - 1)
              & (end >= 1) & (end <= size_across - 2))
    distance = torch.minimum(lines.foreground, lines.background) * s.fu / (
        torch.where(lines.z > 0, lines.z, torch.ones_like(lines.z)) * scale)
    valid = lines.valid & nonzero & inside & (distance >= s.min_continuous_distance)

    horizontal_k = horizontal[..., None]
    pix = _at(bins, torch.where(horizontal_k, a, b), torch.where(horizontal_k, b, a))
    f = torch.gather(hist_f, 1, pix.reshape(pix.shape[0], -1)).reshape(pix.shape)
    g = torch.gather(hist_b, 1, pix.reshape(pix.shape[0], -1)).reshape(pix.shape)
    total = f + g
    some = total > 0
    safe = torch.where(some, total, torch.ones_like(total))
    p_f = torch.where(some, f / safe, torch.full_like(f, 0.5))
    p_b = torch.where(some, g / safe, torch.full_like(g, 0.5))

    # Segments of ``scale`` pixels; a line whose normal points against the walk fills
    # them from the far end.
    shape = p_f.shape[:-1] + (n_seg, scale)
    seg_f = p_f.reshape(shape).prod(-1)
    seg_b = p_b.reshape(shape).prod(-1)
    backwards = (along < 0)[..., None]
    seg_f = torch.where(backwards, seg_f.flip(-1), seg_f)
    seg_b = torch.where(backwards, seg_b.flip(-1), seg_b)
    if scale > 1:
        total = seg_f + seg_b
        some = total > 0
        safe = torch.where(some, total, torch.ones_like(total))
        seg_f = torch.where(some, seg_f / safe, torch.full_like(seg_f, 0.5))
        seg_b = torch.where(some, seg_b / safe, torch.full_like(seg_b, 0.5))

    step_f, step_b = s.step_function()
    dist = None
    for i in range(s.function_length):
        term = (seg_f[..., i:i + s.distribution_length] * step_f[i]
                + seg_b[..., i:i + s.distribution_length] * step_b[i])
        dist = term if dist is None else dist * term
    area = dist.sum(-1, keepdim=True)
    dist = dist / torch.where(area > 0, area, torch.ones_like(area))
    position = torch.arange(s.distribution_length, device=bins.device, dtype=torch.float32)
    mean_from_first = (dist * position).sum(-1)
    variance = (dist * (position - mean_from_first[..., None]) ** 2).sum(-1)
    half = (length - 1) / 2.0
    delta_r = (torch.floor(c_along - half + 0.5) + half - c_along) / torch.where(
        nonzero, along, torch.ones_like(along))
    return Correspondence(dist, mean_from_first - (s.distribution_length - 1) / 2.0,
                          variance.clamp(min=s.min_variance()), delta_r,
                          along.abs() / scale, valid)


def gradient_hessian(s: Settings, lines: Lines, corr: Correspondence, pose,
                     deviation: float, global_step: bool):
    """((B, 6), (B, 6, 6)) of the lines' log-likelihood over the body-frame twist
    (rotation first)."""
    rot, t = pose[:, :3, :3], pose[:, :3, 3]
    cam = lines.center @ rot.transpose(1, 2) + t[:, None]
    x, y, z = cam.unbind(-1)
    zs = torch.where(z != 0, z, torch.ones_like(z))
    fu_z, fv_z = s.fu / zs, s.fv / zs
    delta_cs = (lines.nu * (x * fu_z + s.ppu - lines.u)
                + lines.nv * (y * fv_z + s.ppv - lines.v) - corr.delta_r) * corr.per_scale
    if global_step:
        slope = (corr.mean - delta_cs) / corr.variance
        use = corr.valid
    else:
        upper = torch.trunc(delta_cs + (s.distribution_length + 1) / 2.0).long()
        use = corr.valid & (upper > 0) & (upper < s.distribution_length)
        upper = upper.clamp(1, s.distribution_length - 1)
        p_up = torch.gather(corr.distribution, -1, upper[..., None])[..., 0]
        p_low = torch.gather(corr.distribution, -1, upper[..., None] - 1)[..., 0]
        slope = (torch.log(p_up) - torch.log(p_low)) * s.learning_rate / corr.variance
    d_cam = corr.per_scale[..., None] * torch.stack(
        [lines.nu * fu_z, lines.nv * fv_z,
         -(lines.nu * x * fu_z + lines.nv * y * fv_z) / zs], dim=-1)
    d_trans = d_cam @ rot
    jac = torch.cat([torch.linalg.cross(lines.center, d_trans, dim=-1), d_trans], dim=-1)
    weight = s.min_variance() / (corr.per_scale ** 2 * deviation ** 2)
    weight = torch.where(use, weight, torch.zeros_like(weight))
    weight_slope = torch.where(use, weight * slope, torch.zeros_like(weight))
    gradient = torch.einsum("bl,bli->bi", weight_slope, jac)
    hessian = -(jac.transpose(1, 2) @ (jac * (weight / corr.variance)[..., None]))
    return gradient, hessian


def rotation(w):
    """(B, 3, 3) rotation by the angle-axis vectors w (B, 3)."""
    angle = torch.linalg.vector_norm(w, dim=1)
    axis = w / torch.where(angle > 0, angle, torch.ones_like(angle))[:, None]
    c, s = torch.cos(angle)[:, None, None], torch.sin(angle)[:, None, None]
    x, y, z = axis.unbind(1)
    zero = torch.zeros_like(x)
    cross = torch.stack([torch.stack([zero, -z, y], 1), torch.stack([z, zero, -x], 1),
                         torch.stack([-y, x, zero], 1)], 1)
    eye = torch.eye(3, device=w.device, dtype=w.dtype)
    return c * eye + s * cross + (1 - c) * axis[:, :, None] * axis[:, None, :]


def newton_step(s: Settings, gradient, hessian, pose):
    """The pose after one regularised Newton step: pose @ [R(theta_w), theta_t]."""
    tikhonov = torch.tensor([s.tikhonov_rotation] * 3 + [s.tikhonov_translation] * 3,
                            dtype=torch.float32, device=pose.device)
    theta = torch.linalg.solve(torch.diag(tikhonov) - hessian, gradient[..., None])[..., 0]
    theta = torch.where(torch.isfinite(theta).all(1, keepdim=True), theta,
                        torch.zeros_like(theta))
    step = torch.zeros_like(pose)
    step[:, :3, :3] = rotation(theta[:, :3])
    step[:, :3, 3] = theta[:, 3:]
    step[:, 3, 3] = 1.0
    return pose @ step


def colour_counts(s: Settings, lines: Lines, bins):
    """((B, n^3), (B, n^3)) counts of the colours along each line's normal: inward from
    the contour into the foreground, outward into the background."""
    steps = math.ceil(s.max_considered_line_length) + 1
    k = torch.arange(steps, device=bins.device, dtype=torch.float32)
    horizontal = lines.nu.abs() > lines.nv.abs()
    dominant = torch.where(horizontal, lines.nu.abs(), lines.nv.abs())
    safe = torch.where(dominant > 0, dominant, torch.ones_like(dominant))
    du = torch.where(horizontal, torch.sign(lines.nu), lines.nu / safe)
    dv = torch.where(horizontal, lines.nv / safe, torch.sign(lines.nv))
    zs = torch.where(lines.z > 0, lines.z, torch.ones_like(lines.z))
    b, h, w = bins.shape
    n_total = s.n_histogram_bins ** 3
    counts = []
    for sign, metres in ((-1.0, lines.foreground), (1.0, lines.background)):
        reach = torch.clamp(metres * s.fu / zs - 2.0 * s.unconsidered_line_length,
                            max=s.max_considered_line_length)
        n_pixels = torch.trunc(reach * dominant + 0.5)
        u0 = lines.u + sign * lines.nu * s.unconsidered_line_length + 0.5
        v0 = lines.v + sign * lines.nv * s.unconsidered_line_length + 0.5
        pu = torch.trunc(u0[..., None] + sign * k * du[..., None])
        pv = torch.trunc(v0[..., None] + sign * k * dv[..., None])
        inside = (pu >= 0) & (pu <= w - 1) & (pv >= 0) & (pv <= h - 1)
        # The walk ends at the frame's edge.
        inside = torch.cumprod(inside.to(torch.int32), -1).bool()
        keep = inside & (k < n_pixels[..., None]) & lines.valid[..., None]
        pix = torch.where(keep, _at(bins, pu, pv), n_total)
        count = torch.zeros((b, n_total + 1), dtype=torch.float32, device=bins.device)
        count.scatter_add_(1, pix.reshape(b, -1), torch.ones_like(pix.reshape(b, -1),
                                                                  dtype=torch.float32))
        counts.append(count[:, :n_total])
    return counts


def blend(histogram, count, rate: float):
    """The histogram moved towards the normalised counts at ``rate``; with no count,
    uniform at rate 1 and unchanged otherwise."""
    total = count.sum(-1, keepdim=True)
    moved = histogram * (1.0 - rate) + count * (rate / torch.where(total > 0, total,
                                                                   torch.ones_like(total)))
    if rate == 1.0:
        idle = torch.full_like(histogram, 1.0 / histogram.shape[-1])
    else:
        idle = histogram
    return torch.where(total > 0, moved, idle)


def _blocks(n: int):
    return [slice(i, min(i + BLOCK, n)) for i in range(0, n, BLOCK)]


def start(s: Settings, images, model: Model, poses):
    """(poses, histogram_f, histogram_b): the histograms made at the starting poses."""
    hist_f, hist_b = [], []
    for part in _blocks(poses.shape[0]):
        bins = pixel_bins(s, images[part])
        count_f, count_b = colour_counts(s, project(s, model, poses[part]), bins)
        uniform = torch.full_like(count_f, 1.0 / count_f.shape[-1])
        hist_f.append(blend(uniform, count_f, 1.0))
        hist_b.append(blend(uniform, count_b, 1.0))
    return poses, torch.cat(hist_f), torch.cat(hist_b)


def cycle(s: Settings, images, model: Model, state):
    """The state (poses, histogram_f, histogram_b) after one tracking cycle on the frames
    ``images`` (B, 3, H, W) uint8."""
    out = []
    for part in _blocks(state[0].shape[0]):
        pose, hist_f, hist_b = (x[part] for x in state)
        bins = pixel_bins(s, images[part])
        for corr_iteration in range(s.n_corr_iterations):
            scale, deviation = s.iteration(corr_iteration)
            lines = project(s, model, pose)
            corr = correspondences(s, lines, bins, hist_f, hist_b, scale)
            for update in range(s.n_update_iterations):
                gradient, hessian = gradient_hessian(s, lines, corr, pose, deviation,
                                                     update < s.n_global_iterations)
                pose = newton_step(s, gradient, hessian, pose)
        count_f, count_b = colour_counts(s, project(s, model, pose), bins)
        out.append((pose, blend(hist_f, count_f, s.learning_rate_f),
                    blend(hist_b, count_b, s.learning_rate_b)))
    return tuple(torch.cat(parts) for parts in zip(*out))
