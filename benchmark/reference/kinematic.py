"""Plain articulated RGB-D tracking: one M3T tracking cycle of kinematic structures from
colour and depth frames.

Written from what M3T's Link, Constraint, Optimizer, RegionModality, DepthModality and
FocusedRenderer do, in plain PyTorch, for a batch of S structures of NL links each (every
link a body with a region and a depth modality, link.cpp:184-193), in blocks of
structures:

- the link poses from the joint state by forward kinematics, ``parent @ joint2parent @
  body2joint`` (link.cpp:228-241), before every correspondence and update iteration;
- per correspondence iteration, for each link:
  - its focused scene (FocusedRenderer::CalculateProjection, renderer.cpp:348-406): a
    square crop around the link's projected bounding sphere, ``focused_image_size``
    pixels a side, in which every link of the structure is a mesh;
  - its region lines (``reference/region.py``), a line dropped where the scene is
    nearer than the line's contour point by more than the threshold anywhere in a
    strided window of the focused image around it (IsLineUnoccludedModeled,
    region_modality.cpp:1391-1431);
  - its depth points: the closest view's points, each dropped where the scene hides it
    in the same way (IsPointUnoccludedModeled, depth_modality.cpp:778-824), and matched
    to the nearest depth-frame point of a strided window around its projection within
    the considered distance (FindCorrespondence, depth_modality.cpp:826-884);
- per update iteration: each link's region and point-to-plane gradients and Hessians in
  its body frame (region_modality.cpp:485-558, depth_modality.cpp:333-381), projected
  through the links' Jacobians onto the free joint coordinates (link.cpp:159-182), and
  the hard constraints' rows (constraint.cpp:176-275): the Tikhonov-regularised KKT
  system in M3T's compacted form, free coordinates and constrained directions only
  (optimizer.cpp:144-167, 304-346), solved, each joint moved on the right
  (link.cpp:228-238);
- at the final poses the histograms of every link (``reference/region.py``).

The scene is evaluated only at the focused pixels that the windows read, which M3T
reads from its focused render: the ray through each such pixel is cast against the
links' meshes, each a convex polyhedron, whose nearest surface along a ray is where the
ray enters it (the scene's depth there, whichever face M3T's rasterizer finds); a mesh
whose bounding sphere none of a link's rays meets is left out of that link's casts.  A
focused pixel (i, j) is the ray through ((i - ppu') / fu', (j - ppv') / fv', 1) of the
focused camera (fu' = fu scale, ppu' = (ppu - corner_u) scale), as the renderer's
projection puts it.  The depth frame is searched whole, where the program reads a crop
around each link.  Nothing here comes from the program: ``Settings``, ``Structure`` and
``Models`` are built from the configuration file and from the arrays the benchmark makes
(``harness/models.py``, ``harness/sphere_depth.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import region as rr

# Structures computed together: bounds the per-pixel temporaries.
BLOCK = 4
# Scene queries cast together: bounds the (link, query, mesh, face) temporaries.
QUERY_BLOCK = 1024
# A ray is cast against a mesh whose bounding sphere, widened by this share, it meets.
SPHERE_MARGIN = 1e-3
# Strides of the modeled-occlusion windows (region_modality.h:145, depth_modality.h:113).
N_OCCLUSION_STRIDES = 5
# FocusedRenderer's margin around the referenced bodies (renderer.cpp:352).
SIZE_MARGIN = 1.05


class Settings(NamedTuple):
    """A configuration's region settings, depth settings, occlusion settings and
    camera."""

    region: rr.Settings
    n_points: int
    stride_length: float
    considered_distances: tuple
    depth_standard_deviations: tuple
    region_occlusion_radius: float
    region_occlusion_threshold: float
    depth_occlusion_radius: float
    depth_occlusion_threshold: float
    focused_image_size: int
    z_min: float
    z_max: float
    depth_scale: float

    @staticmethod
    def from_config(config: dict) -> "Settings":
        return Settings(
            rr.Settings.from_config(config), int(config["n_points"]),
            float(config["stride_length"]), tuple(config["considered_distances"]),
            tuple(config["depth_standard_deviations"]),
            float(config["modeled_occlusion_radius"]),
            float(config["modeled_occlusion_threshold"]),
            float(config["depth_modeled_occlusion_radius"]),
            float(config["depth_modeled_occlusion_threshold"]),
            int(config["focused_image_size"]), float(config["z_min"]),
            float(config["z_max"]), float(config["depth_scale"]))

    def depth_iteration(self, corr_iteration: int) -> tuple[float, float]:
        """(considered distance, standard deviation) of a correspondence iteration."""
        i = min(corr_iteration, len(self.considered_distances) - 1)
        j = min(corr_iteration, len(self.depth_standard_deviations) - 1)
        return float(self.considered_distances[i]), float(self.depth_standard_deviations[j])


class Structure(NamedTuple):
    """A kinematic tree and its hard constraints (the same for every structure)."""

    parent: tuple            # NL parent indices, -1 for the root
    body2joint: torch.Tensor  # (NL, 4, 4)
    free: torch.Tensor       # (NL, 6) bool, [wx wy wz tx ty tz] of the joint frame
    constraints: tuple       # (link1, link2, body12joint1, body22joint2, directions (6,))

    @staticmethod
    def from_config(config: dict, body2joint, device) -> "Structure":
        st = config["structure"]
        eye = torch.eye(4, device=device)
        b2j = torch.as_tensor(body2joint, dtype=torch.float32, device=device)
        return Structure(
            tuple(st["parent"]), b2j,
            torch.as_tensor(st["free"], device=device).bool(),
            tuple((c["link1"], c["link2"], eye, b2j[c["link2"]],
                   torch.as_tensor(c["directions"], device=device).bool())
                  for c in st["constraints"]))

    @property
    def n_links(self) -> int:
        return len(self.parent)


class DepthModel(NamedTuple):
    """The depth model on the device: views (V, 3), points and normals (V, P, 3)."""

    orientations: torch.Tensor
    centers: torch.Tensor
    normals: torch.Tensor


class Models(NamedTuple):
    """The region and depth models of a link, and its mesh: (T, 3, 3) body-frame
    triangles, counter-clockwise seen from outside."""

    region: rr.Model
    depth: DepthModel
    triangles: torch.Tensor

    @staticmethod
    def from_arrays(region: dict, depth: dict, triangles, device) -> "Models":
        return Models(rr.Model.from_arrays(region, device),
                      DepthModel(*(torch.as_tensor(depth[name], dtype=torch.float32,
                                                   device=device)
                                   for name in DepthModel._fields)),
                      torch.as_tensor(triangles, dtype=torch.float32, device=device))


# ----------------------------------------------------------------------------------------
# Poses, kinematics and the KKT step
# ----------------------------------------------------------------------------------------


def _skew(v):
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _inverse(pose):
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(pose)
    out[..., :3, :3] = rot_t
    out[..., :3, 3] = -(rot_t @ pose[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def _adjoint(pose):
    """(..., 6, 6) twist transform of a pose, twists [w, v]: [[R, 0], [[t]x R, R]]."""
    rot, t = pose[..., :3, :3], pose[..., :3, 3]
    out = torch.zeros(pose.shape[:-2] + (6, 6), dtype=pose.dtype, device=pose.device)
    out[..., :3, :3] = rot
    out[..., 3:, 3:] = rot
    out[..., 3:, :3] = _skew(t) @ rot
    return out


def _log(rot):
    """(..., 3) rotation vectors of rotation matrices (angles below pi)."""
    cos = ((rot.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1.0, 1.0)
    angle = torch.arccos(cos)
    axis2 = torch.stack([rot[..., 2, 1] - rot[..., 1, 2], rot[..., 0, 2] - rot[..., 2, 0],
                         rot[..., 1, 0] - rot[..., 0, 1]], -1)       # 2 sin(angle) axis
    sin = torch.sin(angle)
    small = angle < 1e-4
    factor = torch.where(small, 0.5 + angle * angle / 12.0,
                         angle / (2.0 * torch.where(small, torch.ones_like(sin), sin)))
    return factor[..., None] * axis2


def _inverse_left_jacobian(w):
    """(..., 3, 3) inverse of SO(3)'s left Jacobian at rotation vectors w: how the
    rotation vector of exp(dw) R moves with dw (constraint.cpp's variation matrix),
    ``x cot x I - [w / 2]x + (1 - x cot x) / |w|^2 w w^T`` with x = |w| / 2."""
    angle = torch.linalg.vector_norm(w, dim=-1)
    half = 0.5 * angle
    small = angle < 1e-4
    safe = torch.where(small, torch.ones_like(half), half)
    xcot = torch.where(small, 1.0 - half * half / 3.0,
                       safe * torch.cos(safe) / torch.sin(safe))
    outer = torch.where(small, torch.full_like(angle, 1.0 / 12.0),
                        (1.0 - xcot) / torch.where(small, torch.ones_like(angle),
                                                   angle * angle))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (xcot[..., None, None] * eye - _skew(0.5 * w)
            + outer[..., None, None] * (w[..., :, None] * w[..., None, :]))


def _variation(theta):
    """(..., 4, 4) pose variations [R(theta_w), theta_v] of (..., 6) twists."""
    flat = theta.reshape(-1, 6)
    out = torch.zeros((flat.shape[0], 4, 4), dtype=theta.dtype, device=theta.device)
    out[:, :3, :3] = rr.rotation(flat[:, :3])
    out[:, :3, 3] = flat[:, 3:]
    out[:, 3, 3] = 1.0
    return out.reshape(theta.shape[:-1] + (4, 4))


def forward_kinematics(st: Structure, joint2parent):
    """(S, NL, 4, 4) link body2camera poses: the root's parent frame is the camera."""
    poses = []
    for link, parent in enumerate(st.parent):
        pose = joint2parent[:, link] @ st.body2joint[link]
        poses.append(pose if parent < 0 else poses[parent] @ pose)
    return torch.stack(poses, 1)


def _free_coordinates(st: Structure) -> list:
    """(link, direction) of every free coordinate, link by link: M3T's packed theta."""
    return [(link, d) for link in range(st.n_links) for d in range(6)
            if bool(st.free[link, d])]


def link_jacobians(st: Structure, joint2parent):
    """(S, NL, 6, F): each link's body twist per free coordinate (link.cpp:159-182): its
    parent's, carried into its frame, and its own joint's free directions."""
    coords = _free_coordinates(st)
    s = joint2parent.shape[0]
    jac = []
    for link, parent in enumerate(st.parent):
        own = torch.zeros((s, 6, len(coords)), dtype=joint2parent.dtype,
                          device=joint2parent.device)
        joint2body = _adjoint(_inverse(st.body2joint[link]))
        for k, (owner, d) in enumerate(coords):
            if owner == link:
                own[:, :, k] = joint2body[:, d]
        if parent >= 0:
            parent2body = _inverse(joint2parent[:, link] @ st.body2joint[link])
            own = own + _adjoint(parent2body) @ jac[parent]
        jac.append(own)
    return torch.stack(jac, 1)


def constraint_rows(st: Structure, poses, jac):
    """(residual (S, R), rows (S, R, F)) of the hard constraints' constrained directions:
    the joint frames' relative pose ``body12joint1 @ inv(link1) @ link2 @
    inv(body22joint2)`` as rotation vector and translation, and its derivative along the
    free coordinates (constraint.cpp:176-275)."""
    residuals, rows = [], []
    for l1, l2, a, b, dirs in st.constraints:
        rel = a @ _inverse(poses[:, l1]) @ poses[:, l2] @ _inverse(b)
        w, t = _log(rel[:, :3, :3]), rel[:, :3, 3]
        inv_jl = _inverse_left_jacobian(w)
        rot_a, t_a = a[:3, :3], a[:3, 3]
        rot_b, t_b = b[:3, :3], b[:3, 3]
        rot_jb = rel[:, :3, :3] @ rot_b
        # Link 2 moves on the right of the relative pose, link 1 on its left.
        d2 = torch.zeros((rel.shape[0], 6, 6), dtype=rel.dtype, device=rel.device)
        d2[:, :3, :3] = inv_jl @ rot_jb
        d2[:, 3:, :3] = rel[:, :3, :3] @ _skew(t_b) @ rot_b
        d2[:, 3:, 3:] = rot_jb
        d1 = torch.zeros_like(d2)
        d1[:, :3, :3] = -inv_jl @ rot_a
        d1[:, 3:, :3] = _skew(t - t_a) @ rot_a
        d1[:, 3:, 3:] = -rot_a
        full = d2 @ jac[:, l2] + d1 @ jac[:, l1]
        residuals.append(torch.cat([w, t], -1)[:, dirs])
        rows.append(full[:, dirs])
    return torch.cat(residuals, 1), torch.cat(rows, 1)


def kkt_step(s: Settings, st: Structure, joint2parent, gradients, hessians):
    """The joint state after one Newton step: gradients (S, NL, 6) and Hessians (S, NL,
    6, 6) of every link's modalities in its body frame."""
    coords = _free_coordinates(st)
    n = len(coords)
    poses = forward_kinematics(st, joint2parent)
    jac = link_jacobians(st, joint2parent)
    rhs = torch.einsum("slrf,slr->sf", jac, gradients)
    lhs = -torch.einsum("slrf,slrq,slqe->sfe", jac, hessians, jac)
    tikhonov = torch.tensor([s.region.tikhonov_rotation if d < 3
                             else s.region.tikhonov_translation for _, d in coords],
                            dtype=lhs.dtype, device=lhs.device)
    lhs = lhs + torch.diag(tikhonov)
    if st.constraints:
        residual, rows = constraint_rows(st, poses, jac)
        m = rows.shape[1]
        top = torch.cat([lhs, -rows.transpose(1, 2)], 2)
        bottom = torch.cat([-rows, torch.zeros((rows.shape[0], m, m), dtype=lhs.dtype,
                                               device=lhs.device)], 2)
        lhs = torch.cat([top, bottom], 1)
        rhs = torch.cat([rhs, residual], 1)
    theta = torch.linalg.solve(lhs, rhs[..., None])[..., 0][:, :n]
    theta = torch.where(torch.isfinite(theta).all(1, keepdim=True), theta,
                        torch.zeros_like(theta))
    twist = torch.zeros(joint2parent.shape[:2] + (6,), dtype=theta.dtype,
                        device=theta.device)
    for k, (link, d) in enumerate(coords):
        twist[:, link, d] = theta[:, k]
    return joint2parent @ _variation(twist)


# ----------------------------------------------------------------------------------------
# The focused scene
# ----------------------------------------------------------------------------------------


class Focus(NamedTuple):
    """A link's focused camera: (B,) crop corner, scale and whether it shows."""

    corner_u: torch.Tensor
    corner_v: torch.Tensor
    scale: torch.Tensor
    visible: torch.Tensor


def focus(s: Settings, centre, radius: float) -> Focus:
    """The square crop around a body's bounding sphere, centre (B, 3) in the camera
    frame (renderer.cpp:348-406): the sphere's extent in u and in v, its larger side
    times the margin, the crop scaled to ``focused_image_size``."""
    r = s.region
    x, y, z = centre.unbind(-1)
    z2_r2 = (z * z - radius * radius).clamp_min(1e-12)
    half_u = r.fu * (x.abs() * radius * radius + radius * z * torch.sqrt(z2_r2 + x * x)) / (
        z2_r2 * z)
    half_v = r.fv * (y.abs() * radius * radius + radius * z * torch.sqrt(z2_r2 + y * y)) / (
        z2_r2 * z)
    cu, cv = x * r.fu / z + r.ppu, y * r.fv / z + r.ppv
    visible = ((z >= 1.5 * radius) & (z - radius >= s.z_min) & (z + radius <= s.z_max)
               & (cu + half_u >= 0) & (cu - half_u <= r.width)
               & (cv + half_v >= 0) & (cv - half_v <= r.height))
    side = torch.maximum(2.0 * half_u, 2.0 * half_v) * SIZE_MARGIN
    return Focus(cu - 0.5 * side, cv - 0.5 * side, s.focused_image_size / side, visible)


def _relevant_meshes(link_poses, radius: float, rays):
    """(B, NL) bool: which meshes some ray (B, Q, 3) of the link's meets the bounding
    sphere of (radius widened by a margin for the rounding of the test)."""
    centres = link_poses[..., :3, 3]                                   # (B, NL, 3)
    reach = (radius * (1.0 + SPHERE_MARGIN)) ** 2
    met = torch.zeros(centres.shape[:2], dtype=torch.bool, device=centres.device)
    for part in range(0, rays.shape[1], QUERY_BLOCK):
        d = rays[:, part:part + QUERY_BLOCK]                           # (B, q, 3)
        along = d @ centres.transpose(1, 2) / (d * d).sum(-1, keepdim=True)
        closest = along[..., None] * d[:, :, None] - centres[:, None]  # (B, q, NL, 3)
        met |= ((closest * closest).sum(-1) <= reach).any(1)
    return met


def scene_depth(s: Settings, models: Models, link_poses, foc: Focus, fu_px, fv_px):
    """Depth of the nearest mesh at focused pixels (fu_px, fv_px) (B, Q) of each link's
    focused camera, inf where no mesh covers the pixel: B links of structures whose link
    poses are link_poses (B, NL, 4, 4) (each link's structure's, repeated).  Each ray
    from the camera enters a convex mesh at the largest depth at which it crosses into
    one of the faces it meets from outside, and leaves at the smallest of those it
    meets from inside; it hits the mesh where it enters before it leaves.  Only the
    meshes whose bounding spheres some ray of the link meets are cast against."""
    r = s.region
    du = (fu_px / foc.scale[:, None] + foc.corner_u[:, None] - r.ppu) / r.fu
    dv = (fv_px / foc.scale[:, None] + foc.corner_v[:, None] - r.ppv) / r.fv
    rays = torch.stack([du, dv, torch.ones_like(du)], -1)              # (B, Q, 3)
    tri = models.triangles
    radius = float(torch.linalg.vector_norm(tri.reshape(-1, 3), dim=-1).max())
    relevant = _relevant_meshes(link_poses, radius, rays)
    k = int(relevant.sum(-1).max())
    depth = torch.full(du.shape, math.inf, dtype=du.dtype, device=du.device)
    if k == 0:
        return depth
    # Each link's relevant meshes first; a link with fewer casts some others too.
    owner = torch.argsort(relevant.to(torch.int32), dim=-1, descending=True,
                          stable=True)[:, :k]
    poses = torch.gather(link_poses, 1, owner[..., None, None].expand(-1, -1, 4, 4))
    rot, t = poses[..., :3, :3], poses[..., :3, 3]
    normal = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    n_cam = torch.einsum("bkij,tj->bkti", rot, normal)                 # (B, k, T, 3)
    offset = (n_cam * (torch.einsum("bkij,tj->bkti", rot, tri[:, 0])
                       + t[:, :, None])).sum(-1)                       # (B, k, T)
    parts = []
    for part in range(0, rays.shape[1], QUERY_BLOCK):
        nd = torch.einsum("bqi,bkti->bqkt", rays[:, part:part + QUERY_BLOCK], n_cam)
        at = offset[:, None] / torch.where(nd != 0, nd, torch.ones_like(nd))
        enter = torch.where(nd < 0, at, torch.full_like(at, -math.inf)).amax(-1)
        leave = torch.where(nd > 0, at, torch.full_like(at, math.inf)).amin(-1)
        hit = (enter <= leave) & (enter > 0)
        parts.append(torch.where(hit, enter, torch.full_like(enter, math.inf)).amin(-1))
    depth = torch.cat(parts, 1)
    return torch.where(foc.visible[:, None], depth, torch.full_like(depth, math.inf))


def _window(diameter, max_n_strides: int, cu, cv, width: int, height: int):
    """A strided square window of ``diameter`` pixels around (cu, cv) (depth_modality.cpp
    :826-884, region_modality.cpp:1391-1431): its first column and row, its last and
    its stride, each an integer-valued float tensor."""
    stride = torch.trunc(diameter / max_n_strides + 1.0)
    n_strides = torch.trunc(diameter / stride + 0.5)
    rounded = n_strides * stride
    u0 = torch.trunc(cu - 0.5 * rounded + 0.5)
    v0 = torch.trunc(cv - 0.5 * rounded + 0.5)
    return (u0.clamp_min(0.0), v0.clamp_min(0.0), (u0 + rounded).clamp_max(width - 1),
            (v0 + rounded).clamp_max(height - 1), stride)


def _samples(u_min, v_min, u_max, v_max, stride, k: int):
    """The (..., k, k) pixels of a window, (rows, columns), and which of them exist."""
    i = torch.arange(k, dtype=u_min.dtype, device=u_min.device)
    us = u_min[..., None] + i * stride[..., None]
    vs = v_min[..., None] + i * stride[..., None]
    ok = (vs <= v_max[..., None])[..., :, None] & (us <= u_max[..., None])[..., None, :]
    shape = ok.shape
    return vs[..., :, None].expand(shape), us[..., None, :].expand(shape), ok


def unoccluded(s: Settings, models: Models, link_poses, foc: Focus, u, v, z, radius: float,
               threshold: float):
    """(B, N) bool: no mesh of the scene lies nearer than ``z - threshold`` in the
    modeled-occlusion window around each point's (u, v) (B, N) at depth z; true for a
    link whose focused camera shows nothing (its offsets are 0: a convex body occludes
    nothing of itself)."""
    size = s.focused_image_size
    scale = foc.scale[:, None]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    diameter = 2.0 * radius * (s.region.fu / z_safe) * scale
    fcu = (u - foc.corner_u[:, None]) * scale
    fcv = (v - foc.corner_v[:, None]) * scale
    rows, cols, ok = _samples(*_window(diameter, N_OCCLUSION_STRIDES, fcu, fcv, size, size),
                              N_OCCLUSION_STRIDES + 1)
    b, n = u.shape
    depth = scene_depth(s, models, link_poses, foc, cols.reshape(b, -1),
                        rows.reshape(b, -1)).reshape(ok.shape)
    nearest = torch.where(ok, depth, torch.full_like(depth, math.inf)).flatten(-2).amin(-1)
    return (nearest > z - threshold) | ~foc.visible[:, None]


# ----------------------------------------------------------------------------------------
# Depth correspondences and terms
# ----------------------------------------------------------------------------------------


class DepthPoints(NamedTuple):
    """The closest depth view's points and their correspondences: (B, P) unless noted."""

    center: torch.Tensor          # (B, P, 3) body frame
    normal: torch.Tensor          # (B, P, 3) body frame
    correspondence: torch.Tensor  # (B, P, 3) camera frame
    valid: torch.Tensor


def depth_view(model: DepthModel, pose, n_points: int):
    """(centers, normals) (B, P, 3) of the view whose camera direction best matches the
    body's."""
    t = pose[:, :3, 3]
    towards = t / torch.linalg.vector_norm(t, dim=1, keepdim=True)
    in_body = (pose[:, :3, :3].transpose(1, 2) @ towards[:, :, None])[:, :, 0]
    view = torch.argmax(in_body @ model.orientations.T, dim=1)
    return model.centers[view, :n_points], model.normals[view, :n_points]


def depth_correspondences(s: Settings, models: Models, link_poses, foc: Focus, pose,
                          depth_frames, frame_of, corr_iteration: int) -> DepthPoints:
    """Each point of the closest view projected, checked against the scene, and matched
    to the nearest depth-frame point of its window within the considered distance.
    depth_frames (S, H, W) uint16; frame_of (B,) the frame of each link."""
    r = s.region
    cd, _ = s.depth_iteration(corr_iteration)
    center, normal = depth_view(models.depth, pose, s.n_points)
    cam = center @ pose[:, :3, :3].transpose(1, 2) + pose[:, None, :3, 3]
    z = cam[..., 2]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    u = cam[..., 0] * r.fu / z_safe + r.ppu
    v = cam[..., 1] * r.fv / z_safe + r.ppv
    iu, iv = torch.trunc(u + 0.5), torch.trunc(v + 0.5)
    valid = (z > 0) & (iu >= 0) & (iu <= r.width - 1) & (iv >= 0) & (iv <= r.height - 1)
    valid = valid & unoccluded(s, models, link_poses, foc, u, v, z,
                               s.depth_occlusion_radius, s.depth_occlusion_threshold)

    max_n_strides = max(int(cd / s.stride_length + 0.5), 1)
    k = max_n_strides + 1
    diameter = 2.0 * cd * (r.fu / z_safe)
    rows, cols, ok = _samples(*_window(diameter, max_n_strides, u, v, r.width, r.height), k)
    frame = frame_of[:, None, None, None].expand(rows.shape)
    raw = depth_frames.view(torch.int16)[frame, rows.long(), cols.long()]
    d = (raw.to(torch.int32) & 0xFFFF).to(torch.float32) * s.depth_scale
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
    return DepthPoints(center, normal, correspondence, valid & found)


def depth_gradient_hessian(points: DepthPoints, pose, deviation: float):
    """((B, 6), (B, 6, 6)) of the points' point-to-plane log-likelihood over the
    body-frame twist (rotation first), each point weighted by 1 / (deviation
    depth)^2."""
    rot, t = pose[:, :3, :3], pose[:, :3, 3]
    corr = (points.correspondence - t[:, None]) @ rot               # body frame
    error = (points.normal * (points.center - corr)).sum(-1)
    jac = torch.cat([torch.linalg.cross(corr, points.normal, dim=-1), points.normal], -1)
    depth = points.correspondence[..., 2]
    weight = 1.0 / (deviation * torch.where(depth != 0, depth, torch.ones_like(depth))) ** 2
    weight = torch.where(points.valid, weight, torch.zeros_like(weight))
    gradient = -torch.einsum("bp,bpi->bi", weight * error, jac)
    hessian = -(jac.transpose(1, 2) @ (jac * weight[..., None]))
    return gradient, hessian


# ----------------------------------------------------------------------------------------
# The cycle
# ----------------------------------------------------------------------------------------


def _blocks(n: int):
    return [slice(i, min(i + BLOCK, n)) for i in range(0, n, BLOCK)]


def _link_bins(s: Settings, images, nl: int):
    """(S * NL, H, W) histogram bins of every link's frame."""
    return rr.pixel_bins(s.region, images).repeat_interleave(nl, 0)


def start(s: Settings, st: Structure, models: Models, images, joint2parent):
    """(joint2parent, histogram_f, histogram_b): every link's histograms made at the
    starting joint state; histograms (S, NL, n^3)."""
    nl = st.n_links
    hist_f, hist_b = [], []
    for part in _blocks(joint2parent.shape[0]):
        pose = forward_kinematics(st, joint2parent[part]).reshape(-1, 4, 4)
        bins = _link_bins(s, images[part], nl)
        count_f, count_b = rr.colour_counts(s.region, rr.project(s.region, models.region,
                                                                 pose), bins)
        uniform = torch.full_like(count_f, 1.0 / count_f.shape[-1])
        hist_f.append(rr.blend(uniform, count_f, 1.0).unflatten(0, (-1, nl)))
        hist_b.append(rr.blend(uniform, count_b, 1.0).unflatten(0, (-1, nl)))
    return joint2parent, torch.cat(hist_f), torch.cat(hist_b)


def _cycle_block(s: Settings, st: Structure, models: Models, images, depth_frames, state):
    r = s.region
    nl = st.n_links
    joints, hist_f, hist_b = state
    n_struct = joints.shape[0]
    hist_f, hist_b = hist_f.reshape(n_struct * nl, -1), hist_b.reshape(n_struct * nl, -1)
    bins = _link_bins(s, images, nl)
    frame_of = torch.arange(n_struct, device=joints.device).repeat_interleave(nl)
    mesh_radius = float(torch.linalg.vector_norm(models.triangles.reshape(-1, 3),
                                                 dim=-1).max())
    for corr_iteration in range(r.n_corr_iterations):
        scale, deviation = r.iteration(corr_iteration)
        _, depth_deviation = s.depth_iteration(corr_iteration)
        structure_poses = forward_kinematics(st, joints)
        link_poses = structure_poses.repeat_interleave(nl, 0)        # (B, NL, 4, 4)
        pose = structure_poses.reshape(-1, 4, 4)
        foc = focus(s, pose[:, :3, 3], mesh_radius)
        lines = rr.project(r, models.region, pose)
        lines = lines._replace(valid=lines.valid & unoccluded(
            s, models, link_poses, foc, lines.u, lines.v, lines.z,
            s.region_occlusion_radius, s.region_occlusion_threshold))
        corr = rr.correspondences(r, lines, bins, hist_f, hist_b, scale)
        points = depth_correspondences(s, models, link_poses, foc, pose, depth_frames,
                                       frame_of, corr_iteration)
        for update in range(r.n_update_iterations):
            pose = forward_kinematics(st, joints).reshape(-1, 4, 4)
            gradient, hessian = rr.gradient_hessian(r, lines, corr, pose, deviation,
                                                    update < r.n_global_iterations)
            depth_g, depth_h = depth_gradient_hessian(points, pose, depth_deviation)
            joints = kkt_step(s, st, joints, (gradient + depth_g).unflatten(0, (-1, nl)),
                              (hessian + depth_h).unflatten(0, (-1, nl)))
    pose = forward_kinematics(st, joints).reshape(-1, 4, 4)
    count_f, count_b = rr.colour_counts(r, rr.project(r, models.region, pose), bins)
    return (joints, rr.blend(hist_f, count_f, r.learning_rate_f).unflatten(0, (-1, nl)),
            rr.blend(hist_b, count_b, r.learning_rate_b).unflatten(0, (-1, nl)))


def cycle(s: Settings, st: Structure, models: Models, images, depth_images, state):
    """The state (joint2parent (S, NL, 4, 4), histogram_f (S, NL, n^3), histogram_b)
    after one tracking cycle on the frames: images (S, 3, H, W) uint8, depth_images
    (S, H, W) uint16."""
    out = []
    for part in _blocks(state[0].shape[0]):
        out.append(_cycle_block(s, st, models, images[part], depth_images[part],
                                tuple(x[part] for x in state)))
    return tuple(torch.cat(parts) for parts in zip(*out))
