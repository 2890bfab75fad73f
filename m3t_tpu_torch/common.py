"""Core pose math (port of m3t_tpu/common.py:28-254).

Poses are ``(..., 4, 4)`` float32 tensors; twists are ``[w_x, w_y, w_z, t_x, t_y, t_z]``
(rotation first), and a pose variation is ``Trans(t) @ Rot(exp(skew(w)))``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


class Intrinsics(NamedTuple):
    """Pinhole camera intrinsics."""

    fu: float
    fv: float
    ppu: float
    ppv: float
    width: int
    height: int


def resolve_device(device) -> torch.device:
    """The requested device; raises for CUDA when no card is present (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev


def skew(v):
    """Skew-symmetric matrix of (..., 3) vectors."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack(
        [
            torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
            torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
            torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Rodrigues' formula: exp of skew(w), with Taylor fallbacks at w -> 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-12
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_theta2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    # K^2 == w w^T - theta^2 I exactly; the outer product avoids matmul rounding.
    k2 = w[..., :, None] * w[..., None, :] - theta2[..., None, None] * eye
    return eye + s[..., None, None] * skew(w) + c[..., None, None] * k2


def so3_log(rot):
    """Rotation vector of (..., 3, 3) rotation matrices. Safe near identity; not at
    theta == pi, where the axis is lost (as in the JAX package)."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    axis_unnorm = torch.stack(
        [
            rot[..., 2, 1] - rot[..., 1, 2],
            rot[..., 0, 2] - rot[..., 2, 0],
            rot[..., 1, 0] - rot[..., 0, 1],
        ],
        dim=-1,
    )
    small = theta < 1e-6
    # axis_unnorm = 2 sin(theta) * axis ; w = theta * axis
    factor = torch.where(
        small,
        0.5 + theta * theta / 12.0,
        theta / (2.0 * torch.sin(torch.where(small, torch.ones_like(theta), theta))),
    )
    return factor[..., None] * axis_unnorm


def xcotx(x):
    """x * cot(x), Taylor-stabilized near 0."""
    small = torch.abs(x) < 1e-4
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 3.0, safe * torch.cos(safe) / torch.sin(safe))


def pose_from_rt(rotation, translation):
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    pose = torch.zeros(batch + (4, 4), dtype=torch.float32, device=rotation.device)
    pose[..., :3, :3] = rotation
    pose[..., :3, 3] = translation
    pose[..., 3, 3] = 1.0
    return pose


def pose_variation(theta6):
    """Local pose variation ``Trans(t) @ Rot(exp(w))`` for (..., 6) twists."""
    return pose_from_rt(so3_exp(theta6[..., :3]), theta6[..., 3:])


def pose_inverse(pose):
    rot_t = pose[..., :3, :3].transpose(-1, -2)
    return pose_from_rt(rot_t, -(rot_t @ pose[..., :3, 3:4])[..., 0])


def adjoint(pose):
    """(..., 6, 6) adjoints mapping twists between frames: with theta = [w, t],
    Ad = [[R, 0], [skew(p) R, R]]."""
    rot = pose[..., :3, :3]
    top = torch.cat([rot, torch.zeros_like(rot)], dim=-1)
    bottom = torch.cat([skew(pose[..., :3, 3]) @ rot, rot], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def transform_points(pose, points):
    """Apply (..., 4, 4) poses to (..., N, 3) points."""
    return points @ pose[..., :3, :3].transpose(-1, -2) + pose[..., None, :3, 3]


def rotate_vectors(pose, vectors):
    """Rotate (..., N, 3) vectors by the rotation of (..., 4, 4) poses."""
    return vectors @ pose[..., :3, :3].transpose(-1, -2)


def project(intrinsics: Intrinsics, points_f_camera):
    """Project camera-frame points (..., 3) to pixel coordinates (u, v)."""
    z = points_f_camera[..., 2]
    u = points_f_camera[..., 0] * intrinsics.fu / z + intrinsics.ppu
    v = points_f_camera[..., 1] * intrinsics.fv / z + intrinsics.ppv
    return torch.stack([u, v], dim=-1)


def unproject(intrinsics: Intrinsics, uv, depth):
    """Camera-frame points (..., 3) of pixels (..., 2) at the given depths (...)."""
    x = (uv[..., 0] - intrinsics.ppu) * depth / intrinsics.fu
    y = (uv[..., 1] - intrinsics.ppv) * depth / intrinsics.fv
    return torch.stack([x, y, depth], dim=-1)


def np_pose_inverse(pose: np.ndarray) -> np.ndarray:
    """Inverse of a (4, 4) rigid pose on the host, float32 (m3t_tpu/common.py:194)."""
    pose = np.asarray(pose, np.float32)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = pose[:3, :3].T
    out[:3, 3] = -pose[:3, :3].T @ pose[:3, 3]
    return out


def np_pose(rotation=None, translation=None) -> np.ndarray:
    """A (4, 4) float32 pose on the host from a rotation and a translation
    (m3t_tpu/common.py:185)."""
    pose = np.eye(4, dtype=np.float32)
    if rotation is not None:
        pose[:3, :3] = np.asarray(rotation, np.float32)
    if translation is not None:
        pose[:3, 3] = np.asarray(translation, np.float32)
    return pose


def to_numpy(x) -> np.ndarray:
    """A tensor (on any device) or an array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ----------------------------------------------------------------------------------------
# Name-keyed component registries (m3t_tpu/common.py:210-254, common.h:197-257)
# ----------------------------------------------------------------------------------------


def add_ptr_if_name_not_exists(ptr, ptrs: list) -> bool:
    """Append a component if no component of the same name is in the list."""
    if any(p.name == ptr.name for p in ptrs):
        return False
    ptrs.append(ptr)
    return True


def get_ptr_if_name_exists(name: str, ptrs: list):
    for p in ptrs:
        if p.name == name:
            return p
    return None


def delete_ptr_if_name_exists(name: str, ptrs: list) -> bool:
    for i, p in enumerate(ptrs):
        if p.name == name:
            del ptrs[i]
            return True
    return False


def set_up_object_ptrs(ptrs: list) -> bool:
    """Call SetUp() on every component, reporting the first failure."""
    for p in ptrs:
        if not p.SetUp():
            print(f"Failed to set up {type(p).__name__} {p.name}")
            return False
    return True


@dataclasses.dataclass
class Component:
    """Base of the named framework components: constructor, setters, ``SetUp()``, then
    ``set_up`` is True (m3t_tpu/common.py:240-254)."""

    name: str
    metafile_path: str | None = None

    def __post_init__(self):
        self.set_up = False

    def SetUp(self) -> bool:  # noqa: N802 (reference API parity)
        raise NotImplementedError
