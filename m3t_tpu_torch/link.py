"""Link: a kinematic tree node (port of m3t_tpu/link.py; reference m3t/src/link.cpp).

Holds a body, its modalities, and child links; projects parent Jacobians through adjoints
and applies exp-map pose updates in the joint frame (link.cpp:159-241).  Tree math runs on
host in numpy — the matrices are 6xDoF, the heavy device work happened inside modalities,
whose terms it reads back to the host.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg

from m3t_tpu_torch.common import (add_ptr_if_name_not_exists, delete_ptr_if_name_exists,
                                  to_numpy)
from m3t_tpu_torch.utils import yaml_io


def np_adjoint(pose: np.ndarray) -> np.ndarray:
    """[[R, 0], [skew(t) R, R]] for theta = [w, t] (link.cpp:341-348)."""
    rot = pose[:3, :3]
    t = pose[:3, 3]
    skew = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    out = np.zeros((6, 6), np.float32)
    out[:3, :3] = rot
    out[3:, :3] = skew @ rot
    out[3:, 3:] = rot
    return out


def np_pose_variation(theta6: np.ndarray) -> np.ndarray:
    """Trans(t) @ Rot(exp(skew(w))) (link.cpp:221-224)."""
    w = np.asarray(theta6[:3], np.float64)
    skew = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = scipy.linalg.expm(skew).astype(np.float32)
    pose[:3, 3] = theta6[3:]
    return pose


class Link:
    def __init__(self, name: str, body_ptr=None, metafile_path: str | None = None,
                 body2joint_pose: np.ndarray | None = None,
                 joint2parent_pose: np.ndarray | None = None,
                 link2world_pose: np.ndarray | None = None,
                 free_directions=None, fixed_body2joint_pose: bool = True):
        self.name = name
        self.metafile_path = metafile_path
        self.body_ptr = body_ptr
        self.modality_ptrs: list = []
        self.child_link_ptrs: list[Link] = []
        self.body2joint_pose = (np.eye(4, dtype=np.float32) if body2joint_pose is None
                                else np.asarray(body2joint_pose, np.float32))
        self.joint2parent_pose = (np.eye(4, dtype=np.float32) if joint2parent_pose is None
                                  else np.asarray(joint2parent_pose, np.float32))
        self._link2world_pose = (np.eye(4, dtype=np.float32) if link2world_pose is None
                                 else np.asarray(link2world_pose, np.float32))
        self.free_directions = ([True] * 6 if free_directions is None
                                else list(free_directions))
        self.fixed_body2joint_pose = bool(fixed_body2joint_pose)
        self.default_body2joint_pose = self.body2joint_pose.copy()
        self.default_joint2parent_pose = self.joint2parent_pose.copy()
        self.gradient = np.zeros(6, np.float32)
        self.hessian = np.zeros((6, 6), np.float32)
        self.jacobian = None
        self.first_jacobian_index = 0
        self._jacobian_defined = False
        self.set_up = False

    # -- structure ---------------------------------------------------------------------

    def AddModality(self, modality) -> bool:  # noqa: N802
        self.set_up = False
        if not add_ptr_if_name_not_exists(modality, self.modality_ptrs):
            print(f"Modality {modality.name} already exists in link {self.name}")
            return False
        return True

    def AddChildLink(self, link: "Link") -> bool:  # noqa: N802
        self.set_up = False
        if not add_ptr_if_name_not_exists(link, self.child_link_ptrs):
            print(f"Child link {link.name} already exists in link {self.name}")
            return False
        return True

    def DeleteModality(self, name: str) -> bool:  # noqa: N802
        self.set_up = False
        return delete_ptr_if_name_exists(name, self.modality_ptrs)

    def DeleteChildLink(self, name: str) -> bool:  # noqa: N802
        self.set_up = False
        return delete_ptr_if_name_exists(name, self.child_link_ptrs)

    def ClearModalities(self) -> None:  # noqa: N802
        self.set_up = False
        self.modality_ptrs.clear()

    def ClearChildLinks(self) -> None:  # noqa: N802
        self.set_up = False
        self.child_link_ptrs.clear()

    def DegreesOfFreedom(self) -> int:  # noqa: N802
        return sum(self.free_directions)

    # -- setup -------------------------------------------------------------------------

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        for modality in self.modality_ptrs:
            if not modality.set_up:
                print(f"Modality {modality.name} was not set up")
                return False
        if self.body_ptr is not None and not self.body_ptr.set_up:
            print(f"Body {self.body_ptr.name} was not set up")
            return False
        self.set_up = True
        return True

    def _load_metadata(self) -> bool:
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)
        self.body2joint_pose = yaml_io.read_pose(fs, "body2joint_pose",
                                                 self.body2joint_pose)
        self.joint2parent_pose = yaml_io.read_pose(fs, "joint2parent_pose",
                                                   self.joint2parent_pose)
        self._link2world_pose = yaml_io.read_pose(fs, "link2world_pose",
                                                  self._link2world_pose)
        free = yaml_io.read_optional(fs, "free_directions", None)
        if free is not None:
            if len(free) != 6:
                print(f'Parameter "free_directions" in {self.metafile_path} does '
                      f"not contain 6 boolean values.")
                return False
            self.free_directions = [bool(int(v)) for v in free]
        self.fixed_body2joint_pose = bool(yaml_io.read_optional(
            fs, "fixed_body2joint_pose", self.fixed_body2joint_pose))
        self.default_body2joint_pose = self.body2joint_pose.copy()
        self.default_joint2parent_pose = self.joint2parent_pose.copy()
        return True

    # -- jacobians & updates (link.cpp:151-246) ----------------------------------------

    def DefineJacobian(self, jacobian_size: int, first_jacobian_index: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up link {self.name} first")
            return False
        self.jacobian = np.zeros((6, jacobian_size), np.float32)
        self.first_jacobian_index = first_jacobian_index
        self._jacobian_defined = True
        return True

    def CalculateJacobian(self, parent_link) -> bool:  # noqa: N802
        if not self._check(True):
            return False
        if parent_link is not None:
            parent2body = np.linalg.inv(
                (self.joint2parent_pose @ self.body2joint_pose).astype(np.float64)
            ).astype(np.float32)
            self.jacobian = np_adjoint(parent2body) @ parent_link.jacobian
        else:
            self.jacobian = np.zeros_like(self.jacobian)
        joint2body = np.linalg.inv(self.body2joint_pose.astype(np.float64)).astype(np.float32)
        adj = np_adjoint(joint2body)
        idx = self.first_jacobian_index
        for direction in range(6):
            if self.free_directions[direction]:
                self.jacobian[:, idx] = adj[:, direction]
                idx += 1
        return True

    def CalculateGradientAndHessian(self) -> bool:  # noqa: N802
        if not self._check(True):
            return False
        self.gradient = np.zeros(6, np.float32)
        self.hessian = np.zeros((6, 6), np.float32)
        for modality in self.modality_ptrs:
            self.gradient = self.gradient + to_numpy(modality.gradient).astype(np.float32)
            self.hessian = self.hessian + to_numpy(modality.hessian).astype(np.float32)
        return True

    def AddToGradientAndHessian(self, gradient, hessian) -> bool:  # noqa: N802
        if not self._check(True):
            return False
        self.gradient = self.gradient + np.asarray(gradient, np.float32)
        self.hessian = self.hessian + np.asarray(hessian, np.float32)
        return True

    def UpdatePoses(self, parent_link, theta: np.ndarray) -> bool:  # noqa: N802
        if not self._check(True):
            return False
        theta_link = np.zeros(6, np.float32)
        idx = self.first_jacobian_index
        for direction in range(6):
            if self.free_directions[direction]:
                theta_link[direction] = theta[idx]
                idx += 1
        variation = np_pose_variation(theta_link)

        if parent_link is not None:
            if self.fixed_body2joint_pose:
                self.joint2parent_pose = self.joint2parent_pose @ variation
            else:
                self.body2joint_pose = variation @ self.body2joint_pose
            self._link2world_pose = (parent_link.link2world_pose
                                     @ self.joint2parent_pose @ self.body2joint_pose)
        else:
            b2j_inv = np.linalg.inv(self.body2joint_pose.astype(np.float64)).astype(np.float32)
            self._link2world_pose = (self.link2world_pose @ b2j_inv
                                     @ variation @ self.body2joint_pose)
        if self.body_ptr is not None:
            self.body_ptr.set_body2world_pose(self._link2world_pose)
        return True

    def ResetJointPoses(self) -> None:  # noqa: N802
        self.body2joint_pose = self.default_body2joint_pose.copy()
        self.joint2parent_pose = self.default_joint2parent_pose.copy()

    def set_link2world_pose(self, pose: np.ndarray) -> None:
        self._link2world_pose = np.asarray(pose, np.float32)
        if self.body_ptr is not None:
            self.body_ptr.set_body2world_pose(self._link2world_pose)

    @property
    def link2world_pose(self) -> np.ndarray:
        if self.body_ptr is not None:
            return self.body_ptr.body2world_pose
        return self._link2world_pose

    def _check(self, check_jacobian: bool) -> bool:
        if not self.set_up:
            print(f"Set up link {self.name} first")
            return False
        if check_jacobian and not self._jacobian_defined:
            print(f"Define jacobian of link {self.name} first")
            return False
        return True
