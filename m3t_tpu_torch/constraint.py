"""Hard (Lagrange-multiplier) constraint between two links (port of
m3t_tpu/constraint.py; reference m3t/src/constraint.cpp).

Residual = axis-angle rotation vector + translation of joint2-in-joint1 on constrained
directions (constraint.cpp:176-210); the Jacobian uses the xcotx variation matrix of the
rotation vector (211-262) projected through both link Jacobians.  Host numpy in float64,
as in the JAX package; the Optimizer reads ``residual`` and ``constraint_jacobian``.
"""

from __future__ import annotations

import numpy as np

from m3t_tpu_torch.utils import yaml_io


def _np_xcotx(x: float) -> float:
    if abs(x) < 1e-4:
        return 1.0 - x * x / 3.0
    return x * np.cos(x) / np.sin(x)


def _axis_angle(rot: np.ndarray):
    cos_theta = np.clip((np.trace(rot) - 1.0) * 0.5, -1.0, 1.0)
    angle = float(np.arccos(cos_theta))
    axis_unnorm = np.array(
        [rot[2, 1] - rot[1, 2], rot[0, 2] - rot[2, 0], rot[1, 0] - rot[0, 1]],
        np.float64,
    )
    norm = np.linalg.norm(axis_unnorm)
    if norm < 1e-12:
        axis = np.array([1.0, 0.0, 0.0])
    else:
        axis = axis_unnorm / norm
    return angle, axis


def _skew(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float64)


class Constraint:
    def __init__(self, name: str, link1_ptr=None, link2_ptr=None,
                 metafile_path: str | None = None,
                 body12joint1_pose: np.ndarray | None = None,
                 body22joint2_pose: np.ndarray | None = None,
                 constraint_directions=None):
        self.name = name
        self.metafile_path = metafile_path
        self.link1_ptr = link1_ptr
        self.link2_ptr = link2_ptr
        self.body12joint1_pose = (np.eye(4, dtype=np.float32)
                                  if body12joint1_pose is None
                                  else np.asarray(body12joint1_pose, np.float32))
        self.body22joint2_pose = (np.eye(4, dtype=np.float32)
                                  if body22joint2_pose is None
                                  else np.asarray(body22joint2_pose, np.float32))
        self.constraint_directions = ([True] * 6 if constraint_directions is None
                                      else list(constraint_directions))
        self.residual = None
        self.constraint_jacobian = None
        self.set_up = False

    def NumberOfConstraints(self) -> int:  # noqa: N802
        return sum(self.constraint_directions)

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            fs = yaml_io.open_yaml_file_storage(self.metafile_path)
            self.body12joint1_pose = yaml_io.read_pose(
                fs, "body12joint1_pose", self.body12joint1_pose)
            self.body22joint2_pose = yaml_io.read_pose(
                fs, "body22joint2_pose", self.body22joint2_pose)
            dirs = yaml_io.read_optional(fs, "constraint_directions", None)
            if dirs is not None:
                if len(dirs) != 6:
                    print(f'Parameter "constraint_directions" in '
                          f"{self.metafile_path} does not contain 6 boolean values.")
                    return False
                self.constraint_directions = [bool(int(v)) for v in dirs]
        if self.link1_ptr is None or self.link2_ptr is None:
            print(f"Links for constraint {self.name} not assigned")
            return False
        if not self.link1_ptr.set_up or not self.link2_ptr.set_up:
            print(f"Links for constraint {self.name} were not set up")
            return False
        self.set_up = True
        return True

    def CalculateResidualAndConstraintJacobian(self) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up constraint {self.name} first")
            return False
        link12world = self.link1_ptr.link2world_pose.astype(np.float64)
        link22world = self.link2_ptr.link2world_pose.astype(np.float64)
        body22joint1 = (self.body12joint1_pose.astype(np.float64)
                        @ np.linalg.inv(link12world) @ link22world)
        joint22joint1 = body22joint1 @ np.linalg.inv(
            self.body22joint2_pose.astype(np.float64))

        self.residual = self._residual(joint22joint1).astype(np.float32)
        j2 = self._unprojected_jacobian(joint22joint1, body22joint1)
        j1 = self._unprojected_jacobian(joint22joint1,
                                        self.body12joint1_pose.astype(np.float64))
        self.constraint_jacobian = (
            j2 @ self.link2_ptr.jacobian.astype(np.float64)
            - j1 @ self.link1_ptr.jacobian.astype(np.float64)
        ).astype(np.float32)
        return True

    def _residual(self, joint22joint1: np.ndarray) -> np.ndarray:
        angle, axis = _axis_angle(joint22joint1[:3, :3])
        rotation_vector = angle * axis
        translation_vector = joint22joint1[:3, 3]
        out = []
        for direction in range(6):
            if self.constraint_directions[direction]:
                if direction < 3:
                    out.append(rotation_vector[direction])
                else:
                    out.append(translation_vector[direction - 3])
        return np.asarray(out, np.float64)

    def _unprojected_jacobian(self, joint22joint1: np.ndarray,
                              body2joint1: np.ndarray) -> np.ndarray:
        """UnprojectedConstraintJacobian (constraint.cpp:213-275)."""
        body2joint2 = np.linalg.inv(joint22joint1) @ body2joint1
        joint22body_translation = np.linalg.inv(body2joint2)[:3, 3]
        body2joint1_rotation = body2joint1[:3, :3]
        angle, axis = _axis_angle(joint22joint1[:3, :3])
        angle_half = 0.5 * angle
        xc = _np_xcotx(angle_half)
        variation_matrix = (
            xc * np.eye(3) - angle_half * _skew(axis)
            + (1.0 - xc) * np.outer(axis, axis)
        )
        jac = np.zeros((self.NumberOfConstraints(), 6), np.float64)
        row = 0
        for direction in range(6):
            if self.constraint_directions[direction]:
                if direction < 3:
                    jac[row, :3] = variation_matrix[direction] @ body2joint1_rotation
                else:
                    r = body2joint1_rotation[direction - 3]
                    jac[row, :3] = np.cross(joint22body_translation, r)
                    jac[row, 3:] = r
                row += 1
        return jac
