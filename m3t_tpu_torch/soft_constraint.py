"""Penalty-based soft constraint between two links (port of m3t_tpu/soft_constraint.py;
reference m3t/src/soft_constraint.cpp).

When the joint2-in-joint1 deviation exceeds ``max_distance_*``, quadratic-penalty
gradients/Hessians are added directly onto both links, scaled by the standard deviations
(soft_constraint.cpp:113-272).
"""

from __future__ import annotations

import numpy as np

from m3t_tpu_torch.constraint import _axis_angle, _np_xcotx, _skew
from m3t_tpu_torch.utils import yaml_io


class SoftConstraint:
    def __init__(self, name: str, link1_ptr=None, link2_ptr=None,
                 metafile_path: str | None = None,
                 body12joint1_pose: np.ndarray | None = None,
                 body22joint2_pose: np.ndarray | None = None,
                 constraint_directions=None,
                 max_distance_rotation: float = 0.0,
                 max_distance_translation: float = 0.0,
                 standard_deviation_rotation: float = 0.01,
                 standard_deviation_translation: float = 0.001):
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
        self.max_distance_rotation = float(max_distance_rotation)
        self.max_distance_translation = float(max_distance_translation)
        self.standard_deviation_rotation = float(standard_deviation_rotation)
        self.standard_deviation_translation = float(standard_deviation_translation)
        self.set_up = False

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
            self.max_distance_rotation = float(yaml_io.read_optional(
                fs, "max_distance_rotation", self.max_distance_rotation))
            self.max_distance_translation = float(yaml_io.read_optional(
                fs, "max_distance_translation", self.max_distance_translation))
            self.standard_deviation_rotation = float(yaml_io.read_optional(
                fs, "standard_deviation_rotation", self.standard_deviation_rotation))
            self.standard_deviation_translation = float(yaml_io.read_optional(
                fs, "standard_deviation_translation",
                self.standard_deviation_translation))
        if self.link1_ptr is None or self.link2_ptr is None:
            print(f"Links for soft constraint {self.name} not assigned")
            return False
        if not self.link1_ptr.set_up or not self.link2_ptr.set_up:
            print(f"Links for soft constraint {self.name} were not set up")
            return False
        self._n_rotation = sum(self.constraint_directions[:3])
        self._n_translation = sum(self.constraint_directions[3:])
        self.set_up = True
        return True

    def AddGradientsAndHessiansToLinks(self) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up constraint {self.name} first")
            return False
        link12world = self.link1_ptr.link2world_pose.astype(np.float64)
        link22world = self.link2_ptr.link2world_pose.astype(np.float64)
        body22joint1 = (self.body12joint1_pose.astype(np.float64)
                        @ np.linalg.inv(link12world) @ link22world)
        joint22joint1 = body22joint1 @ np.linalg.inv(
            self.body22joint2_pose.astype(np.float64))
        self._add_to_link(joint22joint1, self.body12joint1_pose.astype(np.float64),
                          -1.0, self.link1_ptr)
        self._add_to_link(joint22joint1, body22joint1, 1.0, self.link2_ptr)
        return True

    def _add_to_link(self, joint22joint1, body2joint1, sign, link) -> None:
        gradient = np.zeros(6, np.float64)
        hessian = np.zeros((6, 6), np.float64)

        if self._n_rotation:
            angle, axis = _axis_angle(joint22joint1[:3, :3])
            full_vec = angle * axis
            sel = np.asarray(self.constraint_directions[:3], bool)
            vec = full_vec[sel]
            dist = np.linalg.norm(vec)
            if dist > self.max_distance_rotation:
                jac = self._unprojected_rows(joint22joint1, body2joint1, rotation=True)
                unit = vec / dist
                eye = np.eye(self._n_rotation)
                inv_var = 1.0 / self.standard_deviation_rotation ** 2
                gradient -= (sign * inv_var) * jac.T @ (
                    vec - unit * self.max_distance_rotation)
                hessian -= inv_var * jac.T @ (
                    eye - (self.max_distance_rotation / dist)
                    * (eye - np.outer(unit, unit))
                ) @ jac

        if self._n_translation:
            full_vec = joint22joint1[:3, 3]
            sel = np.asarray(self.constraint_directions[3:], bool)
            vec = full_vec[sel]
            dist = np.linalg.norm(vec)
            if dist > self.max_distance_translation:
                jac = self._unprojected_rows(joint22joint1, body2joint1, rotation=False)
                unit = vec / dist
                eye = np.eye(self._n_translation)
                inv_var = 1.0 / self.standard_deviation_translation ** 2
                gradient -= (sign * inv_var) * jac.T @ (
                    vec - unit * self.max_distance_translation)
                hessian -= inv_var * jac.T @ (
                    eye - (self.max_distance_translation / dist)
                    * (eye - np.outer(unit, unit))
                ) @ jac

        link.AddToGradientAndHessian(gradient.astype(np.float32),
                                     hessian.astype(np.float32))

    def _unprojected_rows(self, joint22joint1, body2joint1, rotation: bool) -> np.ndarray:
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
        rows = []
        if rotation:
            for direction in range(3):
                if self.constraint_directions[direction]:
                    row = np.zeros(6, np.float64)
                    row[:3] = variation_matrix[direction] @ body2joint1_rotation
                    rows.append(row)
        else:
            for direction in range(3):
                if self.constraint_directions[direction + 3]:
                    r = body2joint1_rotation[direction]
                    row = np.zeros(6, np.float64)
                    row[:3] = np.cross(joint22body_translation, r)
                    row[3:] = r
                    rows.append(row)
        return np.asarray(rows, np.float64)
