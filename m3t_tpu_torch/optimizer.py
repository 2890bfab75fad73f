"""Optimizer: the per-structure Newton solver of the host path (port of
m3t_tpu/optimizer.py; reference m3t/src/optimizer.cpp).

Assembles the (dof + n_constraints)^2 KKT system from link gradients/Hessians projected
through tree Jacobians, adds Tikhonov regularization, solves, and applies exp-map pose
updates down the tree (optimizer.cpp:144-167, 304-346).
"""

from __future__ import annotations

import numpy as np

from m3t_tpu_torch.common import add_ptr_if_name_not_exists, delete_ptr_if_name_exists
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.utils import yaml_io


class Optimizer:
    def __init__(self, name: str, root_link_ptr: Link | None = None,
                 tikhonov_parameter_rotation: float = 1000.0,
                 tikhonov_parameter_translation: float = 30000.0,
                 metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.root_link_ptr = root_link_ptr
        self.tikhonov_parameter_rotation = float(tikhonov_parameter_rotation)
        self.tikhonov_parameter_translation = float(tikhonov_parameter_translation)
        self.constraint_ptrs: list = []
        self.soft_constraint_ptrs: list = []
        self.degrees_of_freedom = 0
        self.tikhonov_vector = None
        self.set_up = False

    # -- structure ---------------------------------------------------------------------

    def AddConstraint(self, constraint) -> bool:  # noqa: N802
        self.set_up = False
        if not add_ptr_if_name_not_exists(constraint, self.constraint_ptrs):
            print(f"Constraint {constraint.name} already exists")
            return False
        return True

    def DeleteConstraint(self, name: str) -> bool:  # noqa: N802
        self.set_up = False
        return delete_ptr_if_name_exists(name, self.constraint_ptrs)

    def AddSoftConstraint(self, soft_constraint) -> bool:  # noqa: N802
        self.set_up = False
        if not add_ptr_if_name_not_exists(soft_constraint, self.soft_constraint_ptrs):
            print(f"Soft constraint {soft_constraint.name} already exists")
            return False
        return True

    def DeleteSoftConstraint(self, name: str) -> bool:  # noqa: N802
        self.set_up = False
        return delete_ptr_if_name_exists(name, self.soft_constraint_ptrs)

    def ClearConstraints(self) -> None:  # noqa: N802
        self.set_up = False
        self.constraint_ptrs.clear()

    def ClearSoftConstraints(self) -> None:  # noqa: N802
        self.set_up = False
        self.soft_constraint_ptrs.clear()

    def ReferencedLinks(self) -> list[Link]:  # noqa: N802
        links: list[Link] = []

        def walk(link):
            links.append(link)
            for child in link.child_link_ptrs:
                walk(child)

        if self.root_link_ptr is not None:
            walk(self.root_link_ptr)
        return links

    def NumberOfConstraints(self) -> int:  # noqa: N802
        return sum(c.NumberOfConstraints() for c in self.constraint_ptrs)

    # -- setup -------------------------------------------------------------------------

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            fs = yaml_io.open_yaml_file_storage(self.metafile_path)
            self.tikhonov_parameter_rotation = float(yaml_io.read_optional(
                fs, "tikhonov_parameter_rotation",
                self.tikhonov_parameter_rotation))
            self.tikhonov_parameter_translation = float(yaml_io.read_optional(
                fs, "tikhonov_parameter_translation",
                self.tikhonov_parameter_translation))
        if self.root_link_ptr is None:
            print(f"No root link assigned to optimizer {self.name}")
            return False
        for link in self.ReferencedLinks():
            if not link.set_up:
                print(f"Link {link.name} was not set up")
                return False
        for c in self.constraint_ptrs + self.soft_constraint_ptrs:
            if not c.set_up:
                print(f"Constraint {c.name} was not set up")
                return False

        self.degrees_of_freedom = sum(
            link.DegreesOfFreedom() for link in self.ReferencedLinks())
        index = 0
        for link in self.ReferencedLinks():
            if not link.DefineJacobian(self.degrees_of_freedom, index):
                return False
            index += link.DegreesOfFreedom()
        self.set_up = True  # UpdatePoses below requires set_up
        if not self.UpdatePoses(np.zeros(self.degrees_of_freedom, np.float32)):
            self.set_up = False
            return False
        self._define_tikhonov_vector()
        return True

    def _define_tikhonov_vector(self) -> None:
        vec = np.zeros(self.degrees_of_freedom, np.float32)
        for link in self.ReferencedLinks():
            idx = link.first_jacobian_index
            for direction in range(6):
                if link.free_directions[direction]:
                    vec[idx] = (self.tikhonov_parameter_rotation if direction < 3
                                else self.tikhonov_parameter_translation)
                    idx += 1
        self.tikhonov_vector = vec

    # -- per-frame ---------------------------------------------------------------------

    def CalculateConsistentPoses(self) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up optimizer {self.name} first")
            return False
        return self.UpdatePoses(np.zeros(self.degrees_of_freedom, np.float32))

    def CalculateOptimization(self, iteration: int, corr_iteration: int,
                              opt_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up optimizer {self.name} first")
            return False

        dof = self.degrees_of_freedom
        n_constraints = self.NumberOfConstraints()
        size = dof + n_constraints
        b = np.zeros(size, np.float64)
        a = np.zeros((size, size), np.float64)

        # CalculateDataLinks (optimizer.cpp:281-296)
        def walk(link, parent):
            if not link.CalculateJacobian(parent):
                return False
            if not link.CalculateGradientAndHessian():
                return False
            for child in link.child_link_ptrs:
                if not walk(child, link):
                    return False
            return True

        if not walk(self.root_link_ptr, None):
            return False
        for sc in self.soft_constraint_ptrs:
            sc.AddGradientsAndHessiansToLinks()
        for c in self.constraint_ptrs:
            if not c.CalculateResidualAndConstraintJacobian():
                return False

        # AddProjectedGradientsAndHessians (optimizer.cpp:304-321)
        for link in self.ReferencedLinks():
            jac = link.jacobian.astype(np.float64)
            b[:dof] += jac.T @ link.gradient.astype(np.float64)
            a[:dof, :dof] -= jac.T @ link.hessian.astype(np.float64) @ jac

        # Constraint rows (optimizer.cpp:323-333); symmetric KKT system.
        idx = dof
        for c in self.constraint_ptrs:
            n = c.NumberOfConstraints()
            b[idx:idx + n] = c.residual.astype(np.float64)
            a[idx:idx + n, :dof] = -c.constraint_jacobian.astype(np.float64)
            a[:dof, idx:idx + n] = a[idx:idx + n, :dof].T
            idx += n

        a[:dof, :dof] = np.tril(a[:dof, :dof]) + np.tril(a[:dof, :dof], -1).T
        a[np.arange(dof), np.arange(dof)] += self.tikhonov_vector.astype(np.float64)

        try:
            theta = np.linalg.solve(a, b)
        except np.linalg.LinAlgError:
            return True  # singular system: skip update (mirrors NaN guard)
        if np.isnan(theta).any():
            return True  # optimizer.cpp:165 — skip update on NaN
        return self.UpdatePoses(theta.astype(np.float32))

    def UpdatePoses(self, theta: np.ndarray) -> bool:  # noqa: N802
        def walk(link, parent):
            if not link.UpdatePoses(parent, theta):
                return False
            for child in link.child_link_ptrs:
                if not walk(child, link):
                    return False
            return True

        return walk(self.root_link_ptr, None)
