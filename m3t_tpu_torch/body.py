"""Rigid body: mesh + pose (port of m3t_tpu/body.py, which redesigns m3t/src/body.cpp).

Reference parity: m3t/include/m3t/body.h, m3t/src/body.cpp:34-253.  The mesh lives as
host numpy arrays, which model generation renders; ``body2world_pose`` is the mutable
tracking state carried frame to frame.
"""

from __future__ import annotations

import itertools

import numpy as np

from m3t_tpu_torch.common import np_pose_inverse
from m3t_tpu_torch.utils import obj_loader, yaml_io

_next_body_id = itertools.count(1)


class Body:
    """Rigid body with mesh, ids, and body2world pose (reference: body.h:22-160)."""

    def __init__(
        self,
        name: str,
        geometry_path: str | None = None,
        geometry_unit_in_meter: float = 1.0,
        geometry_counterclockwise: bool = True,
        geometry_enable_culling: bool = True,
        geometry2body_pose: np.ndarray | None = None,
        metafile_path: str | None = None,
        vertices: np.ndarray | None = None,
        triangles: np.ndarray | None = None,
    ):
        self.name = name
        self.metafile_path = metafile_path
        self.geometry_path = geometry_path
        self.geometry_unit_in_meter = float(geometry_unit_in_meter)
        self.geometry_counterclockwise = bool(geometry_counterclockwise)
        self.geometry_enable_culling = bool(geometry_enable_culling)
        self.geometry2body_pose = (
            np.eye(4, dtype=np.float32)
            if geometry2body_pose is None
            else np.asarray(geometry2body_pose, np.float32)
        )
        # Auto-unique uchar ids used for silhouette rendering (reference: body.cpp:12, 22-23).
        self.body_id = next(_next_body_id) % 256
        self.region_id = self.body_id
        self.body2world_pose = np.eye(4, dtype=np.float32)
        self.world2body_pose = np.eye(4, dtype=np.float32)
        # Direct mesh injection (used by tests and procedural fixtures).
        self._direct_vertices = None if vertices is None else np.asarray(vertices, np.float32)
        self._direct_triangles = None if triangles is None else np.asarray(triangles, np.int32)
        self.vertices = self._direct_vertices
        self.triangles = self._direct_triangles
        self.maximum_body_diameter = 0.0
        self.set_up = False

    # -- setters (invalidate setup like the reference) ---------------------------------

    def set_body2world_pose(self, body2world_pose: np.ndarray) -> None:
        self.body2world_pose = np.asarray(body2world_pose, np.float32)
        self.world2body_pose = np_pose_inverse(self.body2world_pose)

    def set_world2body_pose(self, world2body_pose: np.ndarray) -> None:
        self.world2body_pose = np.asarray(world2body_pose, np.float32)
        self.body2world_pose = np_pose_inverse(self.world2body_pose)

    @property
    def geometry2world_pose(self) -> np.ndarray:
        return self.body2world_pose @ self.geometry2body_pose

    def set_id(self, id_type: str, value: int) -> None:
        if id_type == "body":
            self.body_id = int(value)
        elif id_type == "region":
            self.region_id = int(value)
        else:
            raise ValueError(f"Unknown id type {id_type}")

    # -- setup -------------------------------------------------------------------------

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        if not self._load_mesh():
            return False
        self._calculate_maximum_body_diameter()
        self.set_up = True
        return True

    def _load_metadata(self) -> bool:
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)
        geometry_path = yaml_io.read_required(fs, "geometry_path")
        self.geometry_unit_in_meter = float(yaml_io.read_required(fs, "geometry_unit_in_meter"))
        self.geometry_counterclockwise = bool(
            yaml_io.read_required(fs, "geometry_counterclockwise"))
        self.geometry_enable_culling = bool(yaml_io.read_required(fs, "geometry_enable_culling"))
        self.geometry2body_pose = yaml_io.read_pose(fs, "geometry2body_pose")
        self.body_id = int(yaml_io.read_optional(fs, "body_id", self.body_id))
        self.region_id = int(yaml_io.read_optional(fs, "region_id", self.region_id))
        self.geometry_path = yaml_io.resolve_path(
            geometry_path, self.metafile_path, self.name, ".obj"
        )
        return True

    def _load_mesh(self) -> bool:
        if self._direct_vertices is not None:
            self.vertices = self._direct_vertices * self.geometry_unit_in_meter
            tri = self._direct_triangles
        else:
            if not self.geometry_path:
                print(f"Body {self.name}: no geometry_path or direct mesh provided")
                return False
            vertices, tri = obj_loader.load_obj(self.geometry_path)
            self.vertices = vertices * self.geometry_unit_in_meter
        if not self.geometry_counterclockwise:
            tri = tri[:, ::-1]
        self.triangles = np.ascontiguousarray(tri, np.int32)
        return True

    def _calculate_maximum_body_diameter(self) -> None:
        # Reference: body.cpp:244-250 — max norm of geometry2body-transformed vertices.
        v = self.vertices @ self.geometry2body_pose[:3, :3].T + self.geometry2body_pose[:3, 3]
        self.maximum_body_diameter = float(2.0 * np.linalg.norm(v, axis=1).max(initial=0.0))

    # -- mesh accessors ----------------------------------------------------------------

    def triangle_vertices_f_body(self) -> np.ndarray:
        """Triangles as (T, 3, 3) vertex coordinates in the body frame."""
        v = self.vertices @ self.geometry2body_pose[:3, :3].T + self.geometry2body_pose[:3, 3]
        return v[self.triangles]
