"""Geometry store of the renderers (port of m3t_tpu/renderer_geometry.py; reference
m3t/src/renderer_geometry.cpp).

The reference uploads each body's triangles into per-body OpenGL VAO/VBOs inside a hidden
GLFW context (renderer_geometry.h:48-69).  Here each body's triangle soup becomes a
``(T, 3, 3)`` float32 tensor (body frame) on the geometry's device; renderers transform
and rasterize them there (``ops/raster.py``).  A decimated copy is kept for occlusion
rendering, so that the rasterizer's cost stays bounded for large dataset meshes.
"""

from __future__ import annotations

import dataclasses

import torch

from m3t_tpu_torch.body import Body
from m3t_tpu_torch.common import (add_ptr_if_name_not_exists, delete_ptr_if_name_exists,
                                  resolve_device)
from m3t_tpu_torch.ops.raster import decimate_mesh


@dataclasses.dataclass
class RenderDataBody:
    """Per-body render data (reference: renderer_geometry.h:48-53)."""

    body: Body
    tri_verts_f_body: torch.Tensor  # (T, 3, 3) float32 on the geometry's device
    occlusion_tri_verts_f_body: torch.Tensor  # (T_dec, 3, 3) float32, same device
    n_triangles: int


class RendererGeometry:
    """Holds render data for all referenced bodies (reference: renderer_geometry.h:59-97)."""

    def __init__(self, name: str, max_occlusion_triangles: int = 2048, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.body_ptrs: list[Body] = []
        self.render_data_bodies: dict[str, RenderDataBody] = {}
        self.max_occlusion_triangles = int(max_occlusion_triangles)
        self.set_up = False

    def AddBody(self, body: Body) -> bool:  # noqa: N802
        self.set_up = False
        if not add_ptr_if_name_not_exists(body, self.body_ptrs):
            print(f"Body {body.name} already exists in renderer geometry {self.name}")
            return False
        return True

    def DeleteBody(self, name: str) -> bool:  # noqa: N802
        self.set_up = False
        return delete_ptr_if_name_exists(name, self.body_ptrs)

    def ClearBodies(self) -> None:  # noqa: N802
        self.set_up = False
        self.body_ptrs = []

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        self.render_data_bodies = {}
        for body in self.body_ptrs:
            if not body.set_up:
                print(f"Body {body.name} was not set up")
                return False
            tri = body.triangle_vertices_f_body()  # (T, 3, 3) numpy
            g2b = body.geometry2body_pose
            verts_b = body.vertices @ g2b[:3, :3].T + g2b[:3, 3]
            dec_v, dec_t = decimate_mesh(verts_b, body.triangles, self.max_occlusion_triangles)
            self.render_data_bodies[body.name] = RenderDataBody(
                body=body,
                tri_verts_f_body=torch.as_tensor(tri, device=self.device),
                occlusion_tri_verts_f_body=torch.as_tensor(dec_v[dec_t], device=self.device),
                n_triangles=int(len(tri)),
            )
        self.set_up = True
        return True

    def render_data(self, name: str) -> RenderDataBody:
        return self.render_data_bodies[name]
