"""Renderer hierarchy over the port's rasterizer (port of m3t_tpu/renderer.py; reference
m3t/src/renderer.cpp).

Full renderers draw every RendererGeometry body at camera intrinsics; focused renderers
draw every body into a square ``image_size`` crop whose corner and scale come from the
projected bounding spheres of the referenced bodies, computed on the host in float64
(renderer.cpp:348-406, kImageSizeSafetyMargin=1.05).  Images are tensors on the
renderer's device: depth in float32 meters with +inf background, silhouettes as int32 id
maps with 0 background, normals as (H, W, 3) float32.  ``ops/raster`` renders a batch
of scenes; a renderer passes one.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from m3t_tpu_torch.body import Body
from m3t_tpu_torch.common import (add_ptr_if_name_not_exists, delete_ptr_if_name_exists,
                                  resolve_device, to_numpy)
from m3t_tpu_torch.ops import raster
from m3t_tpu_torch.renderer_geometry import RendererGeometry


class IDType(enum.Enum):
    BODY = 0
    REGION = 1


class Renderer:
    """Base renderer (reference: renderer.h:30-113)."""

    def __init__(self, name: str, renderer_geometry_ptr: RendererGeometry,
                 camera_ptr=None, z_min: float = 0.02, z_max: float = 10.0,
                 raster_chunk: int = 64, use_decimated_meshes: bool = False,
                 device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.renderer_geometry_ptr = renderer_geometry_ptr
        self.camera_ptr = camera_ptr
        self.z_min = float(z_min)
        self.z_max = float(z_max)
        self.raster_chunk = int(raster_chunk)
        self.use_decimated_meshes = bool(use_decimated_meshes)
        self.intrinsics = None
        self.world2camera_pose = np.eye(4, dtype=np.float32)
        self.set_up = False

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if not self.renderer_geometry_ptr or not self.renderer_geometry_ptr.set_up:
            print(f"Renderer geometry for renderer {self.name} not set up")
            return False
        if self.camera_ptr is not None:
            if not self.camera_ptr.set_up:
                print(f"Camera {self.camera_ptr.name} for renderer {self.name} not set up")
                return False
            self.intrinsics = self.camera_ptr.intrinsics
            self.world2camera_pose = self.camera_ptr.world2camera_pose
        if self.intrinsics is None:
            print(f"Renderer {self.name} has no intrinsics")
            return False
        if not self._check_bodies():
            return False
        self.set_up = True
        return True

    def _check_bodies(self) -> bool:
        return True

    def _bodies(self) -> list[Body]:
        raise NotImplementedError

    def _gather_triangles(self, id_type: IDType = IDType.BODY):
        """Camera-frame triangle vertices (T, 3, 3), ids (T,) and cull flags (T,) of
        every drawn body, on the renderer's device."""
        if self.camera_ptr is not None:
            self.world2camera_pose = self.camera_ptr.world2camera_pose
        verts, ids, culls = [], [], []
        for body in self._bodies():
            data = self.renderer_geometry_ptr.render_data(body.name)
            tri = (data.occlusion_tri_verts_f_body if self.use_decimated_meshes
                   else data.tri_verts_f_body).to(self.device)
            pose = torch.as_tensor(
                np.asarray(self.world2camera_pose @ body.body2world_pose, np.float32),
                device=self.device)
            verts.append(tri @ pose[:3, :3].T + pose[:3, 3])
            bid = body.body_id if id_type == IDType.BODY else body.region_id
            ids.append(torch.full((tri.shape[0],), bid, dtype=torch.int32,
                                  device=self.device))
            culls.append(torch.full((tri.shape[0],), bool(body.geometry_enable_culling),
                                    dtype=torch.bool, device=self.device))
        return torch.cat(verts), torch.cat(ids), torch.cat(culls)

    def _rasterize(self, id_type: IDType, with_normals: bool, fu, fv, ppu, ppv,
                   width: int, height: int):
        """One scene through ops/raster (a batch of one), each chunk of triangles over
        its window (one host read), so that a focused render skips the chunks of the
        bodies outside its crop; the batch dimension dropped.  The graphed whole-image
        ``raster.rasterize`` gives the same images, but on the card it renders a focused
        scene more slowly, since its graph evaluates every chunk over the whole crop
        (``chip_smoke.py`` phase 10 holds the two forms' images equal)."""
        tri_cam, ids, culls = self._gather_triangles(id_type)
        soup = raster.triangle_coefficients(tri_cam[None], ids[None], fu, fv, ppu, ppv,
                                            cull_backfaces=culls[None], z_min=self.z_min)
        out = raster.rasterize_windows(
            soup, width, height, raster.chunk_windows(soup, width, height, self.raster_chunk),
            chunk=self.raster_chunk, with_normals=with_normals)
        return tuple(x[0] for x in out)


class FullRenderer(Renderer):
    """Renders all RendererGeometry bodies at full camera resolution."""

    def _bodies(self):
        return self.renderer_geometry_ptr.body_ptrs

    def _render(self, id_type: IDType = IDType.BODY, with_normals: bool = False):
        intr = self.intrinsics
        return self._rasterize(id_type, with_normals, intr.fu, intr.fv, intr.ppu,
                               intr.ppv, intr.width, intr.height)


class FocusedRenderer(Renderer):
    """Renders into a square crop around the referenced bodies (reference:
    renderer.h:170-227)."""

    kImageSizeSafetyMargin = 1.05

    def __init__(self, name: str, renderer_geometry_ptr: RendererGeometry,
                 camera_ptr=None, image_size: int = 200, z_min: float = 0.02,
                 z_max: float = 10.0, **kwargs):
        super().__init__(name, renderer_geometry_ptr, camera_ptr, z_min, z_max,
                         use_decimated_meshes=kwargs.pop("use_decimated_meshes", False),
                         **kwargs)
        self.image_size = int(image_size)
        self.referenced_body_ptrs: list[Body] = []
        self.visible_body_names: list[str] = []
        self.corner_u = 0.0
        self.corner_v = 0.0
        self.scale = 1.0

    def AddReferencedBody(self, body: Body) -> bool:  # noqa: N802
        self.set_up = False
        if not add_ptr_if_name_not_exists(body, self.referenced_body_ptrs):
            print(f"Referenced body {body.name} already exists in renderer {self.name}")
            return False
        return True

    def DeleteReferencedBody(self, name: str) -> bool:  # noqa: N802
        self.set_up = False
        return delete_ptr_if_name_exists(name, self.referenced_body_ptrs)

    def ClearReferencedBodies(self) -> None:  # noqa: N802
        self.set_up = False
        self.referenced_body_ptrs.clear()

    def _check_bodies(self) -> bool:
        for body in self.referenced_body_ptrs:
            if body.name not in self.renderer_geometry_ptr.render_data_bodies:
                print(f"Referenced body {body.name} not in renderer geometry "
                      f"{self.renderer_geometry_ptr.name}")
                return False
        return True

    def _bodies(self):
        # The reference draws the whole renderer-geometry scene with the focused
        # projection (renderer.cpp:348-406 computes the crop from referenced bodies
        # only, but the GL pass rasterizes every body in the context): that is how
        # bodies that are not referenced occlude in focused depth and silhouette images.
        return self.renderer_geometry_ptr.body_ptrs

    def IsBodyVisible(self, body_name: str) -> bool:  # noqa: N802
        return body_name in self.visible_body_names

    def calculate_projection(self) -> None:
        """Crop corner and scale from projected bounding spheres (renderer.cpp:348-406),
        in host float64."""
        if self.camera_ptr is not None:
            self.world2camera_pose = self.camera_ptr.world2camera_pose
        intr = self.intrinsics
        u_min, u_max = np.inf, -np.inf
        v_min, v_max = np.inf, -np.inf
        self.visible_body_names = []
        for body in self.referenced_body_ptrs:
            r = 0.5 * body.maximum_body_diameter
            t = (self.world2camera_pose @ body.body2world_pose)[:3, 3]
            x, y, z = float(t[0]), float(t[1]), float(t[2])
            if z < r * 1.5 or z - r < self.z_min or z + r > self.z_max:
                continue
            z2_r2 = z * z - r * r
            z3_zr2 = z2_r2 * z
            r_u = intr.fu * (abs(x) * r * r + r * z * np.sqrt(z2_r2 + x * x)) / z3_zr2
            r_v = intr.fv * (abs(y) * r * r + r * z * np.sqrt(z2_r2 + y * y)) / z3_zr2
            cu = x * intr.fu / z + intr.ppu
            cv = y * intr.fv / z + intr.ppv
            if cu - r_u > intr.width or cu + r_u < 0 or cv - r_v > intr.height or cv + r_v < 0:
                continue
            u_min = min(u_min, cu - r_u)
            u_max = max(u_max, cu + r_u)
            v_min = min(v_min, cv - r_v)
            v_max = max(v_max, cv + r_v)
            self.visible_body_names.append(body.name)
        if not self.visible_body_names:
            self.corner_u = self.corner_v = 0.0
            self.scale = 1.0
            return
        d = max(u_max - u_min, v_max - v_min) * self.kImageSizeSafetyMargin
        self.corner_u = 0.5 * (u_min + u_max - d)
        self.corner_v = 0.5 * (v_min + v_max - d)
        self.scale = float(self.image_size) / d

    def _render(self, id_type: IDType = IDType.BODY, with_normals: bool = False):
        # The focused crop is scaled and shifted intrinsics:
        # focused_u = (u - corner_u) * scale.
        intr = self.intrinsics
        return self._rasterize(
            id_type, with_normals, intr.fu * self.scale, intr.fv * self.scale,
            (intr.ppu - self.corner_u) * self.scale,
            (intr.ppv - self.corner_v) * self.scale, self.image_size, self.image_size)

    def _empty_images(self):
        size = (self.image_size, self.image_size)
        return (torch.full(size, float("inf"), device=self.device),
                torch.zeros(size, dtype=torch.int32, device=self.device))


class _DepthRenderMixin:
    def StartRendering(self) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up renderer {self.name} first")
            return False
        if isinstance(self, FocusedRenderer):
            self.calculate_projection()
            if not self.visible_body_names:
                self.depth_image, _ = self._empty_images()
                return True
        self.depth_image, _ = self._render(IDType.BODY)
        return True

    def FetchDepthImage(self) -> bool:  # noqa: N802
        return True

    def focused_depth_image(self):
        return self.depth_image


class _SilhouetteRenderMixin:
    def StartRendering(self) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up renderer {self.name} first")
            return False
        if isinstance(self, FocusedRenderer):
            self.calculate_projection()
            if not self.visible_body_names:
                self.depth_image, self.silhouette_image = self._empty_images()
                return True
        self.depth_image, self.silhouette_image = self._render(self.id_type)
        return True

    def FetchSilhouetteImage(self) -> bool:  # noqa: N802
        return True

    def FetchDepthImage(self) -> bool:  # noqa: N802
        return True

    def focused_silhouette_image(self):
        return self.silhouette_image

    def focused_depth_image(self):
        return self.depth_image


class _NormalRenderMixin:
    def StartRendering(self) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up renderer {self.name} first")
            return False
        if isinstance(self, FocusedRenderer):
            self.calculate_projection()
        self.depth_image, _, self.normal_image = self._render(IDType.BODY,
                                                              with_normals=True)
        return True

    def FetchNormalImage(self) -> bool:  # noqa: N802
        return True

    def FetchDepthImage(self) -> bool:  # noqa: N802
        return True

    def normal_image_rgb(self) -> np.ndarray:
        """Normals as uint8 RGB on the host, GL-shader convention 0.5 - 0.5*n
        (normal_renderer.cpp:11-31)."""
        n = to_numpy(self.normal_image)
        valid = np.isfinite(to_numpy(self.depth_image))
        rgb = np.where(valid[..., None], 0.5 - 0.5 * n, 0.0)
        return (rgb * 255.0).astype(np.uint8)


class FullBasicDepthRenderer(_DepthRenderMixin, FullRenderer):
    """Full-image depth renderer (reference: basic_depth_renderer.h)."""


class FocusedBasicDepthRenderer(_DepthRenderMixin, FocusedRenderer):
    """Focused depth renderer for modeled occlusions (reference: basic_depth_renderer.h)."""


# Aliases of the reference's names, as the modalities use them.
FullDepthRenderer = FullBasicDepthRenderer
FocusedDepthRenderer = FocusedBasicDepthRenderer


class FullSilhouetteRenderer(_SilhouetteRenderMixin, FullRenderer):
    """Full-image silhouette renderer (reference: silhouette_renderer.h)."""

    def __init__(self, *args, id_type: IDType = IDType.BODY, **kwargs):
        super().__init__(*args, **kwargs)
        self.id_type = id_type


class FocusedSilhouetteRenderer(_SilhouetteRenderMixin, FocusedRenderer):
    """Focused silhouette renderer for region and silhouette checking."""

    def __init__(self, *args, id_type: IDType = IDType.BODY, **kwargs):
        super().__init__(*args, **kwargs)
        self.id_type = id_type

    def SilhouetteValue(self, center) -> int:  # noqa: N802
        u, v = int(center[0]), int(center[1])
        return int(self.silhouette_image[v, u])


class FullNormalRenderer(_NormalRenderMixin, FullRenderer):
    """Full-image normal renderer (reference: normal_renderer.h)."""


class FocusedNormalRenderer(_NormalRenderMixin, FocusedRenderer):
    """Focused normal renderer."""
