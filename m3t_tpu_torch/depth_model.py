"""DepthModel — sparse viewpoint surface-point model (port of m3t_tpu/depth_model.py,
which redesigns m3t/src/depth_model.cpp).

For every geodesic view the body is rasterized (with occlusion bodies masking the
silhouette) and ``n_points`` surface points with camera-frame normals and depth offsets
are sampled (depth_model.cpp:144-360).  Runtime access mirrors RegionModel: stacked
arrays (``pipeline.DepthModelArrays.from_models``) + argmax-dot view selection.
"""

from __future__ import annotations

import numpy as np

from m3t_tpu_torch import model_base
from m3t_tpu_torch.body import Body
from m3t_tpu_torch.common import np_pose_inverse
from m3t_tpu_torch.model_base import Model
from m3t_tpu_torch.ops.raster import rasterize_np
from m3t_tpu_torch.region_model import KBACKGROUND_ID, KMAIN_BODY_ID, hashlib_digest
from m3t_tpu_torch.utils.mt19937 import StdMT19937


class DepthModel(Model):
    _kVersionID = 6
    _kModelType = "d"

    def __init__(self, name: str, body_ptr: Body, model_path: str, **kwargs):
        metafile_path = kwargs.pop("metafile_path", None)
        super().__init__(name, body_ptr, model_path, metafile_path=metafile_path, **kwargs)
        self.occlusion_body_ptrs: list[Body] = []
        self.orientations = None  # (V, 3)
        self.centers = None  # (V, N, 3)
        self.normals = None  # (V, N, 3)
        self.depth_offsets = None  # (V, N, 30)
        self.surface_areas = None  # (V,)
        self.max_surface_area = 0.0

    def AddOcclusionBody(self, body: Body) -> bool:  # noqa: N802
        self.set_up = False
        if any(b.name == body.name for b in self.occlusion_body_ptrs):
            return False
        self.occlusion_body_ptrs.append(body)
        return True

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        if not self.body_ptr or not self.body_ptr.set_up:
            print(f"Body for depth model {self.name} was not set up")
            return False
        for b in self.occlusion_body_ptrs:
            if not b.set_up:
                print(f"Occlusion body {b.name} was not set up")
                return False
        if not self._valid_n_depth_offsets():
            return False

        occ_sig = "|".join(f"o:{b.name}:{hashlib_digest(b)}"
                           for b in self.occlusion_body_ptrs)
        checksum = self._checksum(extra=occ_sig + "|mt19937")
        data = self._try_load(checksum)
        if data is None:
            self._generate_model()
            self._save(
                checksum,
                orientations=self.orientations,
                centers=self.centers,
                normals=self.normals,
                depth_offsets=self.depth_offsets,
                surface_areas=self.surface_areas,
            )
        else:
            self.orientations = data["orientations"]
            self.centers = data["centers"]
            self.normals = data["normals"]
            self.depth_offsets = data["depth_offsets"]
            self.surface_areas = data["surface_areas"]
        self.max_surface_area = float(np.max(self.surface_areas))
        self.set_up = True
        return True

    def GetClosestViewIndex(self, body2camera_pose: np.ndarray) -> int:  # noqa: N802
        t = np.asarray(body2camera_pose, np.float32)[:3, 3]
        norm = np.linalg.norm(t)
        if norm == 0.0:
            return 0
        rot = np.asarray(body2camera_pose, np.float32)[:3, :3]
        orientation = rot.T @ (t / norm)
        return int(np.argmax(self.orientations @ orientation))

    def GetClosestView(self, body2camera_pose: np.ndarray):  # noqa: N802
        i = self.GetClosestViewIndex(body2camera_pose)
        return {
            "orientation": self.orientations[i],
            "centers": self.centers[i],
            "normals": self.normals[i],
            "depth_offsets": self.depth_offsets[i],
            "surface_area": float(self.surface_areas[i]),
        }

    # -- generation --------------------------------------------------------------------

    def _generate_model(self) -> None:
        print(f"Start generating depth model {self.name}")
        poses = self._select_geodesic_poses()
        intr = self._model_intrinsics()
        V = len(poses)
        N = self.n_points

        self.orientations = np.zeros((V, 3), np.float32)
        self.centers = np.zeros((V, N, 3), np.float32)
        self.normals = np.zeros((V, N, 3), np.float32)
        self.depth_offsets = np.zeros((V, N, model_base.KMAX_N_DEPTH_OFFSETS), np.float32)
        self.surface_areas = np.zeros((V,), np.float32)

        for i, cam2body in enumerate(poses):
            world2cam = np_pose_inverse(cam2body)
            self.orientations[i] = cam2body[:3, 2]

            tri = self.body_ptr.triangle_vertices_f_body()
            tri_cam = tri @ world2cam[:3, :3].T + world2cam[:3, 3]
            cull = np.full(len(tri), bool(self.body_ptr.geometry_enable_culling), bool)
            depth, _, normal = rasterize_np(
                tri_cam, np.full(len(tri), KMAIN_BODY_ID), intr.fu, intr.fv,
                intr.ppu, intr.ppv, intr.width, intr.height,
                cull_backfaces=cull, with_normals=True,
            )

            # Occlusion silhouette: body minus occlusion bodies (depth_model.cpp:172-179).
            verts = [tri_cam]
            ids = [np.full(len(tri), KMAIN_BODY_ID, np.int32)]
            culls = [cull]
            for b in self.occlusion_body_ptrs:
                t2 = b.triangle_vertices_f_body()
                verts.append(t2 @ world2cam[:3, :3].T + world2cam[:3, 3])
                ids.append(np.full(len(t2), KBACKGROUND_ID, np.int32))
                culls.append(np.full(len(t2), bool(b.geometry_enable_culling), bool))
            _, occlusion_sil = rasterize_np(
                np.concatenate(verts), np.concatenate(ids), intr.fu, intr.fv,
                intr.ppu, intr.ppv, intr.width, intr.height,
                cull_backfaces=np.concatenate(culls),
            )

            inside = occlusion_sil == KMAIN_BODY_ID
            pixel_surface_area = int(np.count_nonzero(inside))
            self.surface_areas[i] = (
                pixel_surface_area * (self.sphere_radius / intr.fu) ** 2
            )
            if pixel_surface_area == 0:
                continue

            # SampleSurfacePointCoordinate (depth_model.cpp:342-351): a fresh
            # per-view std::mt19937{7} rejection-samples raw pixel indices with
            # coordinate = (idx / rows, idx % cols) until one lands on the
            # silhouette — replicated bit-exactly (chunked draws only consume
            # surplus stream values the reference never reads).
            rng = StdMT19937(np.random.SeedSequence().entropy & 0xFFFFFFFF
                             if self.use_random_seed else self.seed)
            h_img, w_img = occlusion_sil.shape
            n_pixels = w_img * h_img
            sel_x = np.empty(N, np.int64)
            sel_y = np.empty(N, np.int64)
            n_found = 0
            while n_found < N:
                idx = rng.draws(1024) % n_pixels
                px = (idx // h_img).astype(np.int64)
                py = (idx % w_img).astype(np.int64)
                ok = inside[py, px]
                take = min(int(ok.sum()), N - n_found)
                sel_x[n_found:n_found + take] = px[ok][:take]
                sel_y[n_found:n_found + take] = py[ok][:take]
                n_found += take
            for j in range(N):
                cx, cy = int(sel_x[j]), int(sel_y[j])
                z = depth[cy, cx]
                if not np.isfinite(z):
                    z = float(np.nanmin(np.where(np.isfinite(depth), depth, np.nan)))
                center_cam = np.array(
                    [(cx - intr.ppu) * z / intr.fu, (cy - intr.ppv) * z / intr.fv, z],
                    np.float32,
                )
                self.centers[i, j] = cam2body[:3, :3] @ center_cam + cam2body[:3, 3]
                self.normals[i, j] = cam2body[:3, :3] @ normal[cy, cx].astype(np.float32)
                pixel_to_meter = float(z) / intr.fu
                self.depth_offsets[i, j] = model_base.calculate_depth_offsets(
                    np.where(np.isfinite(depth), depth, 1e9), (cx, cy),
                    pixel_to_meter, self.max_radius_depth_offset,
                    self.stride_depth_offset,
                )
        print(f"Finish generating depth model {self.name}")
