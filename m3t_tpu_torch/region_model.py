"""RegionModel — sparse viewpoint contour-point model (port of m3t_tpu/region_model.py,
which redesigns m3t/src/region_model.cpp).

Offline (host, cached): for every geodesic view, rasterize the body (plus associated
bodies for multi-region support), extract valid silhouette contours, randomly sample
contour points, approximate 2D normals from contour segments, and measure foreground/
background free distances and depth offsets (region_model.cpp:187-310, 479-782).  The
contours come from :func:`m3t_tpu_torch.utils.contours.find_contours`, which returns
what ``cv2.findContours`` does, so the models equal the JAX package's bit for bit.

Runtime (device): ``pipeline.RegionModelArrays.from_models`` stacks the views;
``GetClosestView`` is an argmax over view-orientation dot products
(region_model.cpp:105-127) followed by a gather.
"""

from __future__ import annotations

import hashlib

import numpy as np

from m3t_tpu_torch import model_base
from m3t_tpu_torch.body import Body
from m3t_tpu_torch.common import np_pose_inverse
from m3t_tpu_torch.model_base import Model
from m3t_tpu_torch.ops.raster import rasterize_np
from m3t_tpu_torch.utils.contours import find_contours
from m3t_tpu_torch.utils.mt19937 import StdMT19937

KCONTOUR_NORMAL_APPROX_RADIUS = 3  # region_model.h:62
KMIN_CONTOUR_LENGTH = 15  # region_model.h:63
KMAX_POINT_SAMPLING_TRIES = 100  # region_model.h:64
KMAX_SURFACE_GRADIENT = 10.0  # region_model.h:65
KBACKGROUND_ID = 0  # region_model.h:69
KMAIN_BODY_ID = 255
KDIFFERENT_BODY_ID = 120


class RegionModel(Model):
    _kVersionID = 10
    _kModelType = "r"

    def __init__(self, name: str, body_ptr: Body, model_path: str, **kwargs):
        metafile_path = kwargs.pop("metafile_path", None)
        super().__init__(name, body_ptr, model_path, metafile_path=metafile_path, **kwargs)
        # Multi-region associated bodies (region_model.h:42-53).
        self.fixed_body_ptrs: list[Body] = []
        self.movable_body_ptrs: list[Body] = []
        self.fixed_same_region_body_ptrs: list[Body] = []
        self.movable_same_region_body_ptrs: list[Body] = []
        # Stacked view arrays (filled by SetUp).
        self.orientations = None  # (V, 3)
        self.centers = None  # (V, N, 3)
        self.normals = None  # (V, N, 3)
        self.foreground_distances = None  # (V, N)
        self.background_distances = None  # (V, N)
        self.depth_offsets = None  # (V, N, 30)
        self.contour_lengths = None  # (V,)
        self.max_contour_length = 0.0

    def AddAssociatedBody(self, body: Body, movable: bool, same_region: bool) -> bool:  # noqa: N802
        self.set_up = False
        target = {
            (False, False): self.fixed_body_ptrs,
            (True, False): self.movable_body_ptrs,
            (False, True): self.fixed_same_region_body_ptrs,
            (True, True): self.movable_same_region_body_ptrs,
        }[(movable, same_region)]
        if any(b.name == body.name for b in target):
            return False
        target.append(body)
        return True

    @property
    def associated_body_ptrs(self) -> list[Body]:
        return (self.fixed_body_ptrs + self.movable_body_ptrs
                + self.fixed_same_region_body_ptrs + self.movable_same_region_body_ptrs)

    # ---------------------------------------------------------------------------------

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        if not self.body_ptr or not self.body_ptr.set_up:
            print(f"Body for region model {self.name} was not set up")
            return False
        for b in self.associated_body_ptrs:
            if not b.set_up:
                print(f"Associated body {b.name} was not set up")
                return False
        if not self._valid_n_depth_offsets():
            return False

        assoc_sig = "|".join(
            f"{kind}:{b.name}:{hashlib_digest(b)}"
            for kind, bodies in (
                ("f", self.fixed_body_ptrs), ("m", self.movable_body_ptrs),
                ("fs", self.fixed_same_region_body_ptrs),
                ("ms", self.movable_same_region_body_ptrs),
            )
            for b in bodies
        )
        # "mt" marks the bit-exact std::mt19937 sampler (invalidates pre-parity
        # caches generated with NumPy PCG64 draws).
        checksum = self._checksum(extra=assoc_sig + "|mt19937")
        data = self._try_load(checksum)
        if data is None:
            self._generate_model()
            self._save(
                checksum,
                orientations=self.orientations,
                centers=self.centers,
                normals=self.normals,
                foreground_distances=self.foreground_distances,
                background_distances=self.background_distances,
                depth_offsets=self.depth_offsets,
                contour_lengths=self.contour_lengths,
            )
        else:
            self.orientations = data["orientations"]
            self.centers = data["centers"]
            self.normals = data["normals"]
            self.foreground_distances = data["foreground_distances"]
            self.background_distances = data["background_distances"]
            self.depth_offsets = data["depth_offsets"]
            self.contour_lengths = data["contour_lengths"]
        self.max_contour_length = float(np.max(self.contour_lengths))
        self.set_up = True
        return True

    def GetClosestViewIndex(self, body2camera_pose: np.ndarray) -> int:  # noqa: N802
        """Argmax dot product over view orientations (region_model.cpp:105-127)."""
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
            "foreground_distances": self.foreground_distances[i],
            "background_distances": self.background_distances[i],
            "depth_offsets": self.depth_offsets[i],
            "contour_length": float(self.contour_lengths[i]),
        }

    # -- generation --------------------------------------------------------------------

    def _render_bodies(self, body_id_pairs, world2camera, intr):
        """Rasterize (body, id) pairs with every body at body2world == identity
        (reference copies bodies to identity poses, model.cpp:182-185)."""
        verts = []
        ids = []
        culls = []
        for body, bid in body_id_pairs:
            tri = body.triangle_vertices_f_body()
            tri_cam = tri @ world2camera[:3, :3].T + world2camera[:3, 3]
            verts.append(tri_cam)
            ids.append(np.full(len(tri), bid, np.int32))
            culls.append(np.full(len(tri), bool(body.geometry_enable_culling), bool))
        tri_cam = np.concatenate(verts)
        return rasterize_np(
            tri_cam, np.concatenate(ids), intr.fu, intr.fv, intr.ppu, intr.ppv,
            intr.width, intr.height, cull_backfaces=np.concatenate(culls),
        )

    def _generate_model(self) -> None:
        print(f"Start generating region model {self.name}")
        poses = self._select_geodesic_poses()
        intr = self._model_intrinsics()
        V = len(poses)
        N = self.n_points

        has_assoc = bool(self.associated_body_ptrs)
        has_occlusion = bool(self.movable_body_ptrs)
        has_same_region = bool(self.fixed_same_region_body_ptrs
                               or self.movable_same_region_body_ptrs)

        self.orientations = np.zeros((V, 3), np.float32)
        self.centers = np.zeros((V, N, 3), np.float32)
        self.normals = np.zeros((V, N, 3), np.float32)
        self.foreground_distances = np.zeros((V, N), np.float32)
        self.background_distances = np.zeros((V, N), np.float32)
        self.depth_offsets = np.zeros((V, N, model_base.KMAX_N_DEPTH_OFFSETS), np.float32)
        self.contour_lengths = np.zeros((V,), np.float32)

        for i, cam2body in enumerate(poses):
            world2cam = np_pose_inverse(cam2body)
            self.orientations[i] = cam2body[:3, 2]

            # Main render: main body + fixed different-region bodies (region_model.cpp:207-211).
            main_pairs = [(self.body_ptr, KMAIN_BODY_ID)] + [
                (b, KDIFFERENT_BODY_ID) for b in self.fixed_body_ptrs
            ]
            depth, sil = self._render_bodies(main_pairs, world2cam, intr)

            renders = {"main_depth": depth, "main_sil": sil}
            if has_occlusion:
                pairs = ([(self.body_ptr, KBACKGROUND_ID)]
                         + [(b, KBACKGROUND_ID) for b in self.fixed_body_ptrs]
                         + [(b, KMAIN_BODY_ID) for b in self.movable_body_ptrs])
                renders["occlusion_sil"] = self._render_bodies(pairs, world2cam, intr)[1]
            if has_same_region:
                pairs = ([(self.body_ptr, KBACKGROUND_ID)]
                         + [(b, KBACKGROUND_ID) for b in self.fixed_body_ptrs]
                         + [(b, KMAIN_BODY_ID) for b in self.fixed_same_region_body_ptrs]
                         + [(b, KMAIN_BODY_ID) for b in self.movable_same_region_body_ptrs])
                renders["same_region_sil"] = self._render_bodies(pairs, world2cam, intr)[1]
            if has_assoc:
                fg_pairs = ([(self.body_ptr, KMAIN_BODY_ID)]
                            + [(b, KBACKGROUND_ID) for b in self.fixed_body_ptrs]
                            + [(b, KBACKGROUND_ID) for b in self.movable_body_ptrs]
                            + [(b, KMAIN_BODY_ID) for b in self.fixed_same_region_body_ptrs])
                bg_pairs = ([(self.body_ptr, KMAIN_BODY_ID)]
                            + [(b, KBACKGROUND_ID) for b in self.fixed_body_ptrs]
                            + [(b, KMAIN_BODY_ID) for b in self.fixed_same_region_body_ptrs]
                            + [(b, KMAIN_BODY_ID) for b in self.movable_same_region_body_ptrs])
                renders["foreground_sil"] = self._render_bodies(fg_pairs, world2cam, intr)[1]
                renders["background_sil"] = self._render_bodies(bg_pairs, world2cam, intr)[1]

            # Per-view generator, exactly like the reference (a fresh
            # std::mt19937{7} inside every GeneratePointData call,
            # region_model.cpp:513-516).
            rng = StdMT19937(np.random.SeedSequence().entropy & 0xFFFFFFFF
                             if self.use_random_seed else self.seed)
            self._generate_point_data(i, renders, cam2body, intr, rng)
        print(f"Finish generating region model {self.name}")

    def _generate_point_data(self, view_idx, renders, cam2body, intr, rng) -> None:
        """GeneratePointData (region_model.cpp:479-554)."""
        sil = renders["main_sil"]
        depth = renders["main_depth"]
        mask = (sil == KMAIN_BODY_ID).astype(np.uint8)

        contours = [c for c in find_contours(mask) if len(c) >= KMIN_CONTOUR_LENGTH]
        pixel_contour_length = sum(len(c) for c in contours)
        if pixel_contour_length == 0:
            self.contour_lengths[view_idx] = 0.0
            return

        pixel_to_meter_view = self.sphere_radius / intr.fu
        max_depth_difference = pixel_to_meter_view * KMAX_SURFACE_GRADIENT

        # Validate contour points (IsContourPointValid, cpp:599-642).
        all_pts = np.concatenate(contours)
        valid = self._valid_contour_points(all_pts, renders, depth, sil,
                                           max_depth_difference, intr)
        valid_pts = all_pts[valid]
        contour_length = float(len(valid_pts)) * pixel_to_meter_view
        self.contour_lengths[view_idx] = contour_length
        if contour_length == 0.0:
            return

        # Map each contour point to (contour id, index) for segment lookup.
        point_lookup = {}
        for ci, c in enumerate(contours):
            for pi, p in enumerate(c):
                point_lookup.setdefault((int(p[0]), int(p[1])), (ci, pi))

        n_tries = 0
        j = 0
        while j < self.n_points:
            if n_tries > KMAX_POINT_SAMPLING_TRIES:
                self.contour_lengths[view_idx] = 0.0
                return
            n_tries += 1
            # SampleContourPointCoordinate: generator() % size
            # (region_model.cpp:644-649), bit-exact draw sequence.
            center = valid_pts[rng.next() % len(valid_pts)]
            cx, cy = int(center[0]), int(center[1])

            # Contour segment around the point -> approximate 2D normal (cpp:651-692).
            ci, pi = point_lookup[(cx, cy)]
            contour = contours[ci]
            r = KCONTOUR_NORMAL_APPROX_RADIUS
            idx = (np.arange(pi - r, pi + r + 1)) % len(contour)
            segment = contour[idx]
            seg_vec = segment[-1] - segment[0]
            if np.hypot(*seg_vec.astype(np.float64)) <= r:
                continue
            normal2 = np.array([-float(seg_vec[1]), float(seg_vec[0])], np.float64)
            normal2 /= np.linalg.norm(normal2)

            z = depth[cy, cx]
            if not np.isfinite(z):
                continue
            center_cam = np.array(
                [(cx - intr.ppu) * z / intr.fu, (cy - intr.ppv) * z / intr.fv, z],
                np.float32,
            )
            self.centers[view_idx, j] = cam2body[:3, :3] @ center_cam + cam2body[:3, 3]
            normal3 = np.array([normal2[0], normal2[1], 0.0], np.float32)
            self.normals[view_idx, j] = cam2body[:3, :3] @ normal3

            pixel_to_meter = float(z) / intr.fu
            self.depth_offsets[view_idx, j] = model_base.calculate_depth_offsets(
                np.where(np.isfinite(depth), depth, 1e9), (cx, cy), pixel_to_meter,
                self.max_radius_depth_offset, self.stride_depth_offset,
            )

            fg_d, bg_d = self._line_distances(
                renders, contours, (cx, cy), normal2, pixel_to_meter, intr
            )
            self.foreground_distances[view_idx, j] = fg_d
            self.background_distances[view_idx, j] = bg_d
            j += 1
            n_tries = 0

    def _valid_contour_points(self, pts, renders, depth, sil, max_depth_difference,
                              intr) -> np.ndarray:
        """IsContourPointValid (cpp:599-642), vectorized over points."""
        h, w = sil.shape
        x = pts[:, 0]
        y = pts[:, 1]
        nx = np.stack([x, x, x + 1, x - 1])
        ny = np.stack([y + 1, y - 1, y, y])
        nx = np.clip(nx, 0, w - 1)
        ny = np.clip(ny, 0, h - 1)
        valid = np.ones(len(pts), bool)

        if "same_region_sil" in renders:
            sr = renders["same_region_sil"]
            valid &= np.all(sr[ny, nx] == KBACKGROUND_ID, axis=0)
        if "occlusion_sil" in renders:
            oc = renders["occlusion_sil"]
            valid &= oc[y, x] == KBACKGROUND_ID

        neighbor_is_fixed = sil[ny, nx] == KDIFFERENT_BODY_ID
        n_fixed = neighbor_is_fixed.sum(axis=0)
        has_fixed = n_fixed > 0
        if has_fixed.any():
            ndepth = np.where(neighbor_is_fixed, depth[ny, nx], 0.0)
            mean_fixed = ndepth.sum(axis=0) / np.maximum(n_fixed, 1)
            center_depth = depth[y, x]
            occluding = has_fixed & (mean_fixed < center_depth - max_depth_difference)
            valid &= ~occluding
        return valid

    def _line_distances(self, renders, contours, center, normal, pixel_to_meter,
                        intr):
        """CalculateLineDistances (cpp:694-766)."""
        fg_sil = renders.get("foreground_sil", renders["main_sil"])
        bg_sil = renders.get("background_sil", renders["main_sil"])
        cx, cy = center
        nx, ny = float(normal[0]), float(normal[1])
        if abs(ny) < abs(nx):
            u_step = float(np.sign(nx))
            v_step = ny / abs(nx)
        else:
            u_step = nx / abs(ny)
            v_step = float(np.sign(ny))

        size = self.image_size

        # Inward: first pixel leaving the main-body region.
        u = cx + 0.5
        v = cy + 0.5
        fg_distance = 0.0
        while True:
            u -= u_step
            v -= v_step
            if int(u) < 0 or int(u) >= size or int(v) < 0 or int(v) >= size:
                fg_distance = float("inf")
                break
            if fg_sil[int(v), int(u)] != KMAIN_BODY_ID:
                pu, pv = self._closest_contour_point(contours, u + u_step - 0.5,
                                                     v + v_step - 0.5)
                fg_distance = pixel_to_meter * float(np.hypot(pu - cx, pv - cy))
                break

        # Outward: first pixel re-entering a main-body region.
        u = cx + 0.5
        v = cy + 0.5
        bg_distance = 0.0
        while True:
            u += u_step
            v += v_step
            if int(u) < 0 or int(u) >= size or int(v) < 0 or int(v) >= size:
                bg_distance = np.finfo(np.float32).max
                break
            if bg_sil[int(v), int(u)] == KMAIN_BODY_ID:
                pu, pv = self._closest_contour_point(contours, u - 0.5, v - 0.5)
                bg_distance = pixel_to_meter * float(np.hypot(pu - cx, pv - cy))
                break
        return fg_distance, bg_distance

    @staticmethod
    def _closest_contour_point(contours, u, v):
        best = (0, 0)
        best_d = np.inf
        for c in contours:
            d = np.hypot(c[:, 0] - u, c[:, 1] - v)
            i = int(np.argmin(d))
            if d[i] < best_d:
                best_d = d[i]
                best = (int(c[i, 0]), int(c[i, 1]))
        return best


def hashlib_digest(body: Body) -> str:
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(body.vertices).tobytes())
    h.update(np.ascontiguousarray(body.geometry2body_pose).tobytes())
    return h.hexdigest()[:16]
