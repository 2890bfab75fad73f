"""TextureModality: keypoint matching against reconstructed keyframes (port of
m3t_tpu/texture_modality.py; reference m3t/src/texture_modality.cpp, the ICG+ texture
cue).

A host modality in numpy, as in the JAX package: feature detection, description and
matching run in OpenCV (imported where they run); keyframe 3D points are reconstructed
by unprojecting keypoints through the focused silhouette renderer's depth
(texture_modality.cpp:933-1022), whose images it reads back from the renderer's device;
and the Tukey-weighted reprojection Gauss-Newton terms (cpp:397-444) are computed over
the matched point set in float64.  Its gradient and Hessian are float32 numpy arrays,
which the Link adds to the other modalities' terms.
"""

from __future__ import annotations

import collections

import numpy as np

from m3t_tpu_torch.common import to_numpy
from m3t_tpu_torch.modality import Modality
from m3t_tpu_torch.utils import yaml_io

KREGION_OF_INTEREST_MARGIN = 10  # texture_modality.h:132
KMAX_N_OCCLUSION_STRIDES = 5


class TextureModality(Modality):
    def __init__(self, name: str, body_ptr, color_camera_ptr,
                 focused_silhouette_renderer_ptr, metafile_path: str | None = None):
        super().__init__(name, body_ptr, metafile_path)
        self.color_camera_ptr = color_camera_ptr
        self.silhouette_renderer_ptr = focused_silhouette_renderer_ptr

        # Parameters (defaults: texture_modality.h:400-428)
        self.descriptor_type = "ORB"
        self.focused_image_size = 200
        self.descriptor_distance_threshold = 0.7
        self.tukey_norm_constant = 20.0
        self.standard_deviations = [15.0, 5.0]
        self.max_keyframe_rotation_difference = 10.0 * np.pi / 180.0
        self.max_keyframe_age = 100
        self.n_keyframes = 1
        self.orb_n_features = 300
        self.orb_scale_factor = 1.2
        self.orb_n_levels = 3
        self.brisk_threshold = 25
        self.brisk_octave = 3
        self.brisk_pattern_scale = 0.6
        self.sift_n_features = 0
        self.sift_n_octave_layers = 5
        self.sift_contrast_threshold = 0.04
        self.sift_edge_threshold = 10.0
        self.sift_sigma = 0.7
        self.daisy_radius = 7.0
        self.daisy_q_radius = 3
        self.daisy_q_theta = 4
        self.daisy_q_hist = 8
        self.freak_orientation_normalized = True
        self.freak_scale_normalized = True
        self.freak_pattern_scale = 18.0
        self.freak_n_octaves = 4

        self.measure_occlusions = False
        self.measured_occlusion_radius = 0.01
        self.measured_occlusion_threshold = 0.03
        self.model_occlusions = False
        self.modeled_occlusion_radius = 0.01
        self.modeled_occlusion_threshold = 0.03

        # Visualization flags (texture_modality.h visualization section).
        self.visualize_correspondences_correspondence = False
        self.visualize_points_result = False

        self.depth_camera_ptr = None
        self.depth_renderer_ptr = None

        # State
        self._detector = None
        self._descriptor = None
        self._matcher = None
        self._keypoints = None  # (N, 2) float32 full-image coordinates
        self._descriptors = None
        self._points_keyframes = collections.deque()
        self._descriptors_keyframes = collections.deque()
        self._orientation_last_keyframe = np.zeros(3, np.float32)
        self.keyframe_age = 0
        self.data_points_3d = np.zeros((0, 3), np.float32)
        self.data_points_2d = np.zeros((0, 2), np.float32)
        self._variance = 1.0

    # -- configuration -----------------------------------------------------------------

    def MeasureOcclusions(self, depth_camera_ptr) -> None:  # noqa: N802
        self.depth_camera_ptr = depth_camera_ptr
        self.measure_occlusions = True
        self.set_up = False

    def ModelOcclusions(self, depth_renderer_ptr) -> None:  # noqa: N802
        self.depth_renderer_ptr = depth_renderer_ptr
        self.model_occlusions = True
        self.set_up = False

    def _load_metadata(self) -> bool:
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)
        g = lambda key, cur: yaml_io.read_optional(fs, key, cur)  # noqa: E731
        self.descriptor_type = g("descriptor_type", self.descriptor_type)
        self.focused_image_size = int(g("focused_image_size",
                                        self.focused_image_size))
        self.descriptor_distance_threshold = float(g(
            "descriptor_distance_threshold", self.descriptor_distance_threshold))
        self.tukey_norm_constant = float(g("tukey_norm_constant",
                                           self.tukey_norm_constant))
        stds = g("standard_deviations", None)
        if stds is not None:
            self.standard_deviations = [float(v) for v in stds]
        self.max_keyframe_rotation_difference = float(g(
            "max_keyframe_rotation_difference",
            self.max_keyframe_rotation_difference))
        self.max_keyframe_age = int(g("max_keyframe_age", self.max_keyframe_age))
        self.n_keyframes = int(g("n_keyframes", self.n_keyframes))
        self.orb_n_features = int(g("orb_n_features", self.orb_n_features))
        self.orb_scale_factor = float(g("orb_scale_factor", self.orb_scale_factor))
        self.orb_n_levels = int(g("orb_n_levels", self.orb_n_levels))
        self.brisk_threshold = int(g("brisk_threshold", self.brisk_threshold))
        self.brisk_octave = int(g("brisk_octave", self.brisk_octave))
        self.brisk_pattern_scale = float(g("brisk_pattern_scale",
                                           self.brisk_pattern_scale))
        self.daisy_radius = float(g("daisy_radius", self.daisy_radius))
        self.daisy_q_radius = int(g("daisy_q_radius", self.daisy_q_radius))
        self.daisy_q_theta = int(g("daisy_q_theta", self.daisy_q_theta))
        self.daisy_q_hist = int(g("daisy_q_hist", self.daisy_q_hist))
        self.freak_orientation_normalized = bool(g(
            "freak_orientation_normalized", self.freak_orientation_normalized))
        self.freak_scale_normalized = bool(g(
            "freak_scale_normalized", self.freak_scale_normalized))
        self.freak_pattern_scale = float(g("freak_pattern_scale",
                                           self.freak_pattern_scale))
        self.freak_n_octaves = int(g("freak_n_octaves", self.freak_n_octaves))
        self.measured_occlusion_radius = float(g(
            "measured_occlusion_radius", self.measured_occlusion_radius))
        self.measured_occlusion_threshold = float(g(
            "measured_occlusion_threshold", self.measured_occlusion_threshold))
        self.modeled_occlusion_radius = float(g(
            "modeled_occlusion_radius", self.modeled_occlusion_radius))
        self.modeled_occlusion_threshold = float(g(
            "modeled_occlusion_threshold", self.modeled_occlusion_threshold))
        return True

    def SetUp(self) -> bool:  # noqa: N802
        import cv2

        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        required = [("body", self.body_ptr), ("color camera", self.color_camera_ptr),
                    ("silhouette renderer", self.silhouette_renderer_ptr)]
        if self.measure_occlusions:
            required.append(("depth camera", self.depth_camera_ptr))
        if self.model_occlusions:
            required.append(("depth renderer", self.depth_renderer_ptr))
        for label, ptr in required:
            if ptr is None or not ptr.set_up:
                print(f"{label} for texture modality {self.name} was not set up")
                return False

        # Feature machinery (texture_modality.cpp:{SetUpFeatureDetectorAndMatcher}).
        dtype = self.descriptor_type.upper()
        if dtype == "ORB":
            self._detector = cv2.ORB_create(
                nfeatures=self.orb_n_features, scaleFactor=self.orb_scale_factor,
                nlevels=self.orb_n_levels)
            self._descriptor = self._detector
            self._matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
        elif dtype == "BRISK":
            self._detector = cv2.BRISK_create(
                thresh=self.brisk_threshold, octaves=self.brisk_octave,
                patternScale=self.brisk_pattern_scale)
            self._descriptor = self._detector
            self._matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
        elif dtype == "SIFT":
            self._detector = cv2.SIFT_create(
                nfeatures=self.sift_n_features,
                nOctaveLayers=self.sift_n_octave_layers,
                contrastThreshold=self.sift_contrast_threshold,
                edgeThreshold=self.sift_edge_threshold, sigma=self.sift_sigma)
            self._descriptor = self._detector
            self._matcher = cv2.BFMatcher(cv2.NORM_L2)
        elif dtype == "DAISY":
            # Reference: ORB detector + DAISY descriptor, L2 matching
            # (texture_modality.cpp:748-753, 794-797).  Falls back to the native
            # implementation when OpenCV lacks the contrib module.
            from m3t_tpu_torch.utils import features
            self._detector = cv2.ORB_create(
                nfeatures=self.orb_n_features, scaleFactor=self.orb_scale_factor,
                nlevels=self.orb_n_levels)
            if hasattr(cv2, "xfeatures2d"):
                self._descriptor = cv2.xfeatures2d.DAISY_create(
                    radius=self.daisy_radius, q_radius=self.daisy_q_radius,
                    q_theta=self.daisy_q_theta, q_hist=self.daisy_q_hist)
            else:
                self._descriptor = features.DaisyDescriptor(
                    radius=self.daisy_radius, q_radius=self.daisy_q_radius,
                    q_theta=self.daisy_q_theta, q_hist=self.daisy_q_hist)
            self._matcher = cv2.BFMatcher(cv2.NORM_L2)
        elif dtype == "FREAK":
            # Reference: ORB detector + FREAK descriptor, Hamming matching
            # (texture_modality.cpp:754-760).
            from m3t_tpu_torch.utils import features
            self._detector = cv2.ORB_create(
                nfeatures=self.orb_n_features, scaleFactor=self.orb_scale_factor,
                nlevels=self.orb_n_levels)
            if hasattr(cv2, "xfeatures2d"):
                self._descriptor = cv2.xfeatures2d.FREAK_create(
                    orientationNormalized=self.freak_orientation_normalized,
                    scaleNormalized=self.freak_scale_normalized,
                    patternScale=self.freak_pattern_scale,
                    nOctaves=self.freak_n_octaves)
            else:
                self._descriptor = features.FreakDescriptor(
                    orientation_normalized=self.freak_orientation_normalized,
                    scale_normalized=self.freak_scale_normalized,
                    pattern_scale=self.freak_pattern_scale,
                    n_octaves=self.freak_n_octaves)
            self._matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
        else:
            print(f"Descriptor type {self.descriptor_type} not supported")
            return False

        self._points_keyframes.clear()
        self._descriptors_keyframes.clear()
        self.keyframe_age = 0
        self.set_up = True
        return True

    # -- helpers -----------------------------------------------------------------------

    def _body2camera_pose(self) -> np.ndarray:
        return self.color_camera_ptr.world2camera_pose @ self.body_ptr.body2world_pose

    def _detect_keypoints(self):
        """DetectAndComputeCorrKeypoints (cpp:858-888): detect on a body-focused crop."""
        import cv2

        self._keypoints = np.zeros((0, 2), np.float32)
        self._descriptors = None
        roi_scale = self._scale_and_roi()
        if roi_scale is None:
            return
        (u_min, v_min, w, h), scale = roi_scale
        image = self.color_camera_ptr.image
        gray = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
        crop = cv2.resize(gray[v_min:v_min + h, u_min:u_min + w], None,
                          fx=scale, fy=scale)
        keypoints = self._detector.detect(crop, None)
        keypoints, descriptors = self._descriptor.compute(crop, keypoints)
        if not keypoints:
            return
        pts = np.array([[u_min + kp.pt[0] / scale, v_min + kp.pt[1] / scale]
                        for kp in keypoints], np.float32)
        self._keypoints = pts
        self._descriptors = descriptors

    def _scale_and_roi(self):
        """CalculateScaleAndRegionOfInterest (cpp:890-931)."""
        intr = self.color_camera_ptr.intrinsics
        pose = self._body2camera_pose()
        r = 0.5 * self.body_ptr.maximum_body_diameter
        x, y, z = pose[0, 3], pose[1, 3], pose[2, 3]
        if z < r * 1.5:
            return None
        z2_r2 = z * z - r * r
        z3_zr2 = z2_r2 * z
        r_u = intr.fu * (abs(x) * r * r + r * z * np.sqrt(z2_r2 + x * x)) / z3_zr2
        r_v = intr.fv * (abs(y) * r * r + r * z * np.sqrt(z2_r2 + y * y)) / z3_zr2
        cu = x * intr.fu / z + intr.ppu
        cv_ = y * intr.fv / z + intr.ppv
        u_min = max(int(cu - r_u - KREGION_OF_INTEREST_MARGIN + 0.5), 0)
        u_max = min(int(cu + r_u + KREGION_OF_INTEREST_MARGIN + 0.5), intr.width - 1)
        v_min = max(int(cv_ - r_v - KREGION_OF_INTEREST_MARGIN + 0.5), 0)
        v_max = min(int(cv_ + r_v + KREGION_OF_INTEREST_MARGIN + 0.5), intr.height - 1)
        if u_min >= u_max or v_min >= v_max:
            return None
        scale = self.focused_image_size / max(2.0 * r_u, 2.0 * r_v)
        return (u_min, v_min, u_max - u_min, v_max - v_min), scale

    def _compute_keyframe_data(self):
        """ComputeKeyframeData (cpp:933-995): reconstruct 3D points + store descriptors."""
        if len(self._points_keyframes) >= self.n_keyframes:
            self._points_keyframes.popleft()
            self._descriptors_keyframes.popleft()

        renderer = self.silhouette_renderer_ptr
        if not renderer.IsBodyVisible(self.body_ptr.name):
            return
        if self._descriptors is None or len(self._keypoints) == 0:
            self._points_keyframes.append(np.zeros((0, 3), np.float32))
            self._descriptors_keyframes.append(None)
            return

        pose = self._body2camera_pose()
        camera2body = np.linalg.inv(pose.astype(np.float64)).astype(np.float32)
        intr = self.color_camera_ptr.intrinsics
        sil = to_numpy(renderer.focused_silhouette_image())
        depth = to_numpy(renderer.focused_depth_image())
        size = sil.shape[0]

        pts = self._keypoints
        us = ((pts[:, 0] - renderer.corner_u) * renderer.scale + 0.5).astype(np.int32)
        vs = ((pts[:, 1] - renderer.corner_v) * renderer.scale + 0.5).astype(np.int32)
        inb = (us >= 0) & (us <= size - 1) & (vs >= 0) & (vs <= size - 1)
        us_c = np.clip(us, 0, size - 1)
        vs_c = np.clip(vs, 0, size - 1)
        on_body = inb & (sil[vs_c, us_c] == self.body_ptr.body_id)
        z = np.where(on_body, depth[vs_c, us_c], 0.0)
        valid = on_body & np.isfinite(z) & (z > 0)

        cams = np.stack([
            z * (pts[:, 0] - intr.ppu) / intr.fu,
            z * (pts[:, 1] - intr.ppv) / intr.fv,
            z,
        ], axis=1).astype(np.float32)
        body_pts = cams @ camera2body[:3, :3].T + camera2body[:3, 3]

        if self.measure_occlusions and valid.any():
            valid &= self._unoccluded_measured(body_pts)
        if self.model_occlusions and valid.any():
            if self.depth_renderer_ptr.IsBodyVisible(self.body_ptr.name):
                valid &= self._unoccluded_modeled(body_pts, pose)

        self._points_keyframes.append(body_pts[valid])
        self._descriptors_keyframes.append(self._descriptors[valid])

        t = pose[:3, 3]
        norm = np.linalg.norm(t)
        self._orientation_last_keyframe = (
            pose[:3, :3].T @ (t / norm) if norm > 0 else np.zeros(3, np.float32))
        self.keyframe_age = 0

    def _unoccluded_measured(self, body_pts: np.ndarray) -> np.ndarray:
        dc = self.depth_camera_ptr
        di = dc.intrinsics
        pose = dc.world2camera_pose @ self.body_ptr.body2world_pose
        c = body_pts @ pose[:3, :3].T + pose[:3, 3]
        z = c[:, 2]
        image = np.asarray(dc.image, np.float32)
        out = np.ones(len(body_pts), bool)
        for i, (p, zi) in enumerate(zip(c, z)):
            if zi <= 0:
                out[i] = False
                continue
            cu = p[0] * di.fu / zi + di.ppu
            cv_ = p[1] * di.fv / zi + di.ppv
            diameter = 2.0 * self.measured_occlusion_radius * di.fu / zi
            stride = int(diameter / KMAX_N_OCCLUSION_STRIDES + 1.0)
            n_strides = int(diameter / stride + 0.5)
            rounded = n_strides * stride
            u0 = max(int(cu - rounded / 2 + 0.5), 0)
            v0 = max(int(cv_ - rounded / 2 + 0.5), 0)
            u1 = min(u0 + rounded, di.width - 1)
            v1 = min(v0 + rounded, di.height - 1)
            window = image[v0:v1 + 1:stride, u0:u1 + 1:stride]
            min_depth = (zi - self.measured_occlusion_threshold) / dc.depth_scale
            if ((window > 0) & (window < min_depth)).any():
                out[i] = False
        return out

    def _unoccluded_modeled(self, body_pts: np.ndarray, pose: np.ndarray) -> np.ndarray:
        renderer = self.depth_renderer_ptr
        intr = self.color_camera_ptr.intrinsics
        depth = to_numpy(renderer.focused_depth_image())
        size = depth.shape[0]
        c = body_pts @ pose[:3, :3].T + pose[:3, 3]
        out = np.ones(len(body_pts), bool)
        for i, p in enumerate(c):
            z = p[2]
            if z <= 0:
                out[i] = False
                continue
            cu = p[0] * intr.fu / z + intr.ppu
            cv_ = p[1] * intr.fv / z + intr.ppv
            fu_c = (cu - renderer.corner_u) * renderer.scale
            fv_c = (cv_ - renderer.corner_v) * renderer.scale
            meter_to_pixel = (intr.fu / z) * renderer.scale
            diameter = 2.0 * self.modeled_occlusion_radius * meter_to_pixel
            stride = int(diameter / KMAX_N_OCCLUSION_STRIDES + 1.0)
            n_strides = int(diameter / stride + 0.5)
            rounded = n_strides * stride
            u0 = max(int(fu_c - rounded / 2 + 0.5), 0)
            v0 = max(int(fv_c - rounded / 2 + 0.5), 0)
            u1 = min(u0 + rounded, size - 1)
            v1 = min(v0 + rounded, size - 1)
            window = depth[v0:v1 + 1:stride, u0:u1 + 1:stride]
            min_allowed = z - self.modeled_occlusion_threshold
            if np.isfinite(window).any() and np.nanmin(
                    np.where(np.isfinite(window), window, np.inf)) <= min_allowed:
                out[i] = False
        return out

    # -- protocol ----------------------------------------------------------------------

    def StartModality(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up texture modality {self.name} first")
            return False
        self._detect_keypoints()
        self._compute_keyframe_data()
        return True

    def CalculateCorrespondences(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up texture modality {self.name} first")
            return False
        std = self.standard_deviations[
            min(corr_iteration, len(self.standard_deviations) - 1)]
        self._variance = std * std
        if corr_iteration > 0:
            return True

        self._detect_keypoints()
        pts3d = []
        pts2d = []
        if self._descriptors is not None and len(self._keypoints):
            for points_kf, descriptors_kf in zip(self._points_keyframes,
                                                 self._descriptors_keyframes):
                if descriptors_kf is None or len(descriptors_kf) == 0:
                    continue
                matches = self._matcher.knnMatch(descriptors_kf, self._descriptors, k=2)
                for knn in matches:
                    if len(knn) < 2:
                        continue
                    if knn[1].distance <= 0:
                        continue
                    if knn[0].distance / knn[1].distance \
                            >= self.descriptor_distance_threshold:
                        continue
                    pts3d.append(points_kf[knn[0].queryIdx])
                    pts2d.append(self._keypoints[knn[0].trainIdx])
        self.data_points_3d = (np.asarray(pts3d, np.float32).reshape(-1, 3))
        self.data_points_2d = (np.asarray(pts2d, np.float32).reshape(-1, 2))
        return True

    def CalculateGradientAndHessian(self, iteration: int, corr_iteration: int,
                                    opt_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up texture modality {self.name} first")
            return False
        pose = self._body2camera_pose().astype(np.float64)
        intr = self.color_camera_ptr.intrinsics
        gradient = np.zeros(6, np.float64)
        hessian = np.zeros((6, 6), np.float64)

        if len(self.data_points_3d):
            rot = pose[:3, :3]
            c = self.data_points_3d @ rot.T + pose[:3, 3]
            x, y, z = c[:, 0], c[:, 1], c[:, 2]
            z_ok = z > 1e-6
            z = np.where(z_ok, z, 1.0)
            proj = np.stack([x * intr.fu / z + intr.ppu,
                             y * intr.fv / z + intr.ppv], axis=1)
            diff = proj - self.data_points_2d
            squared_error = np.sum(diff * diff, axis=1)
            error = np.sqrt(squared_error)

            k = self.tukey_norm_constant
            inside = np.abs(error) <= k
            tukey = np.where(
                inside,
                (k * k / 6.0) * (1.0 - (1.0 - (error / k) ** 2) ** 3),
                k * k / 6.0)
            weight = np.where(error > 1e-30, tukey / np.maximum(squared_error, 1e-30),
                              1.0) / self._variance
            weight = np.where(z_ok, weight, 0.0)

            z2 = z * z
            # dx_dX rows per point: [[fu/z, 0, -x fu/z^2], [0, fv/z, -y fv/z^2]]
            dx_dX = np.zeros((len(c), 2, 3), np.float64)
            dx_dX[:, 0, 0] = intr.fu / z
            dx_dX[:, 0, 2] = -x * intr.fu / z2
            dx_dX[:, 1, 1] = intr.fv / z
            dx_dX[:, 1, 2] = -y * intr.fv / z2
            dx_dt = dx_dX @ rot  # (N, 2, 3)
            skews = np.zeros((len(c), 3, 3), np.float64)
            p = self.data_points_3d
            skews[:, 0, 1] = -p[:, 2]
            skews[:, 0, 2] = p[:, 1]
            skews[:, 1, 0] = p[:, 2]
            skews[:, 1, 2] = -p[:, 0]
            skews[:, 2, 0] = -p[:, 1]
            skews[:, 2, 1] = p[:, 0]
            dx_dtheta = np.concatenate([-dx_dt @ skews, dx_dt], axis=2)  # (N, 2, 6)

            gradient -= np.einsum("n,nk,nkj->j", weight, diff, dx_dtheta)
            hessian -= np.einsum("n,nki,nkj->ij", weight, dx_dtheta, dx_dtheta)

        self.gradient = gradient.astype(np.float32)
        self.hessian = hessian.astype(np.float32)
        return True

    def VisualizeCorrespondences(self, save_idx: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        if not (self.display_visualization or self.save_visualizations):
            return True
        if self.visualize_correspondences_correspondence:
            self._show("correspondences_correspondence", save_idx,
                       self._correspondence_image())
        return True

    def VisualizeResults(self, save_idx: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        if self.visualize_pose_result:
            print(f"body2world_pose {self.name}:\n{self.body_ptr.body2world_pose}")
        if not (self.display_visualization or self.save_visualizations):
            return True
        if self.visualize_points_result:
            self._show("points_result", save_idx, self._correspondence_image())
        return True

    def _correspondence_image(self) -> np.ndarray:
        """Matched keypoints (yellow) + reprojected keyframe points (red),
        texture_modality.cpp visualization helpers."""
        import cv2

        from m3t_tpu_torch.utils import visualization

        image = np.asarray(self.color_camera_ptr.image).copy()
        pose = self._body2camera_pose()
        intr = self.color_camera_ptr.intrinsics
        if len(self.data_points_3d):
            c = self.data_points_3d @ pose[:3, :3].T + pose[:3, 3]
            visualization.draw_points(image, c, intr.fu, intr.fv, intr.ppu,
                                      intr.ppv, color=(61, 63, 179))
            for uv in self.data_points_2d:
                u, v = int(uv[0] + 0.5), int(uv[1] + 0.5)
                if 0 <= u < image.shape[1] and 0 <= v < image.shape[0]:
                    cv2.circle(image, (u, v), 1, (24, 184, 234), -1)
        return image

    def _show(self, title: str, save_idx: int, image) -> None:
        from m3t_tpu_torch.utils import visualization

        visualization.show_and_save_image(
            f"{self.name}_{title}", save_idx, image, self.display_visualization,
            self.save_visualizations, self.save_directory, self.save_image_type)

    def CalculateResults(self, iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up texture modality {self.name} first")
            return False
        pose = self._body2camera_pose()
        t = pose[:3, 3]
        norm = np.linalg.norm(t)
        orientation = pose[:3, :3].T @ (t / norm) if norm > 0 else np.zeros(3)
        dot = float(np.clip(np.dot(orientation, self._orientation_last_keyframe),
                            -1.0, 1.0))
        rotation_difference = np.arccos(dot)
        self.keyframe_age += 1
        if (rotation_difference > self.max_keyframe_rotation_difference
                or self.keyframe_age > self.max_keyframe_age):
            self._compute_keyframe_data()
        return True

    # -- referenced objects ------------------------------------------------------------

    def camera_ptrs(self) -> list:
        out = [self.color_camera_ptr]
        if self.measure_occlusions and self.depth_camera_ptr:
            out.append(self.depth_camera_ptr)
        return out

    def model_ptr(self):
        return None

    def _renderers(self) -> list:
        out = [self.silhouette_renderer_ptr]
        if self.model_occlusions and self.depth_renderer_ptr:
            out.append(self.depth_renderer_ptr)
        return out

    def start_modality_renderer_ptrs(self) -> list:
        return self._renderers()

    def correspondence_renderer_ptrs(self) -> list:
        return self._renderers()

    def results_renderer_ptrs(self) -> list:
        return self._renderers()
