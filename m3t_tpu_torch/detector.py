"""Detectors: pose initialization (port of m3t_tpu/detector.py; reference
m3t/src/{detector,static_detector,manual_detector}.cpp).

StaticDetector assigns a fixed link2world pose; ManualDetector solves EPnP from four
user-provided 2D-3D correspondences (manual_detector.cpp:151-180).
"""

from __future__ import annotations

import numpy as np

from m3t_tpu_torch.utils import yaml_io


class Detector:
    def __init__(self, name: str, reset_joint_poses: bool = True,
                 metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.reset_joint_poses = bool(reset_joint_poses)
        self.set_up = False

    @property
    def optimizer_ptrs(self) -> list:
        return []

    @property
    def camera_ptr(self):
        return None

    def SetUp(self) -> bool:  # noqa: N802
        raise NotImplementedError

    def DetectPoses(self, names, detected_names: set) -> bool:  # noqa: N802
        raise NotImplementedError

    def UpdatePoses(self, link2world_pose: np.ndarray, optimizer) -> None:  # noqa: N802
        """Assign root pose + optional joint reset (detector.cpp:43-55)."""
        root = optimizer.root_link_ptr
        root.set_link2world_pose(link2world_pose)
        if self.reset_joint_poses:
            for link in optimizer.ReferencedLinks():
                link.ResetJointPoses()
        optimizer.CalculateConsistentPoses()


class StaticDetector(Detector):
    def __init__(self, name: str, optimizer_ptr=None,
                 link2world_pose: np.ndarray | None = None,
                 reset_joint_poses: bool = True, metafile_path: str | None = None):
        super().__init__(name, reset_joint_poses, metafile_path)
        self.optimizer_ptr = optimizer_ptr
        self.link2world_pose = (np.eye(4, dtype=np.float32)
                                if link2world_pose is None
                                else np.asarray(link2world_pose, np.float32))

    @property
    def optimizer_ptrs(self) -> list:
        return [self.optimizer_ptr] if self.optimizer_ptr else []

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            fs = yaml_io.open_yaml_file_storage(self.metafile_path)
            self.link2world_pose = yaml_io.read_pose(fs, "link2world_pose")
            self.reset_joint_poses = bool(yaml_io.read_optional(
                fs, "reset_joint_poses", self.reset_joint_poses))
        if self.optimizer_ptr is None or not self.optimizer_ptr.set_up:
            print(f"Optimizer for static detector {self.name} was not set up")
            return False
        self.set_up = True
        return True

    def DetectPoses(self, names, detected_names: set) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up static detector {self.name} first")
            return False
        if self.optimizer_ptr.name in names:
            self.UpdatePoses(self.link2world_pose, self.optimizer_ptr)
            detected_names.add(self.optimizer_ptr.name)
        return True


class ManualDetector(Detector):
    """Click-4-points EPnP initialization (manual_detector.cpp).

    In headless use, ``detector_points2d`` can be provided programmatically instead of
    clicking; the pose is solved with cv2.solvePnP(EPNP) like the reference (cpp:151-180).
    """

    def __init__(self, name: str, optimizer_ptr=None, color_camera_ptr=None,
                 reference_points3d=None, detector_points2d=None,
                 reset_joint_poses: bool = True, metafile_path: str | None = None):
        super().__init__(name, reset_joint_poses, metafile_path)
        self.optimizer_ptr = optimizer_ptr
        self.color_camera_ptr = color_camera_ptr
        self.reference_points3d = (np.zeros((4, 3), np.float32)
                                   if reference_points3d is None
                                   else np.asarray(reference_points3d, np.float32))
        self.detector_points2d = (None if detector_points2d is None
                                  else np.asarray(detector_points2d, np.float32))

    @property
    def optimizer_ptrs(self) -> list:
        return [self.optimizer_ptr] if self.optimizer_ptr else []

    @property
    def camera_ptr(self):
        return self.color_camera_ptr

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            fs = yaml_io.open_yaml_file_storage(self.metafile_path)
            pts = yaml_io.read_optional(fs, "reference_points", None)
            if pts is not None:
                self.reference_points3d = np.asarray(pts, np.float32).reshape(-1, 3)
            self.reset_joint_poses = bool(yaml_io.read_optional(
                fs, "reset_joint_poses", self.reset_joint_poses))
        if self.optimizer_ptr is None or not self.optimizer_ptr.set_up:
            print(f"Optimizer for manual detector {self.name} was not set up")
            return False
        if self.color_camera_ptr is None or not self.color_camera_ptr.set_up:
            print(f"Camera for manual detector {self.name} was not set up")
            return False
        self.set_up = True
        return True

    def _acquire_points2d(self) -> np.ndarray | None:
        if self.detector_points2d is not None:
            return self.detector_points2d
        import cv2

        points: list = []

        def on_mouse(event, x, y, flags, param):
            if event == cv2.EVENT_LBUTTONDOWN:
                points.append((x, y))

        window = f"Detector {self.name}: click 4 reference points"
        cv2.namedWindow(window)
        cv2.setMouseCallback(window, on_mouse)
        while len(points) < 4:
            cv2.imshow(window, self.color_camera_ptr.image)
            if cv2.waitKey(30) == ord("q"):
                cv2.destroyWindow(window)
                return None
        cv2.destroyWindow(window)
        return np.asarray(points, np.float32)

    def DetectPoses(self, names, detected_names: set) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up manual detector {self.name} first")
            return False
        if self.optimizer_ptr.name not in names:
            return True
        points2d = self._acquire_points2d()
        if points2d is None:
            return True
        import cv2

        intr = self.color_camera_ptr.intrinsics
        camera_matrix = np.array(
            [[intr.fu, 0, intr.ppu], [0, intr.fv, intr.ppv], [0, 0, 1]], np.float64)
        ok, rvec, tvec = cv2.solvePnP(
            self.reference_points3d.astype(np.float64),
            points2d.astype(np.float64), camera_matrix, None,
            flags=cv2.SOLVEPNP_EPNP)
        if not ok:
            return True
        rot, _ = cv2.Rodrigues(rvec)
        link2camera = np.eye(4, dtype=np.float32)
        link2camera[:3, :3] = rot.astype(np.float32)
        link2camera[:3, 3] = tvec.reshape(3).astype(np.float32)
        link2world = self.color_camera_ptr.camera2world_pose @ link2camera
        self.UpdatePoses(link2world, self.optimizer_ptr)
        detected_names.add(self.optimizer_ptr.name)
        return True
