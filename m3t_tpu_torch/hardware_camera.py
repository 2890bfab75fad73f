"""Live camera backends (port of m3t_tpu/hardware_camera.py; reference
M3T/src/{azure_kinect,realsense}_camera.cpp).

The reference wraps the Azure Kinect and RealSense SDKs behind singleton device classes
with an ID-registered capture lifecycle (azure_kinect_camera.h:20-47): every camera
wrapper registers an id; ``UpdateCapture(id, synchronized)`` fetches a NEW device capture
only if this id has already consumed the current one, so a color+depth pair sharing one
physical device always reads a single synchronized capture per tracking cycle
(azure_kinect_camera.cpp:88-101, realsense_camera.cpp:74-87).  The singleton starts the
device on first SetUp, drops 10 frames for white balance, computes the color<->depth
extrinsic poses, and stops the device when the last id unregisters.

Here each backend is a thin host IO adapter feeding frames into the same Camera
interface; the SDKs (pyk4a / pyrealsense2) and cv2 are imported only inside the functions
that use them, so the package imports without them, and a camera whose SDK is missing
fails its SetUp with a message.  A generic OpenCV VideoCapture camera covers webcams and
V4L2 devices.  Frames are staged as host numpy arrays, which the modalities upload.
"""

from __future__ import annotations

import threading

import numpy as np

from m3t_tpu_torch.camera import ColorCamera, DepthCamera
from m3t_tpu_torch.common import Intrinsics, np_pose_inverse
from m3t_tpu_torch.utils import yaml_io


def _scaled_intrinsics(intr: Intrinsics, image_scale: float) -> Intrinsics:
    # Reference zooms fu/fv only and remaps into the same-size image
    # (azure_kinect_camera.cpp GetIntrinsicsAndDistortionMap).
    return Intrinsics(intr.fu * image_scale, intr.fv * image_scale,
                      intr.ppu, intr.ppv, intr.width, intr.height)


def _zoom_about_principal_point(image: np.ndarray, intr: Intrinsics,
                                image_scale: float) -> np.ndarray:
    """Undistort-with-scaled-camera-matrix for zero distortion == zoom about (ppu, ppv)."""
    if image_scale == 1.0:
        return image
    import cv2

    m = np.array([[image_scale, 0.0, intr.ppu * (1.0 - image_scale)],
                  [0.0, image_scale, intr.ppv * (1.0 - image_scale)]], np.float32)
    return cv2.warpAffine(image, m, (intr.width, intr.height),
                          flags=cv2.INTER_NEAREST, borderMode=cv2.BORDER_CONSTANT)


class SharedDevice:
    """ID-registered capture sharing (azure_kinect_camera.h:20-47).

    Subclasses implement ``_start()`` (open + configure the physical device, compute
    calibration/extrinsics), ``_grab(synchronized)`` (fetch one capture), and
    ``_stop()``.  ``update_capture(id, synchronized)`` fetches a new capture only when
    the calling id has already consumed the current one, then marks it consumed for
    every other id — exactly the reference's map-of-flags logic
    (azure_kinect_camera.cpp:88-101).
    """

    _instance = None
    _cls_lock = threading.Lock()

    def __init__(self):
        self.mutex = threading.Lock()
        self._flags: dict[int, bool] = {}
        self._next_id = 0
        self.initial_set_up = False
        self.use_color = False
        self.use_depth = False
        self.color2depth_pose: np.ndarray | None = None
        self.depth2color_pose: np.ndarray | None = None

    # -- singleton ------------------------------------------------------------------
    @classmethod
    def instance(cls):
        with cls._cls_lock:
            if cls._instance is None or not isinstance(cls._instance, cls):
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset_instance(cls) -> None:
        """Drop the singleton (tests / after device shutdown)."""
        with cls._cls_lock:
            cls._instance = None

    # -- lifecycle ------------------------------------------------------------------
    def register_id(self) -> int:
        with self.mutex:
            new_id = self._next_id
            self._next_id += 1
            self._flags[new_id] = True
            return new_id

    def unregister_id(self, dev_id: int) -> bool:
        with self.mutex:
            found = self._flags.pop(dev_id, None) is not None
            if found and not self._flags and self.initial_set_up:
                self._stop()
                self.initial_set_up = False
                type(self).reset_instance()
            return found

    def set_up(self) -> bool:
        with self.mutex:
            if not self.initial_set_up:
                try:
                    if not self._start():
                        return False
                except ImportError as error:
                    print(f"Camera SDK not available: {error}")
                    return False
                except Exception as error:  # device errors
                    print(f"Camera device error: {error}")
                    return False
                self.initial_set_up = True
            return True

    def update_capture(self, dev_id: int, synchronized: bool) -> bool:
        with self.mutex:
            if not self.initial_set_up:
                return False
            if self._flags[dev_id]:
                if not self._grab(synchronized):
                    return False
                for key in self._flags:
                    self._flags[key] = False
            self._flags[dev_id] = True
            return True

    # -- subclass hooks ---------------------------------------------------------------
    def _start(self) -> bool:
        raise NotImplementedError

    def _grab(self, synchronized: bool) -> bool:
        raise NotImplementedError

    def _stop(self) -> None:
        raise NotImplementedError


class AzureKinect(SharedDevice):
    """Azure Kinect singleton via pyk4a (azure_kinect_camera.cpp:34-101)."""

    N_IMAGES_DROPPED = 10  # white-balance warm-up, azure_kinect_camera.cpp:75-82

    def __init__(self):
        super().__init__()
        self.k4a = None
        self.capture = None

    def _start(self) -> bool:
        import pyk4a  # optional dependency

        self.k4a = pyk4a.PyK4A()
        self.k4a.start()
        # Extrinsic color->depth pose; k4a translation is in millimeters
        # (azure_kinect_camera.cpp:56-67).
        calib = self.k4a.calibration
        ext = self._extrinsic_matrix(calib)
        if ext is not None:
            pose = np.asarray(ext, np.float32).copy()
            pose[:3, 3] *= 0.001
            self.color2depth_pose = pose
            self.depth2color_pose = np_pose_inverse(pose)
        for _ in range(self.N_IMAGES_DROPPED):
            self.capture = self.k4a.get_capture()
        return True

    @staticmethod
    def _extrinsic_matrix(calib):
        """4x4 color->depth extrinsics (translation in mm) if the SDK exposes them."""
        try:
            import pyk4a

            src = pyk4a.CalibrationType.COLOR
            dst = pyk4a.CalibrationType.DEPTH
        except (ImportError, AttributeError):
            src, dst = 1, 0
        getter = getattr(calib, "get_extrinsic_matrix", None)
        if getter is None:
            return None
        return getter(src, dst)

    def _grab(self, synchronized: bool) -> bool:
        self.capture = self.k4a.get_capture()
        return self.capture is not None

    def _stop(self) -> None:
        if self.k4a is not None:
            self.k4a.stop()

    def camera_matrix(self, color: bool):
        try:
            import pyk4a

            which = pyk4a.CalibrationType.COLOR if color else pyk4a.CalibrationType.DEPTH
        except (ImportError, AttributeError):
            which = 1 if color else 0
        return np.asarray(self.k4a.calibration.get_camera_matrix(which), np.float32)


class RealSense(SharedDevice):
    """RealSense D4xx singleton via pyrealsense2 (realsense_camera.cpp:34-87)."""

    N_IMAGES_DROPPED = 10

    def __init__(self):
        super().__init__()
        self.pipe = None
        self.profile = None
        self.frameset = None

    def _start(self) -> bool:
        import pyrealsense2 as rs

        self.pipe = rs.pipeline()
        config = rs.config()
        # Reference stream configuration (realsense_camera.cpp:38-41).
        if self.use_color:
            config.enable_stream(rs.stream.color, 960, 540, rs.format.bgr8, 60)
        if self.use_depth:
            config.enable_stream(rs.stream.depth, 848, 480, rs.format.z16, 60)
        try:
            self.profile = self.pipe.start(config)
        except Exception as error:
            print(error)
            return False
        if self.use_color and self.use_depth:
            color_stream = self.profile.get_stream(rs.stream.color)
            depth_stream = self.profile.get_stream(rs.stream.depth)
            ext = color_stream.get_extrinsics_to(depth_stream)
            pose = np.eye(4, dtype=np.float32)
            # rs2_extrinsics rotation is column-major (realsense_camera.cpp:52-61).
            pose[:3, :3] = np.asarray(ext.rotation, np.float32).reshape(3, 3, order="F")
            pose[:3, 3] = np.asarray(ext.translation, np.float32)
            self.color2depth_pose = pose
            self.depth2color_pose = np_pose_inverse(pose)
        for _ in range(self.N_IMAGES_DROPPED):
            self.frameset = self.pipe.wait_for_frames()
        return True

    def _grab(self, synchronized: bool) -> bool:
        if synchronized:
            self.frameset = self.pipe.wait_for_frames()
        else:
            polled = self.pipe.poll_for_frames()
            if polled:
                self.frameset = polled
        return self.frameset is not None

    def _stop(self) -> None:
        if self.pipe is not None:
            self.pipe.stop()

    def stream_intrinsics(self, color: bool) -> Intrinsics:
        import pyrealsense2 as rs

        stream = self.profile.get_stream(rs.stream.color if color else rs.stream.depth)
        i = stream.as_video_stream_profile().get_intrinsics()
        return Intrinsics(i.fx, i.fy, i.ppx, i.ppy, i.width, i.height)

    def depth_scale(self) -> float:
        # realsense_camera.cpp:319-323
        return float(self.profile.get_device().first_depth_sensor().get_depth_scale())


class _HardwareCameraMixin:
    """Shared wrapper logic: register/unregister, metafile, world-frame selection."""

    _DEVICE_CLS: type[SharedDevice] = SharedDevice
    _IS_COLOR = True

    def _init_hardware(self, image_scale: float, use_other_as_world_frame: bool) -> None:
        self.image_scale = float(image_scale)
        # Color cameras: use_depth_as_world_frame (default False).
        # Depth cameras: use_color_as_world_frame (default True).
        self._use_other_as_world_frame = bool(use_other_as_world_frame)
        self._device: SharedDevice | None = None
        self._device_id: int | None = None
        self._register()

    def _register(self) -> None:
        try:
            self._device = self._DEVICE_CLS.instance()
        except Exception as error:  # SDK import / device errors
            print(f"Device error for camera {self.name}: {error}")
            self._device = None
            return
        if self._IS_COLOR:
            self._device.use_color = True
        else:
            self._device.use_depth = True
        self._device_id = self._device.register_id()

    def Close(self) -> None:  # noqa: N802
        """Unregister from the shared device; stops it when the last user leaves."""
        if self._device is not None and self._device_id is not None:
            self._device.unregister_id(self._device_id)
            self._device_id = None

    def _load_hardware_metadata(self) -> bool:
        # Reference: azure_kinect_camera.cpp LoadMetaData (camera2world_pose,
        # save parameters, image_scale, use_*_as_world_frame).
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)
        pose = yaml_io.read_pose(fs, "camera2world_pose", self.camera2world_pose)
        self.set_camera2world_pose(pose)
        self.save_directory = yaml_io.read_optional(
            fs, "save_directory", self.save_directory)
        self.save_index = int(yaml_io.read_optional(fs, "save_index", self.save_index))
        self.save_image_type = yaml_io.read_optional(
            fs, "save_image_type", self.save_image_type)
        self.save_images = bool(yaml_io.read_optional(
            fs, "save_images", self.save_images))
        self.image_scale = float(yaml_io.read_optional(
            fs, "image_scale", self.image_scale))
        key = ("use_depth_as_world_frame" if self._IS_COLOR
               else "use_color_as_world_frame")
        self._use_other_as_world_frame = bool(yaml_io.read_optional(
            fs, key, self._use_other_as_world_frame))
        return True

    def _set_up_common(self) -> bool:
        self.set_up = False
        if self._device is None or self._device_id is None:
            print(f"No device available for camera {self.name}")
            return False
        if self.metafile_path:
            if not self._load_hardware_metadata():
                return False
        if not self._device.set_up():
            return False
        if self._use_other_as_world_frame:
            other = (self._device.color2depth_pose if self._IS_COLOR
                     else self._device.depth2color_pose)
            if other is not None:
                self.set_camera2world_pose(other)
        self._get_intrinsics()
        self.set_up = True
        return self.UpdateImage(True)

    def _get_intrinsics(self) -> None:
        raise NotImplementedError


class AzureKinectColorCamera(_HardwareCameraMixin, ColorCamera):
    """Azure Kinect color wrapper (azure_kinect_camera.h:83-129)."""

    _DEVICE_CLS = AzureKinect
    _IS_COLOR = True

    def __init__(self, name: str, metafile_path: str | None = None,
                 image_scale: float = 1.05, use_depth_as_world_frame: bool = False):
        super().__init__(name, metafile_path)
        self._init_hardware(image_scale, use_depth_as_world_frame)

    def SetUp(self) -> bool:  # noqa: N802
        return self._set_up_common()

    def _get_intrinsics(self) -> None:
        m = self._device.camera_matrix(color=True)
        cap = self._device.capture.color
        h, w = np.asarray(cap).shape[:2]
        self.intrinsics = _scaled_intrinsics(
            Intrinsics(m[0][0], m[1][1], m[0][2], m[1][2], w, h), self.image_scale)

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up azure kinect color camera {self.name} first")
            return False
        if not self._device.update_capture(self._device_id, synchronized):
            return False
        color = self._device.capture.color
        if color is None:
            return False
        bgra = np.asarray(color)
        self.image = _zoom_about_principal_point(
            np.ascontiguousarray(bgra[:, :, :3]), self.intrinsics, self.image_scale)
        self.SaveImageIfDesired()
        return True


class AzureKinectDepthCamera(_HardwareCameraMixin, DepthCamera):
    """Azure Kinect depth wrapper (azure_kinect_camera.h:132-181)."""

    _DEVICE_CLS = AzureKinect
    _IS_COLOR = False

    def __init__(self, name: str, metafile_path: str | None = None,
                 image_scale: float = 1.0, use_color_as_world_frame: bool = True):
        super().__init__(name, metafile_path)
        self.depth_scale = 0.001  # azure_kinect_camera.cpp:399
        self._init_hardware(image_scale, use_color_as_world_frame)

    def SetUp(self) -> bool:  # noqa: N802
        return self._set_up_common()

    def _get_intrinsics(self) -> None:
        m = self._device.camera_matrix(color=False)
        cap = self._device.capture.depth
        h, w = np.asarray(cap).shape[:2]
        self.intrinsics = _scaled_intrinsics(
            Intrinsics(m[0][0], m[1][1], m[0][2], m[1][2], w, h), self.image_scale)

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up azure kinect depth camera {self.name} first")
            return False
        if not self._device.update_capture(self._device_id, synchronized):
            return False
        depth = self._device.capture.depth
        if depth is None:
            return False
        self.image = _zoom_about_principal_point(
            np.asarray(depth, np.uint16), self.intrinsics, self.image_scale)
        self.SaveImageIfDesired()
        return True


class RealSenseColorCamera(_HardwareCameraMixin, ColorCamera):
    """RealSense D4xx color wrapper (realsense_camera.h:86-125)."""

    _DEVICE_CLS = RealSense
    _IS_COLOR = True

    def __init__(self, name: str, metafile_path: str | None = None,
                 use_depth_as_world_frame: bool = False):
        super().__init__(name, metafile_path)
        self._init_hardware(1.0, use_depth_as_world_frame)

    def SetUp(self) -> bool:  # noqa: N802
        return self._set_up_common()

    def _get_intrinsics(self) -> None:
        self.intrinsics = self._device.stream_intrinsics(color=True)

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up realsense color camera {self.name} first")
            return False
        if not self._device.update_capture(self._device_id, synchronized):
            return False
        color = self._device.frameset.get_color_frame()
        if not color:
            return False
        self.image = np.ascontiguousarray(np.asanyarray(color.get_data()))
        self.SaveImageIfDesired()
        return True


class RealSenseDepthCamera(_HardwareCameraMixin, DepthCamera):
    """RealSense D4xx depth wrapper (realsense_camera.h:128-167)."""

    _DEVICE_CLS = RealSense
    _IS_COLOR = False

    def __init__(self, name: str, metafile_path: str | None = None,
                 use_color_as_world_frame: bool = True):
        super().__init__(name, metafile_path)
        self._init_hardware(1.0, use_color_as_world_frame)

    def SetUp(self) -> bool:  # noqa: N802
        if not self._set_up_common():
            return False
        self.depth_scale = self._device.depth_scale()
        return True

    def _get_intrinsics(self) -> None:
        self.intrinsics = self._device.stream_intrinsics(color=False)

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up realsense depth camera {self.name} first")
            return False
        if not self._device.update_capture(self._device_id, synchronized):
            return False
        depth = self._device.frameset.get_depth_frame()
        if not depth:
            return False
        self.image = np.asanyarray(depth.get_data()).astype(np.uint16)
        self.SaveImageIfDesired()
        return True


class OpenCVColorCamera(ColorCamera):
    """Generic live color camera via cv2.VideoCapture (webcams, V4L2 devices)."""

    def __init__(self, name: str, device_index: int = 0,
                 intrinsics: Intrinsics | None = None):
        super().__init__(name)
        self.device_index = int(device_index)
        self.intrinsics = intrinsics
        self._capture = None

    def SetUp(self) -> bool:  # noqa: N802
        import cv2

        self._capture = cv2.VideoCapture(self.device_index)
        if not self._capture.isOpened():
            print(f"Could not open video device {self.device_index}")
            return False
        ok, frame = self._capture.read()
        if not ok:
            print(f"Could not read from video device {self.device_index}")
            return False
        h, w = frame.shape[:2]
        if self.intrinsics is None:
            # Fallback pinhole guess: 60 deg horizontal FOV.
            f = w / (2.0 * np.tan(np.deg2rad(30.0)))
            self.intrinsics = Intrinsics(f, f, w / 2 - 0.5, h / 2 - 0.5, w, h)
        self.set_up = True
        return True

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        ok, frame = self._capture.read()
        if not ok:
            return False
        self.image = frame
        self.SaveImageIfDesired()
        return True
