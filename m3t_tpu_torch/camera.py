"""Camera hierarchy (port of m3t_tpu/camera.py: camera.h and loader_camera.h).

Frames stay host numpy arrays, as in the JAX package: colour images (H, W, 3) uint8 in
BGR order (so the histogram index matches color_histograms.cpp:61-69), depth images
(H, W) uint16 with ``depth_scale`` meters per unit.  Whoever reads a frame moves it to
its device.  The disk-replay cameras read and save PNG frames without ``cv2``
(``utils/png.py``); other image types import ``cv2`` where they are read or saved.
"""

from __future__ import annotations

import os

import numpy as np

from m3t_tpu_torch.common import Intrinsics, np_pose_inverse
from m3t_tpu_torch.utils import png, yaml_io


class Camera:
    """Abstract camera (reference: camera.h:32-86)."""

    def __init__(self, name: str, metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.intrinsics: Intrinsics | None = None
        self.camera2world_pose = np.eye(4, dtype=np.float32)
        self.world2camera_pose = np.eye(4, dtype=np.float32)
        self.image: np.ndarray | None = None
        self.save_directory = "./"
        self.save_index = 0
        self.save_image_type = "png"
        self.save_images = False
        self.set_up = False

    def set_camera2world_pose(self, camera2world_pose: np.ndarray) -> None:
        self.camera2world_pose = np.asarray(camera2world_pose, np.float32)
        self.world2camera_pose = np_pose_inverse(self.camera2world_pose)

    def set_world2camera_pose(self, world2camera_pose: np.ndarray) -> None:
        self.world2camera_pose = np.asarray(world2camera_pose, np.float32)
        self.camera2world_pose = np_pose_inverse(self.world2camera_pose)

    def StartSavingImages(self, save_directory: str, save_index: int = 0,
                          save_image_type: str = "png") -> None:  # noqa: N802
        self.save_directory = save_directory
        self.save_index = save_index
        self.save_image_type = save_image_type
        self.save_images = True

    def StopSavingImages(self) -> None:  # noqa: N802
        self.save_images = False

    def SetUp(self) -> bool:  # noqa: N802
        raise NotImplementedError

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        raise NotImplementedError

    def SaveImageIfDesired(self) -> None:  # noqa: N802
        if self.save_images and self.image is not None:
            path = os.path.join(
                str(self.save_directory),
                f"{self.name}_image_{self.save_index}.{self.save_image_type}")
            if self.save_image_type.lower() == "png":
                png.write_png(path, self.image)
            else:
                import cv2

                cv2.imwrite(path, self.image)
            self.save_index += 1


class ColorCamera(Camera):
    """Abstract colour camera (reference: camera.h:90-106)."""


class DepthCamera(Camera):
    """Abstract depth camera with depth_scale (reference: camera.h:115-138)."""

    def __init__(self, name: str, metafile_path: str | None = None):
        super().__init__(name, metafile_path)
        self.depth_scale = 0.001

    def NormalizedDepthImage(self, min_depth: float, max_depth: float) -> np.ndarray:  # noqa: N802
        depth = self.image.astype(np.float32) * self.depth_scale
        scaled = np.clip((depth - min_depth) / (max_depth - min_depth), 0.0, 1.0)
        return (255.0 * scaled).astype(np.uint8)


# --------------------------------------------------------------------------------------
# Injected-array cameras (frames from memory or from a callable)
# --------------------------------------------------------------------------------------


class _ImageCameraMixin:
    def _next_frame(self) -> bool:
        if callable(self.frames):
            self.image = np.asarray(self.frames(self.frame_index))
        else:
            if self.frame_index >= len(self.frames):
                return False
            self.image = np.asarray(self.frames[self.frame_index])
        self.frame_index += 1
        self.SaveImageIfDesired()
        return True


class ImageColorCamera(ColorCamera, _ImageCameraMixin):
    """Colour camera fed directly with image arrays (a sequence or a callable of the
    frame index)."""

    def __init__(self, name: str, intrinsics: Intrinsics, frames=None,
                 camera2world_pose: np.ndarray | None = None):
        super().__init__(name)
        self.intrinsics = intrinsics
        self.frames = frames if frames is not None else []
        self.frame_index = 0
        if camera2world_pose is not None:
            self.set_camera2world_pose(camera2world_pose)

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = True
        return True

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        return self._next_frame()


class ImageDepthCamera(DepthCamera, _ImageCameraMixin):
    """Depth camera fed directly with uint16 depth arrays."""

    def __init__(self, name: str, intrinsics: Intrinsics, frames=None,
                 depth_scale: float = 0.001,
                 camera2world_pose: np.ndarray | None = None):
        super().__init__(name)
        self.intrinsics = intrinsics
        self.frames = frames if frames is not None else []
        self.frame_index = 0
        self.depth_scale = float(depth_scale)
        if camera2world_pose is not None:
            self.set_camera2world_pose(camera2world_pose)

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = True
        return True

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        return self._next_frame()


# --------------------------------------------------------------------------------------
# Disk replay cameras (reference: loader_camera.h/cpp, the "fake backend" of its tests)
# --------------------------------------------------------------------------------------


class _LoaderCameraMixin:
    def _init_loader(self, load_directory, image_name_pre="", load_index=0,
                     n_leading_zeros=0, image_name_post="", load_image_type="png"):
        self.load_directory = load_directory
        self.image_name_pre = image_name_pre
        self.load_index = int(load_index)
        self.n_leading_zeros = int(n_leading_zeros)
        self.image_name_post = image_name_post
        self.load_image_type = load_image_type

    def _frame_path(self) -> str:
        # Reference: loader_camera.cpp:83-88, load_index zero-padded to n_leading_zeros.
        digits = str(self.load_index)
        zeros = "0" * max(self.n_leading_zeros - len(digits), 0)
        return os.path.join(
            str(self.load_directory),
            f"{self.image_name_pre}{zeros}{digits}{self.image_name_post}."
            f"{self.load_image_type}")

    def _load_loader_metadata(self, require_depth_scale: bool) -> bool:
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)
        load_directory = yaml_io.read_required(fs, "load_directory")
        self.intrinsics = yaml_io.read_intrinsics(fs, "intrinsics")
        if self.intrinsics is None:
            raise yaml_io.MetafileError("intrinsics missing")
        if require_depth_scale:
            self.depth_scale = float(yaml_io.read_required(fs, "depth_scale"))
        self.set_camera2world_pose(
            yaml_io.read_pose(fs, "camera2world_pose", self.camera2world_pose))
        self.image_name_pre = yaml_io.read_optional(fs, "image_name_pre", self.image_name_pre)
        self.load_index = int(yaml_io.read_optional(fs, "load_index", self.load_index))
        self.n_leading_zeros = int(
            yaml_io.read_optional(fs, "n_leading_zeros", self.n_leading_zeros))
        self.image_name_post = yaml_io.read_optional(fs, "image_name_post",
                                                     self.image_name_post)
        self.load_image_type = yaml_io.read_optional(fs, "load_image_type",
                                                     self.load_image_type)
        self.load_directory = yaml_io.resolve_path(str(load_directory), self.metafile_path)
        return True

    def _set_up_loader(self, require_depth_scale: bool) -> bool:
        self.set_up = False
        if self.metafile_path:
            if not self._load_loader_metadata(require_depth_scale):
                return False
        if not self.UpdateImage(True):
            return False
        self.load_index -= 1  # the tracker's first UpdateImage reads frame 0 again
        self.set_up = True
        return True

    def _read_frame(self):
        path = self._frame_path()
        if self.load_image_type.lower() == "png":
            if os.path.isfile(path):
                return png.read_png(path)
            image = None
        else:
            import cv2

            image = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if image is None:
            print(f"Could not read image {path}")
        return image


class LoaderColorCamera(ColorCamera, _LoaderCameraMixin):
    """Replays a recorded colour sequence from disk (reference: loader_camera.h:27-57)."""

    def __init__(self, name: str, metafile_path: str | None = None,
                 load_directory: str | None = None, intrinsics: Intrinsics | None = None,
                 image_name_pre: str = "", load_index: int = 0, n_leading_zeros: int = 0,
                 image_name_post: str = "", load_image_type: str = "png"):
        super().__init__(name, metafile_path)
        self.intrinsics = intrinsics
        self._init_loader(load_directory, image_name_pre, load_index, n_leading_zeros,
                          image_name_post, load_image_type)

    def SetUp(self) -> bool:  # noqa: N802
        return self._set_up_loader(require_depth_scale=False)

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        image = self._read_frame()
        if image is None:
            return False
        self.image = image
        self.load_index += 1
        self.SaveImageIfDesired()
        return True


class LoaderDepthCamera(DepthCamera, _LoaderCameraMixin):
    """Replays a recorded depth sequence from disk (reference: loader_camera.h:96-170)."""

    def __init__(self, name: str, metafile_path: str | None = None,
                 load_directory: str | None = None, intrinsics: Intrinsics | None = None,
                 depth_scale: float = 0.001, image_name_pre: str = "", load_index: int = 0,
                 n_leading_zeros: int = 0, image_name_post: str = "",
                 load_image_type: str = "png"):
        super().__init__(name, metafile_path)
        self.intrinsics = intrinsics
        self.depth_scale = float(depth_scale)
        self._init_loader(load_directory, image_name_pre, load_index, n_leading_zeros,
                          image_name_post, load_image_type)

    def SetUp(self) -> bool:  # noqa: N802
        return self._set_up_loader(require_depth_scale=True)

    def UpdateImage(self, synchronized: bool = True) -> bool:  # noqa: N802
        image = self._read_frame()
        if image is None:
            return False
        self.image = np.asarray(image, np.uint16)
        self.load_index += 1
        self.SaveImageIfDesired()
        return True
