"""Viewer hierarchy (port of m3t_tpu/viewer.py; reference
m3t/src/{viewer,image_viewer,normal_viewer}.cpp).

Image viewers show/save raw camera frames; normal viewers alpha-blend a normal rendering
of the current pose estimates (a FullNormalRenderer on the renderer geometry's device)
over the camera image on the host (normal_viewer.h:27-92).  cv2 is imported only to show
and save images: display is optional (headless-safe); saving needs cv2.
"""

from __future__ import annotations

import os

import numpy as np

from m3t_tpu_torch.common import to_numpy
from m3t_tpu_torch.utils import yaml_io


class Viewer:
    def __init__(self, name: str, camera_ptr=None, metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.camera_ptr = camera_ptr
        self.renderer_geometry_ptr = None
        self.display_images = True
        self.save_images = False
        self.save_directory = "./"
        self.save_image_type = "png"
        self.set_up = False

    def StartSavingImages(self, save_directory: str,
                          save_image_type: str = "png") -> None:  # noqa: N802
        self.save_directory = save_directory
        self.save_image_type = save_image_type
        self.save_images = True

    def StopSavingImages(self) -> None:  # noqa: N802
        self.save_images = False

    def set_display_images(self, display_images: bool) -> None:
        self.display_images = bool(display_images)

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            fs = yaml_io.open_yaml_file_storage(self.metafile_path)
            self.display_images = bool(yaml_io.read_optional(
                fs, "display_images", self.display_images))
        if self.camera_ptr is None or not self.camera_ptr.set_up:
            print(f"Camera for viewer {self.name} was not set up")
            return False
        self.set_up = True
        return True

    def UpdateViewer(self, save_index: int) -> bool:  # noqa: N802
        raise NotImplementedError

    def _show_and_save(self, image: np.ndarray, save_index: int) -> None:
        if self.display_images:
            try:
                import cv2

                cv2.imshow(f"Viewer {self.name}", image)
            except Exception:
                pass  # headless environment
        if self.save_images:
            import cv2

            path = os.path.join(
                str(self.save_directory),
                f"{self.name}_image_{save_index}.{self.save_image_type}")
            cv2.imwrite(path, image)


class ImageColorViewer(Viewer):
    def UpdateViewer(self, save_index: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        self._show_and_save(np.asarray(self.camera_ptr.image), save_index)
        return True


class ImageDepthViewer(Viewer):
    def __init__(self, name: str, camera_ptr=None, min_depth: float = 0.0,
                 max_depth: float = 1.0, metafile_path: str | None = None):
        super().__init__(name, camera_ptr, metafile_path)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)

    def UpdateViewer(self, save_index: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        image = self.camera_ptr.NormalizedDepthImage(self.min_depth, self.max_depth)
        self._show_and_save(image, save_index)
        return True


class _NormalViewerMixin:
    """Alpha-blend a normal rendering over the camera image (normal_viewer.h:27-92)."""

    def _init_renderer(self, renderer_geometry_ptr, opacity: float):
        self.renderer_geometry_ptr = renderer_geometry_ptr
        self.opacity = float(opacity)
        self._renderer = None

    def _viewer_setup(self) -> bool:
        from m3t_tpu_torch.renderer import FullNormalRenderer

        if self.renderer_geometry_ptr is None or not self.renderer_geometry_ptr.set_up:
            print(f"Renderer geometry for viewer {self.name} was not set up")
            return False
        self._renderer = FullNormalRenderer(
            f"{self.name}_renderer", self.renderer_geometry_ptr, self.camera_ptr,
            device=self.renderer_geometry_ptr.device)
        return self._renderer.SetUp()

    def _blended(self, base_image: np.ndarray) -> np.ndarray:
        self._renderer.StartRendering()
        normal_rgb = self._renderer.normal_image_rgb()
        covered = np.isfinite(to_numpy(self._renderer.depth_image))
        alpha = np.where(covered, self.opacity, 0.0)[..., None]
        if base_image.ndim == 2:
            base_image = np.repeat(base_image[..., None], 3, axis=2)
        out = base_image.astype(np.float32) * (1 - alpha) + normal_rgb * alpha
        return out.astype(np.uint8)


class NormalColorViewer(_NormalViewerMixin, Viewer):
    def __init__(self, name: str, camera_ptr=None, renderer_geometry_ptr=None,
                 opacity: float = 0.5, metafile_path: str | None = None):
        super().__init__(name, camera_ptr, metafile_path)
        self._init_renderer(renderer_geometry_ptr, opacity)

    def SetUp(self) -> bool:  # noqa: N802
        if not super().SetUp():
            return False
        self.set_up = self._viewer_setup()
        return self.set_up

    def UpdateViewer(self, save_index: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        self._show_and_save(self._blended(np.asarray(self.camera_ptr.image)),
                            save_index)
        return True


class NormalDepthViewer(_NormalViewerMixin, Viewer):
    def __init__(self, name: str, camera_ptr=None, renderer_geometry_ptr=None,
                 min_depth: float = 0.0, max_depth: float = 1.0,
                 opacity: float = 0.5, metafile_path: str | None = None):
        super().__init__(name, camera_ptr, metafile_path)
        self._init_renderer(renderer_geometry_ptr, opacity)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)

    def SetUp(self) -> bool:  # noqa: N802
        if not super().SetUp():
            return False
        self.set_up = self._viewer_setup()
        return self.set_up

    def UpdateViewer(self, save_index: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        base = self.camera_ptr.NormalizedDepthImage(self.min_depth, self.max_depth)
        self._show_and_save(self._blended(base), save_index)
        return True
