"""Abstract Modality protocol (port of m3t_tpu/modality.py, modality.h).

Each modality is a per-(body, camera) cost term producing a 6x1 gradient and 6x6 Hessian
in the body frame (modality.h:135-136), exposed through the 7-method protocol the
Tracker drives (modality.h:79-86).  The batched functions in ``ops/`` do the work; these
classes hold configuration, references and per-frame state.
"""

from __future__ import annotations

import numpy as np


class Modality:
    def __init__(self, name: str, body_ptr, metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.body_ptr = body_ptr
        self.gradient = np.zeros(6, np.float32)
        self.hessian = np.zeros((6, 6), np.float32)
        self.set_up = False
        # Visualization flags (modality.h:67-70)
        self.visualize_pose_result = False
        self.visualize_gradient_optimization = False
        self.visualize_hessian_optimization = False
        self.display_visualization = False
        self.save_visualizations = False
        self.save_directory = "./"
        self.save_image_type = "png"

    # -- protocol (modality.h:79-86) ---------------------------------------------------

    def SetUp(self) -> bool:  # noqa: N802
        raise NotImplementedError

    def StartModality(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        raise NotImplementedError

    def CalculateCorrespondences(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        raise NotImplementedError

    def VisualizeCorrespondences(self, save_idx: int) -> bool:  # noqa: N802
        return self.set_up

    def CalculateGradientAndHessian(self, iteration: int, corr_iteration: int,
                                    opt_iteration: int) -> bool:  # noqa: N802
        raise NotImplementedError

    def VisualizeOptimization(self, save_idx: int) -> bool:  # noqa: N802
        return self.set_up

    def CalculateResults(self, iteration: int) -> bool:  # noqa: N802
        raise NotImplementedError

    def VisualizeResults(self, save_idx: int) -> bool:  # noqa: N802
        return self.set_up

    # -- referenced objects (modality.h:96-103), used by Tracker::AssembleDerivedObjectPtrs

    def camera_ptrs(self) -> list:
        return []

    def model_ptr(self):
        return None

    def start_modality_renderer_ptrs(self) -> list:
        return []

    def correspondence_renderer_ptrs(self) -> list:
        return []

    def results_renderer_ptrs(self) -> list:
        return []

    def color_histograms_ptr_shared(self):
        """Shared histograms exposed to the Tracker (None when internal), mirroring
        RegionModality::color_histograms_ptr (region_modality.cpp:641-646)."""
        return None
