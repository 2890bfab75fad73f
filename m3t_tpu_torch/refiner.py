"""Refiner: post-detection pose refinement (port of m3t_tpu/refiner.py; reference
m3t/src/refiner.cpp).

Same correspondence/update iteration structure as tracking, but StartModalities re-runs
before every correspondence iteration (refiner.cpp:98-117).
"""

from __future__ import annotations

from m3t_tpu_torch.common import add_ptr_if_name_not_exists, delete_ptr_if_name_exists
from m3t_tpu_torch.utils import yaml_io


def _add_ptrs(ptrs, target):
    for p in ptrs:
        if p is not None:
            add_ptr_if_name_not_exists(p, target)


class Refiner:
    def __init__(self, name: str, n_corr_iterations: int = 3,
                 n_update_iterations: int = 3, visualization_time: int = 0,
                 metafile_path: str | None = None):
        self.name = name
        self.metafile_path = metafile_path
        self.n_corr_iterations = int(n_corr_iterations)
        self.n_update_iterations = int(n_update_iterations)
        self.visualization_time = int(visualization_time)
        self.optimizer_ptrs: list = []
        self.set_up = False

    def AddOptimizer(self, optimizer) -> bool:  # noqa: N802
        self.set_up = False
        return add_ptr_if_name_not_exists(optimizer, self.optimizer_ptrs)

    def DeleteOptimizer(self, name: str) -> bool:  # noqa: N802
        self.set_up = False
        return delete_ptr_if_name_exists(name, self.optimizer_ptrs)

    def ClearOptimizers(self) -> None:  # noqa: N802
        self.set_up = False
        self.optimizer_ptrs.clear()

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            fs = yaml_io.open_yaml_file_storage(self.metafile_path)
            self.n_corr_iterations = int(yaml_io.read_optional(
                fs, "n_corr_iterations", self.n_corr_iterations))
            self.n_update_iterations = int(yaml_io.read_optional(
                fs, "n_update_iterations", self.n_update_iterations))
            self.visualization_time = int(yaml_io.read_optional(
                fs, "visualization_time", self.visualization_time))
        for optimizer in self.optimizer_ptrs:
            if not optimizer.set_up:
                print(f"Optimizer {optimizer.name} was not set up")
                return False
        self.set_up = True
        return True

    def RefinePoses(self, names) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up refiner {self.name} first")
            return False

        # Assemble used objects for the requested optimizer names.
        used_optimizers = [o for o in self.optimizer_ptrs if o.name in names]
        modalities: list = []
        start_renderers: list = []
        corr_renderers: list = []
        histograms: list = []
        for optimizer in used_optimizers:
            for link in optimizer.ReferencedLinks():
                for modality in link.modality_ptrs:
                    add_ptr_if_name_not_exists(modality, modalities)
                    _add_ptrs(modality.start_modality_renderer_ptrs(), start_renderers)
                    _add_ptrs(modality.correspondence_renderer_ptrs(), corr_renderers)
                    if modality.color_histograms_ptr_shared() is not None:
                        add_ptr_if_name_not_exists(
                            modality.color_histograms_ptr_shared(), histograms)

        for optimizer in used_optimizers:
            if not optimizer.CalculateConsistentPoses():
                return False

        for corr_iteration in range(self.n_corr_iterations):
            # StartModalities before each corr iteration (refiner.cpp:102, 126+).
            for renderer in start_renderers:
                if not renderer.StartRendering():
                    return False
            for h in histograms:
                if not h.ClearMemory():
                    return False
            for modality in modalities:
                if not modality.StartModality(0, corr_iteration):
                    return False
            for h in histograms:
                if not h.InitializeHistograms():
                    return False

            for renderer in corr_renderers:
                if not renderer.StartRendering():
                    return False
            for modality in modalities:
                if not modality.CalculateCorrespondences(0, corr_iteration):
                    return False
            for update_iteration in range(self.n_update_iterations):
                for modality in modalities:
                    if not modality.CalculateGradientAndHessian(0, corr_iteration,
                                                                update_iteration):
                        return False
                for optimizer in used_optimizers:
                    if not optimizer.CalculateOptimization(0, corr_iteration,
                                                           update_iteration):
                        return False
        return True
