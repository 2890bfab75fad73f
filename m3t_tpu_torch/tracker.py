"""Tracker: the orchestrator and per-structure state machine (port of
m3t_tpu/tracker.py; reference m3t/src/tracker.cpp).

Host-side control flow: cameras -> subscribers -> consistent poses -> detecting/starting/
tracking steps -> publishers -> viewers (tracker.cpp:221-262).  The per-optimizer state
machine (names_detecting -> names_starting -> names_tracking, tracker.h:256-259) stays on
host; device work happens inside modalities/renderers/optimizers.
"""

from __future__ import annotations

import threading
import time

from m3t_tpu_torch.common import (add_ptr_if_name_not_exists, delete_ptr_if_name_exists,
                            set_up_object_ptrs)
from m3t_tpu_torch.utils import timing, yaml_io


def _add_ptrs(ptrs, target):
    for p in ptrs:
        if p is not None:
            add_ptr_if_name_not_exists(p, target)


class Tracker:
    def __init__(self, name: str, n_corr_iterations: int = 5,
                 n_update_iterations: int = 2, synchronize_cameras: bool = True,
                 start_tracking_after_detection: bool = False,
                 cycle_duration_ms: int = 33, visualization_time: int = 0,
                 viewer_time: int = 1, metafile_path: str | None = None,
                 use_fused_cycle: bool = False):
        self.name = name
        self.metafile_path = metafile_path
        self.n_corr_iterations = int(n_corr_iterations)
        self.n_update_iterations = int(n_update_iterations)
        self.synchronize_cameras = bool(synchronize_cameras)
        self.start_tracking_after_detection = bool(start_tracking_after_detection)
        self.cycle_duration_ms = int(cycle_duration_ms)
        self.visualization_time = int(visualization_time)
        self.viewer_time = int(viewer_time)
        # Serve the tracking step through the fused cycle on the device when the
        # object graph is expressible (fused_serve.py); the host per-modality path
        # remains the fallback and the parity reference.
        self.use_fused_cycle = bool(use_fused_cycle)
        self._fused_backend = None
        self._fused_backend_key = None

        # User-provided objects
        self.optimizer_ptrs: list = []
        self.detector_ptrs: list = []
        self.refiner_ptrs: list = []
        self.viewer_ptrs: list = []
        self.publisher_ptrs: list = []
        self.subscriber_ptrs: list = []

        # Derived objects (AssembleDerivedObjectPtrs, tracker.cpp:782-882)
        self.link_ptrs: list = []
        self.constraint_ptrs: list = []
        self.soft_constraint_ptrs: list = []
        self.modality_ptrs: list = []
        self.model_ptrs: list = []
        self.camera_ptrs: list = []
        self.renderer_geometry_ptrs: list = []
        self.body_ptrs: list = []
        self.start_modality_renderer_ptrs: list = []
        self.correspondence_renderer_ptrs: list = []
        self.results_renderer_ptrs: list = []
        self.color_histograms_ptrs: list = []

        # State machine (tracker.h:256-259)
        self.names_all: set[str] = set()
        self.names_detecting: set[str] = set()
        self.names_starting: set[str] = set()
        self.names_tracking: set[str] = set()

        self.tracking_mutex = threading.Lock()
        self.quit_tracker_process = False
        self.set_up = False

        self._init_internal_ptrs()

    def _init_internal_ptrs(self) -> None:
        # Default the internal sets to ALL objects (tracker.cpp:704-715) so the direct
        # StartModalities/ExecuteTrackingStep call pattern used by the reference tests
        # works right after SetUp; RunTrackerProcess re-assembles them per state.
        self.detecting_detector_ptrs = list(self.detector_ptrs)
        self.detecting_refiner_ptrs = list(self.refiner_ptrs)
        self.starting_modality_ptrs = list(self.modality_ptrs)
        self.starting_start_modality_renderer_ptrs = list(
            self.start_modality_renderer_ptrs)
        self.starting_color_histograms_ptrs = list(self.color_histograms_ptrs)
        self.tracking_optimizer_ptrs = list(self.optimizer_ptrs)
        self.tracking_modality_ptrs = list(self.modality_ptrs)
        self.tracking_correspondence_renderer_ptrs = list(
            self.correspondence_renderer_ptrs)
        self.tracking_results_renderer_ptrs = list(self.results_renderer_ptrs)
        self.tracking_color_histograms_ptrs = list(self.color_histograms_ptrs)

    # -- user object management --------------------------------------------------------

    def AddOptimizer(self, optimizer) -> bool:  # noqa: N802
        self.set_up = False
        return add_ptr_if_name_not_exists(optimizer, self.optimizer_ptrs)

    def AddDetector(self, detector) -> bool:  # noqa: N802
        self.set_up = False
        return add_ptr_if_name_not_exists(detector, self.detector_ptrs)

    def AddRefiner(self, refiner) -> bool:  # noqa: N802
        self.set_up = False
        return add_ptr_if_name_not_exists(refiner, self.refiner_ptrs)

    def AddViewer(self, viewer) -> bool:  # noqa: N802
        self.set_up = False
        return add_ptr_if_name_not_exists(viewer, self.viewer_ptrs)

    def AddPublisher(self, publisher) -> bool:  # noqa: N802
        self.set_up = False
        return add_ptr_if_name_not_exists(publisher, self.publisher_ptrs)

    def AddSubscriber(self, subscriber) -> bool:  # noqa: N802
        self.set_up = False
        return add_ptr_if_name_not_exists(subscriber, self.subscriber_ptrs)

    def _delete(self, name: str, ptrs: list, kind: str) -> bool:
        # Tracker::Delete* (tracker.cpp:52-60 and siblings).
        self.set_up = False
        if not delete_ptr_if_name_exists(name, ptrs):
            print(f"{kind} {name} not found")
            return False
        return True

    def DeleteOptimizer(self, name: str) -> bool:  # noqa: N802
        return self._delete(name, self.optimizer_ptrs, "Optimizer")

    def DeleteDetector(self, name: str) -> bool:  # noqa: N802
        return self._delete(name, self.detector_ptrs, "Detector")

    def DeleteRefiner(self, name: str) -> bool:  # noqa: N802
        return self._delete(name, self.refiner_ptrs, "Refiner")

    def DeleteViewer(self, name: str) -> bool:  # noqa: N802
        return self._delete(name, self.viewer_ptrs, "Viewer")

    def DeletePublisher(self, name: str) -> bool:  # noqa: N802
        return self._delete(name, self.publisher_ptrs, "Publisher")

    def DeleteSubscriber(self, name: str) -> bool:  # noqa: N802
        return self._delete(name, self.subscriber_ptrs, "Subscriber")

    def ClearOptimizers(self) -> None:  # noqa: N802
        self.set_up = False
        self.optimizer_ptrs.clear()

    def ClearDetectors(self) -> None:  # noqa: N802
        self.set_up = False
        self.detector_ptrs.clear()

    def ClearRefiners(self) -> None:  # noqa: N802
        self.set_up = False
        self.refiner_ptrs.clear()

    def ClearViewers(self) -> None:  # noqa: N802
        self.set_up = False
        self.viewer_ptrs.clear()

    def ClearPublishers(self) -> None:  # noqa: N802
        self.set_up = False
        self.publisher_ptrs.clear()

    def ClearSubscribers(self) -> None:  # noqa: N802
        self.set_up = False
        self.subscriber_ptrs.clear()

    # -- setup (tracker.cpp:26-40, 782-899) --------------------------------------------

    def SetUp(self, set_up_all_objects: bool = True) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        self._assemble_derived_object_ptrs()
        if set_up_all_objects:
            if not self._set_up_all_objects():
                return False
        else:
            if not self._are_all_objects_set_up():
                return False
        self._extract_all_optimizer_names()
        self._init_internal_ptrs()
        self._fused_backend = None
        self._fused_backend_key = None
        self.set_up = True
        return True

    def _load_metadata(self) -> bool:
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)
        g = lambda key, cur: yaml_io.read_optional(fs, key, cur)  # noqa: E731
        self.n_corr_iterations = int(g("n_corr_iterations", self.n_corr_iterations))
        self.n_update_iterations = int(g("n_update_iterations",
                                         self.n_update_iterations))
        self.synchronize_cameras = bool(g("synchronize_cameras",
                                          self.synchronize_cameras))
        self.start_tracking_after_detection = bool(g(
            "start_tracking_after_detection", self.start_tracking_after_detection))
        self.cycle_duration_ms = int(g("cycle_duration", self.cycle_duration_ms))
        self.visualization_time = int(g("visualization_time",
                                        self.visualization_time))
        self.viewer_time = int(g("viewer_time", self.viewer_time))
        self.use_fused_cycle = bool(g("use_fused_cycle",
                                      self.use_fused_cycle))
        return True

    def _assemble_derived_object_ptrs(self) -> None:
        self.link_ptrs = []
        self.constraint_ptrs = []
        self.soft_constraint_ptrs = []
        self.modality_ptrs = []
        self.model_ptrs = []
        self.camera_ptrs = []
        self.renderer_geometry_ptrs = []
        self.body_ptrs = []
        self.start_modality_renderer_ptrs = []
        self.correspondence_renderer_ptrs = []
        self.results_renderer_ptrs = []
        self.color_histograms_ptrs = []

        for detector in self.detector_ptrs:
            if getattr(detector, "camera_ptr", None) is not None:
                _add_ptrs([detector.camera_ptr], self.camera_ptrs)
            _add_ptrs(detector.optimizer_ptrs, self.optimizer_ptrs)
        for refiner in self.refiner_ptrs:
            for optimizer in refiner.optimizer_ptrs:
                for link in optimizer.ReferencedLinks():
                    for modality in link.modality_ptrs:
                        _add_ptrs(modality.camera_ptrs(), self.camera_ptrs)
        for viewer in self.viewer_ptrs:
            if getattr(viewer, "camera_ptr", None) is not None:
                _add_ptrs([viewer.camera_ptr], self.camera_ptrs)
            if getattr(viewer, "renderer_geometry_ptr", None) is not None:
                _add_ptrs([viewer.renderer_geometry_ptr], self.renderer_geometry_ptrs)
        for optimizer in self.optimizer_ptrs:
            _add_ptrs(optimizer.soft_constraint_ptrs, self.soft_constraint_ptrs)
            _add_ptrs(optimizer.constraint_ptrs, self.constraint_ptrs)
            _add_ptrs(optimizer.ReferencedLinks(), self.link_ptrs)
        for link in self.link_ptrs:
            _add_ptrs(link.modality_ptrs, self.modality_ptrs)
            if link.body_ptr is not None:
                _add_ptrs([link.body_ptr], self.body_ptrs)
        for modality in self.modality_ptrs:
            _add_ptrs(modality.camera_ptrs(), self.camera_ptrs)
            if modality.model_ptr() is not None:
                _add_ptrs([modality.model_ptr()], self.model_ptrs)
            _add_ptrs(modality.start_modality_renderer_ptrs(),
                      self.start_modality_renderer_ptrs)
            _add_ptrs(modality.correspondence_renderer_ptrs(),
                      self.correspondence_renderer_ptrs)
            _add_ptrs(modality.results_renderer_ptrs(), self.results_renderer_ptrs)
            if modality.color_histograms_ptr_shared() is not None:
                _add_ptrs([modality.color_histograms_ptr_shared()],
                          self.color_histograms_ptrs)
            _add_ptrs([modality.body_ptr], self.body_ptrs)
        for model in self.model_ptrs:
            _add_ptrs([model.body_ptr], self.body_ptrs)
        for renderer in (self.start_modality_renderer_ptrs
                         + self.correspondence_renderer_ptrs
                         + self.results_renderer_ptrs):
            _add_ptrs([renderer.renderer_geometry_ptr], self.renderer_geometry_ptrs)
            _add_ptrs(getattr(renderer, "referenced_body_ptrs", []), self.body_ptrs)
        for rg in self.renderer_geometry_ptrs:
            _add_ptrs(rg.body_ptrs, self.body_ptrs)

    def _set_up_all_objects(self) -> bool:
        # Dependency-ordered SetUp (tracker.cpp:884-899).
        return (set_up_object_ptrs(self.body_ptrs)
                and set_up_object_ptrs(self.color_histograms_ptrs)
                and set_up_object_ptrs(self.renderer_geometry_ptrs)
                and set_up_object_ptrs(self.camera_ptrs)
                and set_up_object_ptrs(self.start_modality_renderer_ptrs)
                and set_up_object_ptrs(self.correspondence_renderer_ptrs)
                and set_up_object_ptrs(self.results_renderer_ptrs)
                and set_up_object_ptrs(self.model_ptrs)
                and set_up_object_ptrs(self.modality_ptrs)
                and set_up_object_ptrs(self.link_ptrs)
                and set_up_object_ptrs(self.constraint_ptrs)
                and set_up_object_ptrs(self.soft_constraint_ptrs)
                and set_up_object_ptrs(self.optimizer_ptrs)
                and set_up_object_ptrs(self.viewer_ptrs)
                and set_up_object_ptrs(self.refiner_ptrs)
                and set_up_object_ptrs(self.detector_ptrs)
                and set_up_object_ptrs(self.publisher_ptrs)
                and set_up_object_ptrs(self.subscriber_ptrs))

    def _are_all_objects_set_up(self) -> bool:
        groups = [self.body_ptrs, self.color_histograms_ptrs,
                  self.renderer_geometry_ptrs, self.camera_ptrs,
                  self.start_modality_renderer_ptrs,
                  self.correspondence_renderer_ptrs, self.results_renderer_ptrs,
                  self.model_ptrs, self.modality_ptrs, self.link_ptrs,
                  self.constraint_ptrs, self.soft_constraint_ptrs,
                  self.optimizer_ptrs, self.viewer_ptrs, self.refiner_ptrs,
                  self.detector_ptrs, self.publisher_ptrs, self.subscriber_ptrs]
        for group in groups:
            for obj in group:
                if not obj.set_up:
                    print(f"{type(obj).__name__} {obj.name} was not set up")
                    return False
        return True

    def _extract_all_optimizer_names(self) -> None:
        self.names_all = {o.name for o in self.optimizer_ptrs}

    # -- external control (tracker.cpp:266-304) ----------------------------------------

    def ExecuteDetection(self, start_tracking: bool, names_detecting=None,
                         names_starting=None) -> None:  # noqa: N802
        with self.tracking_mutex:
            self.names_detecting = set(names_detecting) if names_detecting \
                else set(self.names_all)
            if start_tracking:
                self.names_starting = set(names_starting) if names_starting \
                    else set(self.names_all)
            self._validate_names()
            self._assemble_internally_used_object_ptrs()

    def StartTracking(self, names_starting=None) -> None:  # noqa: N802
        with self.tracking_mutex:
            self.names_starting |= (set(names_starting) if names_starting
                                    else set(self.names_all))
            self._validate_names()
            self._assemble_internally_used_object_ptrs()

    def StopTracking(self, names_stopping=None) -> None:  # noqa: N802
        with self.tracking_mutex:
            if names_stopping:
                for name in names_stopping:
                    self.names_detecting.discard(name)
                    self.names_starting.discard(name)
                    self.names_tracking.discard(name)
            else:
                self.names_detecting.clear()
                self.names_starting.clear()
                self.names_tracking.clear()
            self._assemble_internally_used_object_ptrs()

    def QuitTrackerProcess(self) -> None:  # noqa: N802
        self.quit_tracker_process = True

    # -- main loop (tracker.cpp:221-262) -----------------------------------------------

    def RunTrackerProcess(self, execute_detection: bool = False,
                          start_tracking: bool = False, names_detecting=None,
                          names_starting=None, max_iterations: int | None = None
                          ) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up tracker {self.name} first")
            return False
        self.names_detecting = set()
        self.names_starting = set()
        self.names_tracking = set()
        if execute_detection:
            self.names_detecting = set(names_detecting) if names_detecting \
                else set(self.names_all)
        if start_tracking:
            self.names_starting = set(names_starting) if names_starting \
                else set(self.names_all)
        self._validate_names()
        self._assemble_internally_used_object_ptrs()

        self.quit_tracker_process = False
        iteration = 0
        while True:
            begin = time.monotonic()
            if not self.UpdateCameras(iteration):
                return max_iterations is not None  # sequence exhausted is OK for replay
            if not self.UpdateSubscribers(iteration):
                return False
            if not self.CalculateConsistentPoses():
                return False
            with self.tracking_mutex:
                if not self.ExecuteDetectingStep(iteration):
                    return False
                if not self.ExecuteStartingStep(iteration):
                    return False
                if not self.ExecuteTrackingStep(iteration):
                    return False
            if not self.UpdatePublishers(iteration):
                return False
            if not self.UpdateViewers(iteration):
                return False
            if self.quit_tracker_process:
                return True
            iteration += 1
            if max_iterations is not None and iteration >= max_iterations:
                return True
            if not self.synchronize_cameras:
                self._wait_until_cycle_ends(begin)

    # -- steps -------------------------------------------------------------------------

    def UpdateCameras(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.update_cameras", iteration):
            for camera in self.camera_ptrs:
                if not camera.UpdateImage(self.synchronize_cameras):
                    return False
            return True

    def UpdateSubscribers(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.update_subscribers", iteration):
            for subscriber in self.subscriber_ptrs:
                if not subscriber.UpdateSubscriber(iteration):
                    return False
            return True

    def UpdatePublishers(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.update_publishers", iteration):
            for publisher in self.publisher_ptrs:
                if not publisher.UpdatePublisher(iteration):
                    return False
            return True

    def UpdateViewers(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.update_viewers", iteration):
            for viewer in self.viewer_ptrs:
                viewer.UpdateViewer(iteration)
            # Keyboard control mirrors the reference (tracker.cpp:378-389): d = detect,
            # x = detect + track, t = track, s = stop, q = quit.
            if self.viewer_ptrs and any(getattr(v, "display_images", False)
                                        for v in self.viewer_ptrs):
                try:
                    import cv2

                    key = cv2.waitKey(self.viewer_time)
                except Exception:
                    return True
                if key == ord("d"):
                    self.ExecuteDetection(False)
                elif key == ord("x"):
                    self.ExecuteDetection(True)
                elif key == ord("t"):
                    self.StartTracking()
                elif key == ord("s"):
                    self.StopTracking()
                elif key == ord("q"):
                    self.quit_tracker_process = True
            return True

    def CalculateConsistentPoses(self) -> bool:  # noqa: N802
        with timing.span("tracker.consistent_poses"):
            for optimizer in self.optimizer_ptrs:
                if not optimizer.CalculateConsistentPoses():
                    return False
            return True

    def DetectPoses(self, names, detected_names: set) -> bool:  # noqa: N802
        """Run every detecting detector (tracker.cpp:408-414)."""
        for detector in self.detecting_detector_ptrs:
            if not detector.DetectPoses(names, detected_names):
                return False
        return True

    def RefinePoses(self, names) -> bool:  # noqa: N802
        """Run every detecting refiner (tracker.cpp:416-421)."""
        for refiner in self.detecting_refiner_ptrs:
            if not refiner.RefinePoses(names):
                return False
        return True

    def ExecuteDetectingStep(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.detecting_step", iteration):
            if not self.names_detecting:
                return True
            self._move_back_poses(self.names_detecting)
            names_detected: set[str] = set()
            if not self.DetectPoses(self.names_detecting, names_detected):
                return False
            if not self.RefinePoses(names_detected):
                return False
            if not self.CalculateConsistentPoses():
                return False
            if self.start_tracking_after_detection:
                self.names_starting |= names_detected
            self.names_detecting -= names_detected
            self._assemble_internally_used_object_ptrs()
            return True

    def ExecuteStartingStep(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.starting_step", iteration):
            if not self.names_starting:
                return True
            if not self.StartModalities(iteration):
                return False
            self.names_tracking |= self.names_starting
            self.names_starting = set()
            self._assemble_internally_used_object_ptrs()
            return True

    def _fused_serve_backend(self):
        """Cached FusedServeBackend for the current tracking set (or None)."""
        key = tuple(sorted(o.name for o in self.tracking_optimizer_ptrs))
        if key != self._fused_backend_key:
            self._fused_backend_key = key
            self._fused_backend = None
            if self.tracking_optimizer_ptrs:
                from m3t_tpu_torch.fused_serve import FusedServeBackend

                backend, reason = FusedServeBackend.try_build(self)
                if backend is None:
                    print(f"Tracker {self.name}: fused cycle unavailable "
                          f"({reason}); using the host path")
                self._fused_backend = backend
        return self._fused_backend

    def ExecuteTrackingStep(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.tracking_step", iteration):
            if self.use_fused_cycle:
                backend = self._fused_serve_backend()
                if backend is not None:
                    return backend.Execute(iteration)
            for corr_iteration in range(self.n_corr_iterations):
                corr_save_idx = iteration * self.n_corr_iterations + corr_iteration
                if not self.CalculateCorrespondences(iteration, corr_iteration):
                    return False
                if not self.VisualizeCorrespondences(corr_save_idx):
                    return False
                for update_iteration in range(self.n_update_iterations):
                    update_save_idx = (corr_save_idx * self.n_update_iterations
                                       + update_iteration)
                    if not self.CalculateGradientAndHessian(iteration, corr_iteration,
                                                            update_iteration):
                        return False
                    if not self.CalculateOptimization(iteration, corr_iteration,
                                                      update_iteration):
                        return False
                    if not self.VisualizeOptimization(update_save_idx):
                        return False
            if not self.CalculateResults(iteration):
                return False
            return self.VisualizeResults(iteration)

    def VisualizeCorrespondences(self, save_idx: int) -> bool:  # noqa: N802
        for modality in self.tracking_modality_ptrs:
            if not modality.VisualizeCorrespondences(save_idx):
                return False
        return True

    def VisualizeOptimization(self, save_idx: int) -> bool:  # noqa: N802
        for modality in self.tracking_modality_ptrs:
            if not modality.VisualizeOptimization(save_idx):
                return False
        return True

    def VisualizeResults(self, save_idx: int) -> bool:  # noqa: N802
        for modality in self.tracking_modality_ptrs:
            if not modality.VisualizeResults(save_idx):
                return False
        return True

    def AreAllObjectsSetUp(self) -> bool:  # noqa: N802
        return self._are_all_objects_set_up()

    def StartModalities(self, iteration: int) -> bool:  # noqa: N802
        for renderer in self.starting_start_modality_renderer_ptrs:
            if not renderer.StartRendering():
                return False
        for histograms in self.starting_color_histograms_ptrs:
            if not histograms.ClearMemory():
                return False
        for modality in self.starting_modality_ptrs:
            if not modality.StartModality(iteration, 0):
                return False
        for histograms in self.starting_color_histograms_ptrs:
            if not histograms.InitializeHistograms():
                return False
        return True

    def CalculateCorrespondences(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.correspondences", iteration):
            for renderer in self.tracking_correspondence_renderer_ptrs:
                if not renderer.StartRendering():
                    return False
            for modality in self.tracking_modality_ptrs:
                if not modality.CalculateCorrespondences(iteration, corr_iteration):
                    return False
            return True

    def CalculateGradientAndHessian(self, iteration: int, corr_iteration: int,
                                    update_iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.gradient_hessian", iteration):
            for modality in self.tracking_modality_ptrs:
                if not modality.CalculateGradientAndHessian(iteration, corr_iteration,
                                                            update_iteration):
                    return False
            return True

    def CalculateOptimization(self, iteration: int, corr_iteration: int,
                              update_iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.optimization", iteration):
            for optimizer in self.tracking_optimizer_ptrs:
                if not optimizer.CalculateOptimization(iteration, corr_iteration,
                                                       update_iteration):
                    return False
            return True

    def CalculateResults(self, iteration: int) -> bool:  # noqa: N802
        with timing.span("tracker.results", iteration):
            for renderer in self.tracking_results_renderer_ptrs:
                if not renderer.StartRendering():
                    return False
            for histograms in self.tracking_color_histograms_ptrs:
                if not histograms.ClearMemory():
                    return False
            for modality in self.tracking_modality_ptrs:
                if not modality.CalculateResults(iteration):
                    return False
            for histograms in self.tracking_color_histograms_ptrs:
                if not histograms.UpdateHistograms():
                    return False
            return True

    # -- internals ---------------------------------------------------------------------

    def _move_back_poses(self, names) -> None:
        import numpy as np

        background_pose = np.eye(4, dtype=np.float32)
        background_pose[2, 3] = -10.0
        for optimizer in self.optimizer_ptrs:
            if optimizer.name in names:
                for link in optimizer.ReferencedLinks():
                    link.set_link2world_pose(background_pose)

    def _validate_names(self) -> None:
        detector_optimizer_names = {
            o.name for d in self.detector_ptrs for o in d.optimizer_ptrs
        }
        self.names_detecting &= detector_optimizer_names
        self.names_starting &= self.names_all
        self.names_tracking -= self.names_detecting
        self.names_tracking -= self.names_starting

    def _assemble_internally_used_object_ptrs(self) -> None:
        self.detecting_detector_ptrs = []
        for detector in self.detector_ptrs:
            if any(o.name in self.names_detecting for o in detector.optimizer_ptrs):
                add_ptr_if_name_not_exists(detector, self.detecting_detector_ptrs)
        self.detecting_refiner_ptrs = []
        for refiner in self.refiner_ptrs:
            if any(o.name in self.names_detecting for o in refiner.optimizer_ptrs):
                add_ptr_if_name_not_exists(refiner, self.detecting_refiner_ptrs)

        self.starting_modality_ptrs = []
        self.starting_start_modality_renderer_ptrs = []
        self.starting_color_histograms_ptrs = []
        for optimizer in self.optimizer_ptrs:
            if (optimizer.name not in self.names_detecting
                    and optimizer.name in self.names_starting):
                for link in optimizer.ReferencedLinks():
                    for modality in link.modality_ptrs:
                        add_ptr_if_name_not_exists(modality, self.starting_modality_ptrs)
                        _add_ptrs(modality.start_modality_renderer_ptrs(),
                                  self.starting_start_modality_renderer_ptrs)
                        if modality.color_histograms_ptr_shared() is not None:
                            add_ptr_if_name_not_exists(
                                modality.color_histograms_ptr_shared(),
                                self.starting_color_histograms_ptrs)

        self.tracking_optimizer_ptrs = []
        self.tracking_modality_ptrs = []
        self.tracking_correspondence_renderer_ptrs = []
        self.tracking_results_renderer_ptrs = []
        self.tracking_color_histograms_ptrs = []
        for optimizer in self.optimizer_ptrs:
            if optimizer.name in self.names_tracking:
                for link in optimizer.ReferencedLinks():
                    for modality in link.modality_ptrs:
                        add_ptr_if_name_not_exists(optimizer,
                                                   self.tracking_optimizer_ptrs)
                        add_ptr_if_name_not_exists(modality,
                                                   self.tracking_modality_ptrs)
                        _add_ptrs(modality.correspondence_renderer_ptrs(),
                                  self.tracking_correspondence_renderer_ptrs)
                        _add_ptrs(modality.results_renderer_ptrs(),
                                  self.tracking_results_renderer_ptrs)
                        if modality.color_histograms_ptr_shared() is not None:
                            add_ptr_if_name_not_exists(
                                modality.color_histograms_ptr_shared(),
                                self.tracking_color_histograms_ptrs)

    def _wait_until_cycle_ends(self, begin: float) -> None:
        elapsed_ms = (time.monotonic() - begin) * 1000.0
        if elapsed_ms < self.cycle_duration_ms:
            time.sleep((self.cycle_duration_ms - elapsed_ms) / 1000.0)
        else:
            print(f"Tracker too slow: elapsed time = {elapsed_ms:.1f} ms > "
                  f"{self.cycle_duration_ms} ms")
