"""Live tracking through the object graph: one iteration of RunTrackerProcess's loop per
step (``UpdateCameras``, ``CalculateConsistentPoses``, ``ExecuteTrackingStep``) on a
``Tracker(use_fused_cycle=True)`` whose bodies' poses the fused backend reads back to
the host every step.  Detection and the starting step run at set-up, on frame 0.

The backend's cycle call goes through a stand-in for ``fused_serve``'s ``pipeline``
module: it opens the ``serve.cycle`` range in traced steps, keeps the checkpoints' input
and output states for the reference, and is where the control or a fault takes the
program's place.
"""

from __future__ import annotations

import contextlib
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, cycle, models
from benchmark.harness.driver import ClosedLoop
from benchmark.harness.trace import host_range
from benchmark.traffic import generator


def program_side(driver):
    """``cycle(pcfg, intr, images, model, state, **kw) -> state``: the program's own."""
    from m3t_tpu_torch import pipeline

    return pipeline.tracking_cycle


def reference_side(driver, tf32: bool = False):
    """The plain reference's cycle in the program's call form, in float32 or (tf32) with
    its matmuls in TF32.  Its ``start`` is the reference of the starting step
    (RegionModality.StartModality): the histograms made at the starting pose."""
    from benchmark.reference import region

    settings = region.Settings.from_config(driver.config)
    model = region.Model.from_arrays(cycle.region_arrays(driver.config), driver.device)

    def precision():
        return check.TF32Matmuls() if tf32 else contextlib.nullcontext()

    def run(_pcfg, _intr, images, _model, state, **_):
        if images.shape[-1] == 3:      # (B, H, W, 3) as the camera gives them
            images = images.permute(0, 3, 1, 2)
        with precision():
            return type(state)(*region.cycle(settings, images, model, tuple(state)))

    def start(images, poses):
        with precision():
            return cycle.State(*region.start(settings, images, model, poses))

    run.start = start
    return run


class _Pipeline:
    """``pipeline`` as fused_serve sees it, its tracking_cycle the driver's."""

    def __init__(self, pipeline, driver):
        self._pipeline, self._driver = pipeline, driver

    def __getattr__(self, name):
        return getattr(self._pipeline, name)

    def tracking_cycle(self, pcfg, intr, images, model, state, **kwargs):
        d = self._driver
        with host_range("serve.cycle", d.traced):
            d.mark("cycle")
            out = d.side(pcfg, intr, images, model, state, **kwargs)
            d.mark("cycle_end")
        if d.keep_next:
            d.kept = (tuple(state), out)
        return out


class Driver(ClosedLoop):
    def __init__(self, cell, config, traffic, seed, device, side=None):
        super().__init__(cell, config, traffic, seed, device, side)
        self.n = traffic["batch"]
        if self.n != 1:
            raise ValueError("tracker_loop tracks one body: its sequences render one body "
                             "per frame")
        self.intr = cycle.intrinsics(config)
        self.traced = self.keep_next = False
        self.kept = None

    def setup(self) -> None:
        from m3t_tpu_torch import (body, detector, fused_serve, link, optimizer,
                                   region_modality, region_model, tracker)
        from m3t_tpu_torch.common import Intrinsics

        cfg = self.config
        self.seq = generator.sequences(self.traffic, cfg, self.seed, self.device)
        frames = [np.ascontiguousarray(self.seq.colour[f].permute(0, 2, 3, 1).cpu().numpy())
                  for f in range(self.traffic["ring_frames"])]
        self.frame_now = 0

        def image(i):
            self.frame_now = self.frame(i)
            return frames[self.frame_now][0]

        from m3t_tpu_torch import camera

        fu, fv, ppu, ppv = self.intr
        colour_camera = camera.ImageColorCamera(
            "live_color", Intrinsics(fu, fv, ppu, ppv, cfg["width"], cfg["height"]), image)
        vertices, triangles = models.icosphere(cfg["body_subdivisions"], cfg["body_radius"])
        self.trk = tracker.Tracker("live", n_corr_iterations=cfg["n_corr_iterations"],
                                   n_update_iterations=cfg["n_update_iterations"],
                                   use_fused_cycle=True)
        arrays = cycle.region_arrays(cfg)
        self.links = []
        for i in range(self.n):
            b = body.Body(f"live_body{i}", vertices=vertices, triangles=triangles)
            if not b.SetUp():
                raise RuntimeError(f"body {b.name} failed to set up")
            # The benchmark's model in place of a model file: SetUp takes the arrays as
            # it takes a file's, and neither renders nor writes one.
            shape = cfg["region_model"]
            model = region_model.RegionModel(
                f"live_model{i}", b, str(Path(tempfile.gettempdir()) / "unwritten.npz"),
                sphere_radius=shape["sphere_radius"], n_divides=shape["n_divides"],
                n_points=shape["n_points"], image_size=shape["image_size"])
            model._try_load = lambda checksum: arrays
            model._save = None
            modality = region_modality.RegionModality(f"live_region{i}", b, colour_camera,
                                                      model, device=self.device)
            modality.n_lines_max = cfg["n_lines"]
            modality.scales = list(cfg["scales"])
            modality.standard_deviations = list(cfg["standard_deviations"])
            for key in cycle.REGION_KEYS + ("learning_rate_f", "learning_rate_b"):
                setattr(modality, key, cfg[key])
            body_link = link.Link(f"live_link{i}", b)
            body_link.AddModality(modality)
            body_optimizer = optimizer.Optimizer(
                f"live_optimizer{i}", body_link,
                tikhonov_parameter_rotation=cfg["tikhonov_rotation"],
                tikhonov_parameter_translation=cfg["tikhonov_translation"])
            self.trk.AddOptimizer(body_optimizer)
            self.trk.AddDetector(detector.StaticDetector(
                f"live_detector{i}", body_optimizer, link2world_pose=self.seq.start[i]))
            self.links.append((b, modality))
        if not self.trk.SetUp():
            raise RuntimeError("Tracker.SetUp failed")
        if any(m.region_model_ptr.centers is not arrays["centers"] for _, m in self.links):
            raise RuntimeError("a region model did not take the benchmark's arrays")
        self.camera = colour_camera
        self.side = (self.side_factory or program_side)(self)
        fused_serve.pipeline = _Pipeline(fused_serve.pipeline, self)

        starting = self.trk.ExecuteStartingStep

        def start(iteration):
            starts = bool(self.trk.names_starting)
            ok = starting(iteration)
            if starts:
                if hasattr(self.side, "start"):   # the control's start in the program's
                    self._put_start(self.side.start(self.seq.colour[0],
                                                    self._pose_tensor()))
                self.start = self._graph_state()
            return ok

        self.trk.ExecuteStartingStep = start
        if not self.trk.RunTrackerProcess(execute_detection=True, start_tracking=True,
                                          max_iterations=1):
            raise RuntimeError("RunTrackerProcess failed")
        del self.trk.ExecuteStartingStep
        if self.trk._fused_backend is None:
            raise RuntimeError("the fused serve backend was not built")
        self.t = 1
        self.warm_up()
        self.read_capture_s()

    def _poses(self) -> np.ndarray:
        """Body-to-camera poses (N, 4, 4) of the graph, on the host."""
        w2c = np.asarray(self.camera.world2camera_pose, np.float64)
        return np.stack([w2c @ b.body2world_pose for b, _ in self.links])

    def _graph_state(self):
        """(body-to-camera poses (N, 4, 4), histogram_f, histogram_b) of the graph."""
        histograms = [m.color_histograms_ptr for _, m in self.links]
        return (self._poses(), torch.stack([h.histogram_f for h in histograms]),
                torch.stack([h.histogram_b for h in histograms]))

    def _pose_tensor(self):
        return torch.as_tensor(self._poses(), dtype=torch.float32, device=self.device)

    def _put_start(self, state) -> None:
        for i, (_, m) in enumerate(self.links):
            m.color_histograms_ptr.histogram_f = state.histogram_f[i]
            m.color_histograms_ptr.histogram_b = state.histogram_b[i]

    def step(self, traced: bool) -> None:
        index = self.window_step()
        self.traced = traced
        self.keep_next = index in self.checkpoints
        trk, i = self.trk, self.t
        self.mark("step")
        with host_range("serve.update_cameras", traced):
            ok = trk.UpdateCameras(i)
        with host_range("serve.consistent_poses", traced):
            ok = ok and trk.CalculateConsistentPoses()
        with host_range("serve.tracking_step", traced):
            ok = ok and trk.ExecuteTrackingStep(i)
        if not ok:
            raise RuntimeError(f"tracking step {i} failed")
        self.t += 1
        if index is not None:
            poses = self._poses()
            kept = self.kept if self.keep_next else (None, None)
            self.record(self.frame_now, poses[:, None, :3, 3], *kept, index)
        self.kept = None

    def outcome(self):
        return super().outcome(self.seq.truth)

    def kernel_work(self) -> dict:
        return {}

    def free(self) -> None:
        from m3t_tpu_torch import fused_serve

        fused_serve.pipeline = fused_serve.pipeline._pipeline
        self.trk = self.links = self.side = None
        self.free_program()

    def reference(self):
        """The reference's start and cycle in the fused drivers' form."""
        run = reference_side(self)
        return SimpleNamespace(start=run.start,
                               cycle=lambda images, state: run(None, None, images, None,
                                                               cycle.State(*state)))

    def start_inputs(self) -> tuple:
        return self.seq.colour[0], torch.as_tensor(self.start[0], dtype=torch.float32,
                                                   device=self.device)

    def frame_inputs(self, frame: int) -> tuple:
        return (self.seq.colour[frame],)
