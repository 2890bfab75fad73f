"""Evaluation-scale rigid tracking: ``pipeline.initialize_histograms`` at set-up, then one
``pipeline.tracking_cycle`` per step over every sequence, each on a frame of its own, the
poses read to the host after every step (as the evaluators read them to score a frame).
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from benchmark.harness import check, cycle, roofline
from benchmark.harness.driver import ClosedLoop
from benchmark.traffic import generator


class Side(NamedTuple):
    """What computes the start and each step: ``start(images, poses) -> state`` and
    ``cycle(images, state) -> state``."""

    start: object
    cycle: object


def program_side(driver) -> Side:
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.ops import region_fn

    pcfg = cycle.pipeline_config(pipeline, region_fn, driver.config)
    intr = driver.intr
    model = cycle.region_model(pipeline, driver.config, driver.n, driver.device)
    return Side(lambda images, poses: pipeline.initialize_histograms(pcfg, intr, images,
                                                                     model, poses),
                lambda images, state: pipeline.tracking_cycle(pcfg, intr, images, model,
                                                              state))


def reference_side(driver, tf32: bool = False) -> Side:
    """The plain reference, in float32 or (tf32) with its matmuls in TF32."""
    from benchmark.reference import region

    settings = region.Settings.from_config(driver.config)
    model = region.Model.from_arrays(cycle.region_arrays(driver.config), driver.device)

    def precision():
        return check.TF32Matmuls() if tf32 else contextlib.nullcontext()

    def start(images, poses):
        with precision():
            return cycle.State(*region.start(settings, images, model, poses))

    def step(images, state):
        with precision():
            return cycle.State(*region.cycle(settings, images, model, tuple(state)))

    return Side(start, step)


class Driver(ClosedLoop):
    def __init__(self, cell, config, traffic, seed, device, side=None):
        super().__init__(cell, config, traffic, seed, device, side)
        self.n = traffic["batch"]
        self.units_per_step = self.n
        self.intr = cycle.intrinsics(config)

    def setup(self) -> None:
        self.seq = generator.sequences(self.traffic, self.config, self.seed, self.device)
        self.poses0 = torch.as_tensor(self.seq.start, device=self.device)
        self.side = (self.side_factory or program_side)(self)
        self.start = self.side.start(self.seq.colour[0], self.poses0)
        self.state = self.start
        self.warm_up()
        self.read_capture_s()

    def step(self, traced: bool) -> None:
        index, frame = self.window_step(), self.frame(self.t + 1)
        state_in = self.state
        self.mark("step")
        self.mark("cycle")
        self.state = self.side.cycle(self.seq.colour[frame], state_in)
        self.mark("cycle_end")
        positions = self.state.body2camera_pose[:, :3, 3].cpu()
        self.t += 1
        self.record(frame, positions[:, None], state_in, self.state, index)

    def outcome(self):
        return super().outcome(self.seq.truth)

    def kernel_work(self) -> dict:
        """The kernels' work in one more cycle, run eagerly from the window's last state
        (after the window)."""
        with roofline.recorded_calls() as calls:
            self.side.cycle(self.seq.colour[self.frame(self.t + 1)], self.state)
        return roofline.cycle_work(calls)

    def free(self) -> None:
        self.side = self.state = None
        self.free_program()

    def reference(self) -> Side:
        return reference_side(self)

    def start_inputs(self) -> tuple:
        return self.seq.colour[0], self.poses0

    def frame_inputs(self, frame: int) -> tuple:
        return (self.seq.colour[frame],)
