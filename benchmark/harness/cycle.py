"""A configuration's cycle inputs: the camera, the program's settings and the region model.

The region model is the benchmark's own (``harness/models.py``); the program receives it
in its ``RegionModelArrays`` layout, the plain reference in its own (``reference.region``).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from benchmark.harness import models

# RegionConfig fields of the program that a configuration states, under the same names.
REGION_KEYS = ("function_length", "distribution_length", "function_amplitude",
               "function_slope", "learning_rate", "n_global_iterations",
               "min_continuous_distance", "n_histogram_bins", "unconsidered_line_length",
               "max_considered_line_length")
PIPELINE_KEYS = ("n_corr_iterations", "n_update_iterations", "tikhonov_rotation",
                 "tikhonov_translation", "learning_rate_f", "learning_rate_b")


def intrinsics(config: dict) -> tuple:
    """(fu, fv, ppu, ppv) of the configuration's camera."""
    return tuple(float(config[k]) for k in ("fu", "fv", "ppu", "ppv"))


def pipeline_config(pipeline, region_fn, config: dict):
    """The program's PipelineConfig for a configuration (``pipeline`` and ``region_fn``:
    the program's modules)."""
    return pipeline.PipelineConfig(
        cfg=region_fn.RegionConfig(n_lines_max=config["n_lines"],
                                   **{k: config[k] for k in REGION_KEYS}),
        scales=tuple(config["scales"]),
        standard_deviations=tuple(config["standard_deviations"]),
        **{k: config[k] for k in PIPELINE_KEYS})


def region_arrays(config: dict) -> dict:
    """The configuration's region model as numpy arrays (M3T's model file names)."""
    return models.sphere_region_model(config)


def region_model(pipeline, config: dict, n_bodies: int, device):
    """The program's RegionModelArrays of the configuration's model, one per body (as
    views of one copy)."""
    model = SimpleNamespace(set_up=True, **region_arrays(config))
    return pipeline.RegionModelArrays.from_models([model], config["n_lines"],
                                                  device=device).expand(n_bodies)


class State(NamedTuple):
    """A tracking state as the program's TrackingState names its fields."""

    body2camera_pose: torch.Tensor
    histogram_f: torch.Tensor
    histogram_b: torch.Tensor
