"""Region-modality configuration and measured occlusions (port of
m3t_tpu/ops/region_fn.py:32-71, 102-114, 183-223)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3t_tpu_torch.ops import depth_fn


class RegionConfig(NamedTuple):
    """Static configuration (defaults: region_modality.h:411-443)."""

    n_lines_max: int = 200
    function_length: int = 8
    distribution_length: int = 12
    function_amplitude: float = 0.43
    function_slope: float = 0.5
    learning_rate: float = 1.3
    n_global_iterations: int = 1
    min_continuous_distance: float = 3.0
    n_histogram_bins: int = 16
    unconsidered_line_length: float = 0.5
    max_considered_line_length: float = 20.0
    measured_occlusion_radius: float = 0.01
    measured_occlusion_threshold: float = 0.03
    modeled_occlusion_radius: float = 0.01
    modeled_occlusion_threshold: float = 0.03
    min_n_unoccluded_lines: int = 0

    @property
    def line_length_in_segments(self) -> int:
        # PrecalculateDistributionVariables (region_modality.cpp:926)
        return self.function_length + self.distribution_length - 1

    @property
    def min_expected_variance(self) -> float:
        # region_modality.cpp:931-935
        laplace = 1.0 / (2.0 * np.arctanh(2.0 * self.function_amplitude) ** 2)
        return float(max(laplace, self.function_slope))

    def function_lookups(self):
        """Smoothed step function lookup tables (PrecalculateFunctionLookup:910-923),
        as float32 numpy arrays."""
        i = np.arange(self.function_length, dtype=np.float32)
        x = i - (self.function_length - 1) / 2.0
        if self.function_slope == 0.0:
            f = 0.5 - self.function_amplitude * np.sign(x)
        else:
            f = 0.5 - self.function_amplitude * np.tanh(x / (2.0 * self.function_slope))
        return np.asarray(f, np.float32), np.asarray(1.0 - f, np.float32)


class MeasuredOcclusionInputs(NamedTuple):
    """Depth images for the region lines' measured-occlusion check, batched."""

    depth_image: torch.Tensor  # (B, H, W) uint16
    body2depth_camera_pose: torch.Tensor  # (B, 4, 4)
    fu: float
    fv: float
    ppu: float
    ppv: float
    depth_scale: float
    # Optional (d (B, L, K, K) raw depth, ok (B, L, K, K)) from
    # ops/depth_fast.presample_occlusion_windows: replaces the window gather from the
    # full image (identical wherever the window lies inside the body-centred crop).
    presampled: tuple | None = None


def _measured_occlusion_free(cfg: RegionConfig, center_f_body, depth_offset,
                             occ: MeasuredOcclusionInputs, width: int, height: int):
    """IsLineUnoccludedMeasured (region_modality.cpp:1343-1389) for (B, L, 3) line
    centers and (B, L) depth offsets -> (B, L) bool."""
    pose = occ.body2depth_camera_pose
    c = center_f_body @ pose[:, :3, :3].transpose(1, 2) + pose[:, None, :3, 3]
    z = c[..., 2]
    z_safe = torch.where(z > 0.0, z, torch.ones_like(z))
    cu = c[..., 0] * occ.fu / z_safe + occ.ppu
    cv = c[..., 1] * occ.fv / z_safe + occ.ppv

    meter_to_pixel = depth_fn.rdiv(occ.fu, z_safe)
    diameter = 2.0 * cfg.measured_occlusion_radius * meter_to_pixel
    min_depth = (z - depth_offset - cfg.measured_occlusion_threshold) / occ.depth_scale

    if occ.presampled is not None:
        d, sample_ok = occ.presampled
    else:
        # region_modality.h:145 and depth_modality.h:113 agree on the stride count.
        n_strides = depth_fn.KMAX_N_OCCLUSION_STRIDES
        u_min, v_min, u_max, v_max, stride = depth_fn.window_bounds(
            diameter, n_strides, cu, cv, width, height)
        d, sample_ok, _, _ = depth_fn.window_samples(
            occ.depth_image, width, height, u_min, v_min, u_max, v_max, stride,
            n_strides + 1)
    return depth_fn.strided_window_min_free(d, sample_ok, min_depth)
