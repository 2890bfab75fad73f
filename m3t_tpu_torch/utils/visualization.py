"""Per-modality visualization helpers (port of m3t_tpu/utils/visualization.py;
reference: region_modality.cpp:1660-1805).

The reference's de-facto debugging observability: correspondence-line overlays,
correspondence-point overlays, and per-pixel posterior ("histogram") images, shown
with cv2.imshow when ``display_visualization`` is set and written to
``save_directory`` when ``save_visualizations`` is set.  Headless-safe: imshow
failures are swallowed.  ``cv2`` is imported only where an image is shown, saved or
drawn on.
"""

from __future__ import annotations

import os

import numpy as np

KPOINT_COLOR = (24, 184, 234)       # region_modality.cpp:1675 (BGR)
KHIGH_PROB_COLOR = (61, 63, 179)    # region_modality.cpp:1726


def show_and_save_image(title: str, save_index: int, image: np.ndarray,
                        display: bool, save: bool, save_directory: str,
                        save_image_type: str) -> None:
    """ShowAndSaveImage (region_modality.cpp:1660-1669)."""
    import cv2

    if display:
        try:
            cv2.imshow(title, image)
            cv2.waitKey(1)
        except cv2.error:
            pass  # headless environment
    if save:
        os.makedirs(save_directory, exist_ok=True)
        path = os.path.join(save_directory,
                            f"{title}_{save_index}.{save_image_type}")
        cv2.imwrite(path, image)


def probability_image(color_image: np.ndarray, hist_f, hist_b, n_bins: int,
                      color_b=(255, 255, 255)) -> np.ndarray:
    """DrawProbabilityImage (cpp:1786-1805): per-pixel background posterior."""
    import torch

    from m3t_tpu_torch.ops import histogram as hist_ops

    _, pb = hist_ops.lookup_probabilities(
        hist_f, hist_b, torch.as_tensor(color_image, device=hist_f.device), n_bins)
    pb = pb.cpu().numpy()
    out = (pb[..., None] * np.asarray(color_b, np.float32)).astype(np.uint8)
    return out


def draw_points(image: np.ndarray, centers_f_camera: np.ndarray, fu, fv, ppu, ppv,
                color=KPOINT_COLOR) -> None:
    """DrawPointInImage over correspondence centers (common.cpp draw helpers)."""
    import cv2

    h, w = image.shape[:2]
    for c in centers_f_camera:
        if c[2] <= 0:
            continue
        u = int(c[0] * fu / c[2] + ppu + 0.5)
        v = int(c[1] * fv / c[2] + ppv + 0.5)
        if 0 <= u < w and 0 <= v < h:
            cv2.circle(image, (u, v), 1, color, -1)


def draw_focused_points(image: np.ndarray, centers_f_camera: np.ndarray,
                        fu, fv, ppu, ppv, corner_u, corner_v, scale,
                        color=KPOINT_COLOR) -> None:
    """DrawFocusedPointInImage: points in a focused renderer crop."""
    import cv2

    h, w = image.shape[:2]
    for c in centers_f_camera:
        if c[2] <= 0:
            continue
        u = int(((c[0] * fu / c[2] + ppu) - corner_u) * scale + 0.5)
        v = int(((c[1] * fv / c[2] + ppv) - corner_v) * scale + 0.5)
        if 0 <= u < w and 0 <= v < h:
            cv2.circle(image, (u, v), 1, color, -1)


def draw_correspondence_lines(image: np.ndarray, center_u, center_v, normal_u,
                              normal_v, distribution, valid, scale: int,
                              distribution_length: int,
                              color_line=KPOINT_COLOR,
                              color_high=KHIGH_PROB_COLOR) -> None:
    """DrawLines (region_modality.cpp:1758-1784): staircase walk per line, pixel
    color blended toward ``color_high`` by 3x the local distribution value."""
    h, w = image.shape[:2]
    fscale = float(scale)
    dist_len_minus_1_half = (distribution_length - 1) * 0.5
    scale_minus_1_half = (fscale - 1.0) * 0.5
    cl = np.asarray(color_line, np.float32)
    ch = np.asarray(color_high, np.float32)

    for li in range(len(center_u)):
        if not valid[li]:
            continue
        nu, nv = float(normal_u[li]), float(normal_v[li])
        if abs(nu) > abs(nv):
            u_step = np.sign(nu)
            v_step = nv / abs(nu)
        else:
            u_step = nu / abs(nv) if abs(nv) > 0 else 0.0
            v_step = np.sign(nv)
        x = -fscale * dist_len_minus_1_half - scale_minus_1_half
        u = float(center_u[li]) + u_step * x + 0.5
        v = float(center_v[li]) + v_step * x + 0.5
        for i in range(distribution_length):
            ratio = min(3.0 * float(distribution[li, i]), 1.0)
            col = (ratio * ch + (1.0 - ratio) * cl).astype(np.uint8)
            for _ in range(scale):
                ui, vi = int(u), int(v)
                if 0 <= ui < w and 0 <= vi < h:
                    image[vi, ui] = col
                u += u_step
                v += v_step
