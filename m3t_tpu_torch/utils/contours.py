"""Silhouette contours without OpenCV (``m3t_tpu/region_model.py:241-244`` calls
``cv2.findContours``).

:func:`find_contours` returns what
``[c.reshape(-1, 2) for c in cv2.findContours(mask, cv2.RETR_LIST,
cv2.CHAIN_APPROX_NONE)[0]]`` returns: the same contours in the same order, each from the
same start pixel in the same direction.  The region model's point lookup and its
mt19937 draws depend on that order (PARITY.md, "Bit-exact sampling").  The tracer is
C++ (``native/contours.cpp``), in the host library that the rasterizer lives in.
"""

from __future__ import annotations

import ctypes

import numpy as np

from m3t_tpu_torch import native


def find_contours(mask: np.ndarray) -> list[np.ndarray]:
    """Every border (outer and hole, 8-connectivity, pixels outside the image are 0) of
    a (H, W) mask whose nonzero pixels are foreground, as (N, 2) int32 arrays of (x, y)
    points."""
    mask = np.asarray(mask)
    if mask.ndim != 2:
        raise ValueError(f"find_contours needs a (H, W) mask, got shape {mask.shape}")
    mask = np.ascontiguousarray(mask != 0, np.uint8)
    h, w = mask.shape
    lib = native.library()
    n_contours = ctypes.c_int(0)
    xy_cap, lengths_cap = 4 * (h + w) + 64, 64
    while True:
        xy = np.empty((xy_cap, 2), np.int32)
        lengths = np.empty(lengths_cap, np.int32)
        total = lib.m3t_find_contours(
            mask.ctypes.data_as(ctypes.c_void_p), h, w, xy.ctypes.data_as(ctypes.c_void_p),
            xy_cap, lengths.ctypes.data_as(ctypes.c_void_p), lengths_cap,
            ctypes.byref(n_contours))
        if total <= xy_cap and n_contours.value <= lengths_cap:
            break
        xy_cap, lengths_cap = max(xy_cap, total), max(lengths_cap, n_contours.value)
    ends = np.cumsum(lengths[:n_contours.value])
    return [xy[end - n:end].copy() for end, n in zip(ends, lengths[:n_contours.value])]
