"""The port's contour tracer against OpenCV's findContours(RETR_LIST, CHAIN_APPROX_NONE).

``m3t_tpu_torch.utils.contours.find_contours`` must give the same contours in the same
order, each from the same start pixel in the same direction: the region model samples
its points from them with mt19937 draws (PARITY.md, "Bit-exact sampling").  Every
family below draws 40 seeded masks.
"""

import cv2
import numpy as np
import pytest

from m3t_tpu_torch.common import np_pose_inverse
from m3t_tpu_torch.model_base import generate_geodesic_poses
from m3t_tpu_torch.ops.raster import rasterize_np
from m3t_tpu_torch.utils import procedural
from m3t_tpu_torch.utils.contours import find_contours

N_MASKS = 40


def _cv2_contours(mask):
    found, _ = cv2.findContours(mask, cv2.RETR_LIST, cv2.CHAIN_APPROX_NONE)
    return [c.reshape(-1, 2) for c in found]


def _assert_same(mask):
    got, want = find_contours(mask), _cv2_contours(mask)
    assert len(got) == len(want), f"{len(got)} contours, cv2 has {len(want)}\n{mask}"
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.int32 and g.shape == w.shape, f"contour {i}\n{mask}"
        np.testing.assert_array_equal(g, w, err_msg=f"contour {i}\n{mask}")


def _noise(rng):
    h, w = rng.integers(1, 30, 2)
    return (rng.random((h, w)) < rng.uniform(0.05, 0.95)).astype(np.uint8)


def _nested(rng):
    """Concentric square rings: holes inside blobs inside holes, some touching."""
    n = int(rng.integers(9, 40))
    mask = np.zeros((n, n + int(rng.integers(0, 5))), np.uint8)
    r = 0
    while r < n // 2:
        width = int(rng.integers(1, 3))
        mask[r:n - r, r:mask.shape[1] - r] = 1 - mask[r, r]
        r += width
    return mask


def _lines(rng):
    """One-pixel-wide strokes, diagonal-only contacts and isolated pixels."""
    h, w = rng.integers(4, 32, 2)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 6))):
        y, x = rng.integers(0, h), rng.integers(0, w)
        dy, dx = rng.integers(-1, 2, 2)
        for _ in range(int(rng.integers(1, 20))):
            if 0 <= y < h and 0 <= x < w:
                mask[y, x] = 1
            y, x = y + dy, x + dx
    for _ in range(int(rng.integers(0, 5))):
        mask[rng.integers(0, h), rng.integers(0, w)] = 1
    return mask


def _checkerboard(rng):
    """Pixels touching only at corners, with solid patches and holes of one pixel."""
    h, w = rng.integers(2, 20, 2)
    mask = ((np.arange(h)[:, None] + np.arange(w)) % 2).astype(np.uint8)
    for _ in range(int(rng.integers(0, 4))):
        y, x = rng.integers(0, h), rng.integers(0, w)
        mask[y:y + 3, x:x + 3] = 1
        if rng.random() < 0.5:
            mask[min(y + 1, h - 1), min(x + 1, w - 1)] = 0
    return mask


def _edges(rng):
    """Blobs that run off every edge and corner of the image."""
    h, w = rng.integers(3, 30, 2)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 6))):
        y0, x0 = rng.integers(-3, h), rng.integers(-3, w)
        y1, x1 = y0 + int(rng.integers(1, 8)), x0 + int(rng.integers(1, 8))
        mask[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = 1
    mask[rng.integers(0, h)] |= rng.random(w) < 0.5
    mask[:, rng.integers(0, w)] |= rng.random(h) < 0.5
    return mask


def _shapes(rng):
    """Filled and outlined ellipses and rectangles, some overlapping, some holed."""
    h, w = rng.integers(20, 80, 2)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.integers(1, 6))):
        center = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        axes = (int(rng.integers(1, 20)), int(rng.integers(1, 20)))
        thickness = -1 if rng.random() < 0.5 else int(rng.integers(1, 3))
        value = int(rng.random() < 0.8)
        if rng.random() < 0.5:
            cv2.ellipse(mask, center, axes, float(rng.uniform(0, 180)), 0, 360, value,
                        thickness)
        else:
            cv2.rectangle(mask, center, (center[0] + axes[0], center[1] + axes[1]), value,
                          thickness)
    return mask


def _values(rng):
    """Masks whose foreground is any nonzero byte, as cv2 reads them."""
    mask = _noise(rng)
    return (mask * rng.integers(1, 256, mask.shape)).astype(np.uint8)


FAMILIES = {"noise": _noise, "nested holes": _nested, "lines and pixels": _lines,
            "diagonal contacts": _checkerboard, "image edges": _edges, "shapes": _shapes,
            "nonzero values": _values}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_find_contours_matches_cv2(family):
    rng = np.random.default_rng(sum(map(ord, family)))
    for _ in range(N_MASKS):
        _assert_same(FAMILIES[family](rng))


@pytest.mark.parametrize("mask", [np.zeros((5, 7), np.uint8), np.ones((1, 1), np.uint8),
                                  np.ones((3, 4), np.uint8), np.ones((1, 9), np.uint8),
                                  np.zeros((1, 0), np.uint8)],
                         ids=["empty", "one pixel", "full", "one row", "no columns"])
def test_find_contours_edge_cases(mask):
    if mask.size == 0:
        assert find_contours(mask) == []
    else:
        _assert_same(mask)


@pytest.mark.parametrize("body", ["sphere", "cube and sphere"])
def test_find_contours_on_model_silhouettes(body):
    """The silhouettes that model generation traces: geodesic views of the fixture
    sphere, and of the sphere with a fixed cube beside it (two bodies, touching and
    overlapping in some views), at image size 300."""
    sphere = procedural.sphere_body("contour_sphere", 0.05, 2)
    tri = [sphere.triangle_vertices_f_body()]
    if body != "sphere":
        cube = procedural.cube_body("contour_cube", 0.03)
        tri.append(cube.triangle_vertices_f_body() + np.float32([0.06, 0.02, 0.0]))
    tri = np.concatenate(tri)
    for cam2body in generate_geodesic_poses(1, 0.5):
        world2cam = np_pose_inverse(cam2body)
        tri_cam = tri @ world2cam[:3, :3].T + world2cam[:3, 3]
        _, sil = rasterize_np(tri_cam, np.full(len(tri), 255), 400.0, 400.0, 150.0, 150.0,
                              300, 300, cull_backfaces=True)
        mask = (sil == 255).astype(np.uint8)
        assert mask.any()
        _assert_same(mask)
