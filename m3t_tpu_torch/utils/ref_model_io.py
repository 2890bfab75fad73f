"""Reader for the reference M3T sparse-viewpoint-model binary format (a copy of
m3t_tpu/utils/ref_model_io.py).

The reference caches generated models as ``<name>.bin`` files (format defined by
``Model::SaveModelParameters``/``SaveBodyData``, m3t/src/model.cpp:286-330, and the
per-class view writers ``RegionModel::SaveModel`` m3t/src/region_model.cpp:309-328 /
``DepthModel::SaveModel`` m3t/src/depth_model.cpp:213-265).  The reference test suite
ships golden model binaries (M3T/data/model_test/*.bin) generated with the reference's
OpenGL pipeline; loading them lets us compare the generated models and run
our modalities on bit-identical model data.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np

KMAX_N_DEPTH_OFFSETS = 30  # model.h kMaxNDepthOffsets


class RefBodyData(NamedTuple):
    geometry_path: str
    geometry_unit_in_meter: float
    geometry_counterclockwise: bool
    geometry_enable_culling: bool
    maximum_body_diameter: float
    geometry2body_pose: np.ndarray  # (4, 4)


class RefModel(NamedTuple):
    model_type: str  # 'r' region / 'd' depth
    version_id: int
    sphere_radius: float
    n_divides: int
    n_points: int
    max_radius_depth_offset: float
    stride_depth_offset: float
    use_random_seed: bool
    image_size: int
    body: RefBodyData
    associated_bodies: list
    orientations: np.ndarray  # (V, 3)
    centers: np.ndarray  # (V, N, 3)
    normals: np.ndarray  # (V, N, 3)
    foreground_distances: np.ndarray | None  # (V, N) region only
    background_distances: np.ndarray | None  # (V, N) region only
    depth_offsets: np.ndarray  # (V, N, 30)
    contour_lengths: np.ndarray | None  # (V,) region only
    surface_areas: np.ndarray | None  # (V,) depth only


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def take(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.data, self.off)
        self.off += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def take_bytes(self, n: int) -> bytes:
        out = self.data[self.off:self.off + n]
        self.off += n
        return out

    def take_floats(self, n: int) -> np.ndarray:
        out = np.frombuffer(self.data, np.float32, n, self.off).copy()
        self.off += 4 * n
        return out


def _read_body_data(r: _Reader) -> RefBodyData:
    path_len = r.take("Q")
    path = r.take_bytes(path_len).decode(errors="replace")
    unit = r.take("f")
    ccw, cull = r.take("??")
    diameter = r.take("f")
    # Transform3fA stores a column-major 4x4 float matrix.
    pose = r.take_floats(16).reshape(4, 4).T.copy()
    return RefBodyData(path, unit, bool(ccw), bool(cull), diameter, pose)


def load_ref_model(path: str) -> RefModel:
    """Load a reference-format .bin sparse viewpoint model (region or depth)."""
    r = _Reader(open(path, "rb").read())
    model_type = r.take_bytes(1).decode()
    if model_type not in ("r", "d"):
        raise ValueError(f"{path}: unknown model type {model_type!r} (expected 'r' or 'd')")
    version_id = r.take("i")
    # kVersionID: region_model.h:59 (10) / depth_model.h:47 (9). The reference rejects a
    # mismatch in LoadModelParameters; parsing a different layout would yield garbage.
    expected_version = 10 if model_type == "r" else 9
    if version_id != expected_version:
        raise ValueError(
            f"{path}: version_id {version_id} != expected {expected_version} "
            f"for model type {model_type!r}")
    sphere_radius = r.take("f")
    n_divides = r.take("i")
    n_points = r.take("i")
    max_radius_depth_offset = r.take("f")
    stride_depth_offset = r.take("f")
    use_random_seed = r.take("?")
    image_size = r.take("i")
    body = _read_body_data(r)

    associated = []
    if model_type == "r":
        r.take("Q")  # total associated bodies
        for _ in range(4):  # fixed / fixed_same_region / movable / movable_same_region
            n = r.take("Q")
            associated.append([_read_body_data(r) for _ in range(n)])
    else:
        n = r.take("Q")  # occlusion bodies
        associated.append([_read_body_data(r) for _ in range(n)])

    n_views = r.take("Q")
    V, N, K = n_views, n_points, KMAX_N_DEPTH_OFFSETS
    centers = np.zeros((V, N, 3), np.float32)
    normals = np.zeros((V, N, 3), np.float32)
    fg = np.zeros((V, N), np.float32) if model_type == "r" else None
    bg = np.zeros((V, N), np.float32) if model_type == "r" else None
    offsets = np.zeros((V, N, K), np.float32)
    orientations = np.zeros((V, 3), np.float32)
    contour_lengths = np.zeros((V,), np.float32) if model_type == "r" else None
    surface_areas = np.zeros((V,), np.float32) if model_type == "d" else None

    # DataPoint layouts (all-float structs, no padding):
    #   region (region_model.h:89-95): center(3) normal(3) fg bg offsets(30) = 38 floats
    #   depth  (depth_model.h:67-71):  center(3) normal(3) offsets(30)       = 36 floats
    n_floats = 38 if model_type == "r" else 36
    for v in range(V):
        dp = r.take_floats(N * n_floats).reshape(N, n_floats)
        centers[v] = dp[:, 0:3]
        normals[v] = dp[:, 3:6]
        if model_type == "r":
            fg[v] = dp[:, 6]
            bg[v] = dp[:, 7]
            offsets[v] = dp[:, 8:38]
        else:
            offsets[v] = dp[:, 6:36]
        orientations[v] = r.take_floats(3)
        if model_type == "r":
            contour_lengths[v] = r.take("f")
        else:
            surface_areas[v] = r.take("f")

    if r.off != len(r.data):
        raise ValueError(f"{path}: {len(r.data) - r.off} unparsed trailing bytes")
    return RefModel(model_type, version_id, sphere_radius, n_divides, n_points,
                    max_radius_depth_offset, stride_depth_offset, bool(use_random_seed),
                    image_size, body, associated, orientations, centers, normals,
                    fg, bg, offsets, contour_lengths, surface_areas)
