"""Procedural meshes + synthetic frame rendering on the host (port of
m3t_tpu/utils/procedural.py).  The renderers take (T, 3, 3) triangle-vertex arrays and
rasterize with the numpy path of ``rasterize_np`` (float64 throughout), on whose frames
the port's tests and chip_smoke.py's checks are set; the C++ path, which model
generation uses, gives a few edge pixels of a frame another id or depth.
:func:`sphere_body` and :func:`cube_body` make set-up :class:`Body` objects for model
generation."""

from __future__ import annotations

import numpy as np

from m3t_tpu_torch.body import Body
from m3t_tpu_torch.common import Intrinsics
from m3t_tpu_torch.ops.raster import rasterize_np


def icosphere(n_subdiv: int = 2, radius: float = 0.05):
    """Geodesic sphere mesh (vertices CCW when viewed from outside)."""
    x = 0.525731112119133606
    z = 0.850650808352039932
    verts = np.array(
        [
            [-x, 0, z], [x, 0, z], [-x, 0, -z], [x, 0, -z],
            [0, z, x], [0, z, -x], [0, -z, x], [0, -z, -x],
            [z, x, 0], [-z, x, 0], [z, -x, 0], [-z, -x, 0],
        ],
        np.float64,
    )
    faces = np.array(
        [
            [0, 4, 1], [0, 9, 4], [9, 5, 4], [4, 5, 8], [4, 8, 1],
            [8, 10, 1], [8, 3, 10], [5, 3, 8], [5, 2, 3], [2, 7, 3],
            [7, 10, 3], [7, 6, 10], [7, 11, 6], [11, 0, 6], [0, 1, 6],
            [6, 1, 10], [9, 0, 11], [9, 11, 2], [9, 2, 5], [7, 2, 11],
        ],
        np.int64,
    )
    # The icosahedron face table winds inward; flip for outward normals.
    faces = faces[:, ::-1]
    for _ in range(n_subdiv):
        new_faces = []
        verts = list(verts)
        cache: dict[tuple[int, int], int] = {}

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in cache:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                cache[key] = len(verts)
                verts.append(m)
            return cache[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        faces = np.asarray(new_faces, np.int64)
        verts = np.asarray(verts, np.float64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def cube(half: float = 0.05):
    """Axis-aligned cube, outward CCW winding (m3t_tpu/utils/procedural.py:61-79)."""
    v = np.array(
        [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
         [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]],
        np.float32,
    ) * half
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # z = -1 face (outward -z)
            [4, 5, 6], [4, 6, 7],  # z = +1
            [0, 1, 5], [0, 5, 4],  # y = -1
            [2, 3, 7], [2, 7, 6],  # y = +1
            [0, 4, 7], [0, 7, 3],  # x = -1
            [1, 2, 6], [1, 6, 5],  # x = +1
        ],
        np.int32,
    )
    return v, f


def sphere_body(name: str = "sphere", radius: float = 0.05, n_subdiv: int = 2) -> Body:
    """An icosphere Body, set up (m3t_tpu/utils/procedural.py:82)."""
    verts, tris = icosphere(n_subdiv, radius)
    body = Body(name, vertices=verts, triangles=tris)
    if not body.SetUp():
        raise RuntimeError(f"Body {name} failed to set up")
    return body


def cube_body(name: str = "cube", half: float = 0.05) -> Body:
    """A cube Body, set up (m3t_tpu/utils/procedural.py:89)."""
    verts, tris = cube(half)
    body = Body(name, vertices=verts, triangles=tris)
    if not body.SetUp():
        raise RuntimeError(f"Body {name} failed to set up")
    return body


def sphere_triangles(radius: float = 0.05, n_subdiv: int = 2) -> np.ndarray:
    """(T, 3, 3) body-frame triangle vertices of an icosphere."""
    verts, tris = icosphere(n_subdiv, radius)
    return verts[tris]


def render_synthetic_color_frame(
    triangles_f_body: np.ndarray, intrinsics: Intrinsics, body2camera_pose: np.ndarray,
    fg_color=(160, 60, 50), bg_color=(40, 120, 190), noise_rng=None,
    shaded: bool = True,
) -> np.ndarray:
    """Rasterize (T, 3, 3) body-frame triangles with simple Lambertian shading over a
    bg color (BGR uint8, (H, W, 3)).

    Shading spreads foreground colors over many histogram bins, matching the broad
    histograms of real footage (a flat color produces pathological delta histograms).
    """
    tri_cam = triangles_f_body @ body2camera_pose[:3, :3].T + body2camera_pose[:3, 3]
    _, id_img, normal = rasterize_np(
        tri_cam, np.full(len(triangles_f_body), 1), intrinsics.fu, intrinsics.fv,
        intrinsics.ppu, intrinsics.ppv, intrinsics.width, intrinsics.height,
        cull_backfaces=True, with_normals=True, use_native=False,
    )
    image = np.empty((intrinsics.height, intrinsics.width, 3), np.uint8)
    image[:] = np.asarray(bg_color, np.uint8)
    fg = id_img == 1
    if shaded:
        light = np.asarray([0.4, -0.5, -0.77])
        lambert = np.clip(-(normal @ light), 0.0, 1.0)
        shade = (0.55 + 0.45 * lambert)[..., None]
        image[fg] = np.clip(np.asarray(fg_color, np.float64) * shade[fg], 0, 255
                            ).astype(np.uint8)
    else:
        image[fg] = np.asarray(fg_color, np.uint8)
    if noise_rng is not None:
        noise = noise_rng.integers(-8, 9, size=image.shape)
        image = np.clip(image.astype(np.int16) + noise, 0, 255).astype(np.uint8)
    return image


def render_synthetic_depth_frame(
    triangles_f_body: np.ndarray, intrinsics: Intrinsics, body2camera_pose: np.ndarray,
    depth_scale: float = 0.001, background_depth: float = 2.0,
) -> np.ndarray:
    """Rasterize (T, 3, 3) body-frame triangles into a (H, W) uint16 depth image in
    units of ``depth_scale`` meters, ``background_depth`` where nothing is hit."""
    tri_cam = triangles_f_body @ body2camera_pose[:3, :3].T + body2camera_pose[:3, 3]
    depth, _ = rasterize_np(
        tri_cam, np.full(len(triangles_f_body), 1), intrinsics.fu, intrinsics.fv,
        intrinsics.ppu, intrinsics.ppv, intrinsics.width, intrinsics.height,
        cull_backfaces=True, use_native=False,
    )
    metric = np.where(np.isfinite(depth), depth, background_depth)
    return np.round(metric / depth_scale).astype(np.uint16)


def orbit_camera(center, angle_deg: float, off_axis_deg: float = 0.0) -> np.ndarray:
    """(4, 4) float32 camera-to-reference pose of a second camera: the reference camera
    carried ``angle_deg`` about the vertical (y) axis through ``center`` (a reference-
    frame point), so that it sees ``center`` from that angle to the side, then turned
    ``off_axis_deg`` about its own y axis, so that ``center`` lies off its optical
    axis."""
    def rot_y(deg):
        a = np.deg2rad(deg)
        pose = np.eye(4)
        pose[0, 0], pose[0, 2], pose[2, 0], pose[2, 2] = np.cos(a), np.sin(a), -np.sin(a), \
            np.cos(a)
        return pose

    def shift(t):
        pose = np.eye(4)
        pose[:3, 3] = t
        return pose

    center = np.asarray(center, np.float64)
    return (shift(center) @ rot_y(angle_deg) @ shift(-center) @ rot_y(off_axis_deg)
            ).astype(np.float32)
