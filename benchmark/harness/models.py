"""The region model of a sphere body, made by the benchmark from the configuration.

M3T's region model (region_model.cpp:187-310, 479-782) holds, for every view of a
geodesic sphere of ``n_divides`` subdivisions around the body, ``n_points`` points of
the body's silhouette contour as a camera ``sphere_radius`` metres away sees it: each
point's 3D position and outward contour normal in the body frame, how far the line
through it stays in the foreground and in the background, and the view's contour length.
For a sphere every one of these has a closed form, so the benchmark writes them down
instead of rendering the mesh: the silhouette of a sphere of radius r seen from distance
D is the circle of the tangent points, in the plane ``x . o = r^2 / D`` (o the unit
vector to the camera) with radius ``rho = r sqrt(1 - r^2 / D^2)``; its normals point away
from the circle's centre, across the image plane; the foreground along a normal is the
silhouette's diameter, ``2 rho``; the background never ends inside the image (M3T writes
the float32 maximum).  M3T draws each view's points at random around its rendered
contour, so two neighbouring views hold unrelated samples; here the points sit at fixed
angles from one body axis as each view sees it, so neighbouring views hold nearly
the same points and a switch between them moves each line by a fraction of a pixel.  A
sphere shows the same silhouette from every view, and with random samples a body whose
direction lies on the border of two views would switch between them from one iteration
to the next and take a different set of lines each time: two sound implementations then
part at their rounding boundaries by as much as the control does.

Both the program and the plain reference receive these arrays; neither derives them.
"""

from __future__ import annotations

import numpy as np

# The golden ratio's fractional part: successive points turn by the golden angle.
GOLDEN = (5.0 ** 0.5 - 1.0) / 2.0
# The body axis the angles start from.
ANCHOR = (1.0, 0.3, 0.2)
# Depth offsets per point (model.h:58); they serve occlusion handling only.
N_DEPTH_OFFSETS = 30


def _subdivided(n_divides: int):
    """M3T's icosahedron (model.cpp:412-454) with each face split in four ``n_divides``
    times, every new vertex pushed out onto the unit sphere: (V, 3) float64 vertices,
    V = 10 * 4^n + 2, and (T, 3) faces, counter-clockwise seen from outside."""
    x, z = 0.525731112119133606, 0.850650808352039932
    verts = [np.array(v, np.float64) for v in (
        (-x, 0, z), (x, 0, z), (-x, 0, -z), (x, 0, -z), (0, z, x), (0, z, -x),
        (0, -z, x), (0, -z, -x), (z, x, 0), (-z, x, 0), (z, -x, 0), (-z, -x, 0))]
    faces = [tuple(f[::-1]) for f in (
        (0, 4, 1), (0, 9, 4), (9, 5, 4), (4, 5, 8), (4, 8, 1), (8, 10, 1), (8, 3, 10),
        (5, 3, 8), (5, 2, 3), (2, 7, 3), (7, 10, 3), (7, 6, 10), (7, 11, 6), (11, 0, 6),
        (0, 1, 6), (6, 1, 10), (9, 0, 11), (9, 11, 2), (9, 2, 5), (7, 2, 11))]
    for _ in range(n_divides):
        middle, split = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in middle:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                middle[key] = len(verts) - 1
            return middle[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            split += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = split
    return np.stack(verts), np.asarray(faces, np.int32)


def geodesic_directions(n_divides: int) -> np.ndarray:
    """(V, 3) float64 unit vectors from the body to the model's cameras."""
    return _subdivided(n_divides)[0]


def icosphere(n_divides: int, radius: float):
    """A sphere's mesh: (V, 3) float32 vertices and (T, 3) int32 faces."""
    verts, faces = _subdivided(n_divides)
    return (verts * radius).astype(np.float32), faces


def sphere_region_model(config: dict) -> dict:
    """The region model of the configuration's sphere, as numpy float32 arrays under the
    names of M3T's model file: ``orientations`` (V, 3), the unit vector from a view's
    camera towards the body; ``centers`` and ``normals`` (V, N, 3); ``foreground_
    distances`` and ``background_distances`` (V, N), metres; ``depth_offsets`` (V, N, 30),
    zero (a convex body occludes nothing of itself); ``contour_lengths`` (V,), the
    contour's length in pixels times ``sphere_radius / f`` of the model's camera, which
    cancels to metres at that distance scaled by ``D / z`` of the contour."""
    model = config["region_model"]
    r, d = float(config["body_radius"]), float(model["sphere_radius"])
    n = int(model["n_points"])
    to_camera = geodesic_directions(int(model["n_divides"]))          # (V, 3)
    v = to_camera.shape[0]
    # Angles around each view's circle from one body axis as the view sees it, so that
    # neighbouring views hold nearly the same points; spread by the golden angle, so
    # that every prefix of a view's points (a smaller line count) rings the circle.  The
    # axis is along no view and far from the views of a body ahead of the camera.
    axis = np.asarray(ANCHOR) / np.linalg.norm(ANCHOR)
    e1 = axis - (to_camera @ axis)[:, None] * to_camera
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(to_camera, e1)
    phi = 2.0 * np.pi * np.mod(np.arange(n) * GOLDEN, 1.0)[None]
    radial = np.cos(phi)[..., None] * e1[:, None] + np.sin(phi)[..., None] * e2[:, None]
    rho = r * np.sqrt(1.0 - (r / d) ** 2)
    centers = to_camera[:, None] * (r * r / d) + rho * radial
    z_contour = d - r * r / d
    return {
        "orientations": (-to_camera).astype(np.float32),
        "centers": centers.astype(np.float32),
        "normals": radial.astype(np.float32),
        "foreground_distances": np.full((v, n), 2.0 * rho, np.float32),
        "background_distances": np.full((v, n), np.finfo(np.float32).max, np.float32),
        "depth_offsets": np.zeros((v, n, N_DEPTH_OFFSETS), np.float32),
        "contour_lengths": np.full((v,), 2.0 * np.pi * rho * d / z_contour, np.float32),
    }
