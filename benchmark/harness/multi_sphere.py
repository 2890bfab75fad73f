"""The models of multi-region bodies made of spheres, made by the benchmark from the
configuration.

A multi-region body of M3T (ycb_evaluator.cpp:427-453) is split into sub-bodies, each
with a region model of its own that sums into the body's one Link; the body keeps one
depth model, of the whole body.  Here a body is made of spheres of one radius r, sphere k
centred at ``c_k`` in the body frame, each sub-body one sphere.

Region model of a sub-body (``offset_sphere_region_model``): ``harness/models.py``'s
sphere moved off the body's origin.  A view's camera still sits ``sphere_radius`` (D)
metres from the body's origin along the view's direction o, so it sees the sphere from
``w = D o - c`` (distance D' = |w|, direction o' = w / D'): the silhouette is the circle
of the tangent points in the plane ``(x - c) . o' = r^2 / D'`` with radius ``rho' = r
sqrt(1 - r^2 / D'^2)``; each point's normal is its radial direction across that circle,
laid into the view's image plane (perpendicular to o, where M3T's back-projected image
normals lie), and its foreground the circle's diameter.  With c = 0 this is
``models.sphere_region_model`` itself.

Depth model of the whole body (``union_depth_model``): the points on the union's surface
that the view's camera sees.  Each sphere's visible cap (``(x - c_k) . o'_k >= r^2 /
D'_k``) gets ``n_points / K`` points, placed as ``harness/sphere_depth.py`` places a
sphere's (evenly over the cap as the view sees it, at golden-angle steps from the same
body axis), and the spheres' points take turns in the view's rows.  A point that another
sphere hides from the camera (the segment from the camera to the point enters it) is
dropped: its row repeats the next visible point's row, so that every row of a view lies
on the visible surface and the points a view keeps stay in their rows from one view to
its neighbour (the reason is in ``harness/models.py``'s docstring).

Depth offsets (both models): M3T's (model.cpp:338-384), the point's depth less the
nearest depth of the body's rendered surface within ``(i + 1) stride_depth_offset``
metres of it in the view's image (``max_radius_depth_offset`` bounds i), which keep the
measured-occlusion check from taking a body's own curved surface for an occluder.  Here
in closed form, of the point's own sphere: seen from the camera at distance L along its
axis, the sphere's surface at lateral image distance q (metres at depth L) lies at depth
``t(q) = (L - sqrt(L^2 - (1 + q^2 / L^2) (L^2 - r^2))) / (1 + q^2 / L^2)``, nearest at
``q - R`` for a radius R about a point at q.  (``harness/models.py``'s sphere holds zero
offsets: its cells check no measured occlusions.)

Both the program and the plain reference receive these arrays; neither derives them.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import models


def _frame(axis_to_camera):
    """Unit vectors e1, e2 (V, 3) across the directions (V, 3): e1 the body axis
    ``models.ANCHOR`` with its part along the direction taken out."""
    anchor = np.asarray(models.ANCHOR) / np.linalg.norm(models.ANCHOR)
    e1 = anchor - (axis_to_camera @ anchor)[:, None] * axis_to_camera
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    return e1, np.cross(axis_to_camera, e1)


def _seen_from(to_camera, d: float, centre):
    """(distance (V,), unit direction (V, 3)) from a sphere's centre to each view's
    camera, the camera ``d`` metres from the body's origin along ``to_camera``."""
    w = d * to_camera - np.asarray(centre, np.float64)
    dist = np.linalg.norm(w, axis=1)
    return dist, w / dist[:, None]


def _surface_depth(q, dist, r: float):
    """Depth along a sphere's axis of its surface at lateral image distance q (metres at
    the depth ``dist`` of its centre), seen from ``dist`` away: t(q) above."""
    q = np.maximum(q, 0.0)
    a = 1.0 + (q / dist) ** 2
    return (dist - np.sqrt(np.maximum(dist * dist - a * (dist * dist - r * r), 0.0))) / a


def depth_offsets(config: dict, model: dict, q, z, dist):
    """(V, N, 30) depth offsets of points at lateral image distance q (V, N) from their
    sphere's axis and depth z (V, N) along it, the sphere's centre ``dist`` (V,) away:
    ``z - t(q - R_i)`` for R_i = (min(i, n - 1) + 1) stride, R_i scaled from the model's
    image at ``sphere_radius`` to the sphere's distance, n the offsets that
    ``max_radius_depth_offset`` holds."""
    r, d = float(config["body_radius"]), float(model["sphere_radius"])
    stride = float(model["stride_depth_offset"])
    n_values = int(float(model["max_radius_depth_offset"]) / stride + 1.0)
    i = np.minimum(np.arange(models.N_DEPTH_OFFSETS), n_values - 1)
    radius = (i + 1.0) * stride                                        # (30,)
    dist = np.asarray(dist, np.float64)[:, None, None]
    reach = radius * dist / d
    nearest = _surface_depth(q[..., None] - reach, dist, r)
    return np.maximum(z[..., None] - nearest, 0.0)


def offset_sphere_region_model(config: dict, centre) -> dict:
    """The region model of the sphere of radius ``body_radius`` centred at ``centre``
    (3,) in the body frame, under the names and shapes of ``models.sphere_region_model``
    (float32)."""
    model = config["region_model"]
    r, d = float(config["body_radius"]), float(model["sphere_radius"])
    n = int(model["n_points"])
    centre = np.asarray(centre, np.float64)
    to_camera = models.geodesic_directions(int(model["n_divides"]))    # (V, 3)
    v = to_camera.shape[0]
    dist, axis = _seen_from(to_camera, d, centre)
    e1, e2 = _frame(axis)
    phi = 2.0 * np.pi * np.mod(np.arange(n) * models.GOLDEN, 1.0)[None]
    radial = np.cos(phi)[..., None] * e1[:, None] + np.sin(phi)[..., None] * e2[:, None]
    rho = r * np.sqrt(1.0 - (r / dist) ** 2)                         # (V,)
    ring = centre + axis * (r * r / dist)[:, None]                   # (V, 3)
    centers = ring[:, None] + rho[:, None, None] * radial
    normals = radial - (radial @ to_camera[..., None]) * to_camera[:, None]
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    z_contour = d - (ring * to_camera).sum(-1)                     # depth of the circle
    q = np.repeat((dist * r / np.sqrt(dist * dist - r * r))[:, None], n, 1)
    z = np.repeat((dist - r * r / dist)[:, None], n, 1)
    return {
        "orientations": (-to_camera).astype(np.float32),
        "centers": centers.astype(np.float32),
        "normals": normals.astype(np.float32),
        "foreground_distances": np.repeat((2.0 * rho)[:, None], n, 1).astype(np.float32),
        "background_distances": np.full((v, n), np.finfo(np.float32).max, np.float32),
        "depth_offsets": depth_offsets(config, model, q, z, dist).astype(np.float32),
        "contour_lengths": (2.0 * np.pi * rho * d / z_contour).astype(np.float32),
    }


def hidden(camera, points, centre, radius: float):
    """(...) bool: whether the segment from ``camera`` (..., 3) to ``points`` (..., 3)
    enters the sphere of ``radius`` at ``centre`` (3,) before it ends."""
    seg = points - camera
    rel = camera - np.asarray(centre, np.float64)
    a = (seg * seg).sum(-1)
    b = 2.0 * (seg * rel).sum(-1)
    c = (rel * rel).sum(-1) - radius * radius
    disc = b * b - 4.0 * a * c
    root = np.sqrt(np.maximum(disc, 0.0))
    near = (-b - root) / (2.0 * a)
    far = (-b + root) / (2.0 * a)
    # The segment meets the ball where [near, far] overlaps (0, 1); a point on the
    # ball's own surface (a touching sphere) does not count as inside it.
    return (disc > 0.0) & (far > 1e-9) & (near < 1.0 - 1e-9) & (far - near > 1e-9)


def union_depth_model(config: dict, centres) -> dict:
    """The depth model of the union of spheres of radius ``body_radius`` centred at
    ``centres`` (K, 3) in the body frame, under the names and shapes of
    ``sphere_depth.sphere_depth_model`` (float32)."""
    model = config["depth_model"]
    r, d = float(config["body_radius"]), float(model["sphere_radius"])
    n = int(model["n_points"])
    centres = np.asarray(centres, np.float64)
    k = centres.shape[0]
    if n % k:
        raise ValueError(f"n_points {n} does not split among {k} spheres")
    m = n // k
    to_camera = models.geodesic_directions(int(model["n_divides"]))    # (V, 3)
    v = to_camera.shape[0]
    camera = d * to_camera
    i = np.arange(m)
    phi = 2.0 * np.pi * np.mod(i * models.GOLDEN, 1.0)[None]
    points = np.empty((v, m, k, 3))
    normals = np.empty((v, m, k, 3))
    offsets = np.empty((v, m, k, models.N_DEPTH_OFFSETS))
    for s, centre in enumerate(centres):
        dist, axis = _seen_from(to_camera, d, centre)
        e1, e2 = _frame(axis)
        rho = r * np.sqrt(1.0 - (r / dist) ** 2)
        planar = rho[:, None, None] * np.sqrt((i + 0.5) / m)[None, :, None]  # (V, M, 1)
        radial = np.cos(phi)[..., None] * e1[:, None] + np.sin(phi)[..., None] * e2[:, None]
        height = np.sqrt(r * r - planar ** 2)
        points[:, :, s] = centre + planar * radial + height * axis[:, None]
        normals[:, :, s] = (points[:, :, s] - centre) / r
        z = dist[:, None, None] - height                               # along the axis
        offsets[:, :, s] = depth_offsets(config, model, (planar * dist[:, None, None]
                                                         / z)[..., 0], z[..., 0], dist)
    points, normals = points.reshape(v, n, 3), normals.reshape(v, n, 3)
    offsets = offsets.reshape(v, n, -1)
    owner = np.tile(np.arange(k), m)                                   # (N,)
    seen = np.ones((v, n), bool)
    for s, centre in enumerate(centres):
        other = owner != s
        seen[:, other] &= ~hidden(camera[:, None], points[:, other], centre, r)
    # Row j of a hidden point takes the next visible row's point, cyclically: the least
    # visible row index at or after j over the rows taken twice.
    rows = np.arange(2 * n)
    visible = np.where(np.concatenate([seen, seen], 1), rows, 2 * n)
    following = np.minimum.accumulate(visible[:, ::-1], axis=1)[:, ::-1][:, :n] % n
    pick = np.where(seen, rows[:n], following)
    take = np.take_along_axis
    points = take(points, pick[..., None], 1)
    normals = take(normals, pick[..., None], 1)
    offsets = take(offsets, pick[..., None], 1)
    return {
        "orientations": (-to_camera).astype(np.float32),
        "centers": points.astype(np.float32),
        "normals": normals.astype(np.float32),
        "depth_offsets": offsets.astype(np.float32),
    }
