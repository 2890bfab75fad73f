"""The depth model of a sphere body, made by the benchmark from the configuration.

M3T's depth model (depth_model.cpp) holds, for every view of a geodesic sphere of
``n_divides`` subdivisions around the body, ``n_points`` points of the surface that a
camera ``sphere_radius`` metres away sees: each point's 3D position and its surface
normal in the body frame, sampled from the view's rendered depth image.  For a sphere
of radius r seen from distance D the visible surface is the cap ``x . o >= r^2 / D`` (o
the unit vector to the camera), whose rim projects onto the silhouette circle of radius
``rho = r sqrt(1 - r^2 / D^2)``, and every normal is radial.  So the benchmark writes
the points down instead of rendering the mesh: spread evenly over the cap as the
view's image sees it (point i at the planar radius ``rho sqrt((i + 1/2) / n)``), lifted
onto the sphere, at golden-angle steps around the view from the same body axis as the
region model's points (``harness/models.py``), so that neighbouring views hold nearly
the same points and a switch between them moves each point by a fraction of a pixel.
M3T draws the points at random, so that two neighbouring views hold unrelated samples
(the reason to fix them is in ``harness/models.py``'s docstring).

Both the program and the plain reference receive these arrays; neither derives them.
"""

from __future__ import annotations

import numpy as np

from benchmark.harness import models


def sphere_depth_model(config: dict) -> dict:
    """The depth model of the configuration's sphere, as numpy float32 arrays under the
    names of M3T's model file: ``orientations`` (V, 3), the unit vector from a view's
    camera towards the body; ``centers`` and ``normals`` (V, N, 3), body frame;
    ``depth_offsets`` (V, N, 30), zero (a convex body occludes nothing of itself)."""
    model = config["depth_model"]
    r, d = float(config["body_radius"]), float(model["sphere_radius"])
    n = int(model["n_points"])
    to_camera = models.geodesic_directions(int(model["n_divides"]))   # (V, 3)
    v = to_camera.shape[0]
    axis = np.asarray(models.ANCHOR) / np.linalg.norm(models.ANCHOR)
    e1 = axis - (to_camera @ axis)[:, None] * to_camera
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 = np.cross(to_camera, e1)
    i = np.arange(n)
    phi = 2.0 * np.pi * np.mod(i * models.GOLDEN, 1.0)[None]
    rho = r * np.sqrt(1.0 - (r / d) ** 2)
    planar = (rho * np.sqrt((i + 0.5) / n))[None, :, None]            # (1, N, 1)
    radial = np.cos(phi)[..., None] * e1[:, None] + np.sin(phi)[..., None] * e2[:, None]
    height = np.sqrt(r * r - planar ** 2)
    centers = planar * radial + height * to_camera[:, None]
    return {
        "orientations": (-to_camera).astype(np.float32),
        "centers": centers.astype(np.float32),
        "normals": (centers / r).astype(np.float32),
        "depth_offsets": np.zeros((v, n, models.N_DEPTH_OFFSETS), np.float32),
    }
