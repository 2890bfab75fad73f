"""Minimal Wavefront OBJ loader (a copy of m3t_tpu/utils/obj_loader.py, which replaces
third_party/tiny_obj_loader in the reference).

Supports v / f records with polygon fan-triangulation (the reference requests triangulated
output from tiny_obj_loader, m3t/src/body.cpp:186-193).  Vertex indices may be negative
(relative) and may carry /vt/vn suffixes, which are ignored.
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Return (vertices[N, 3] float32, triangles[T, 3] int32)."""
    vertices: list[list[float]] = []
    triangles: list[tuple[int, int, int]] = []

    def resolve(token: str) -> int:
        idx = int(token.split("/")[0])
        return idx - 1 if idx > 0 else len(vertices) + idx

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                ids = [resolve(tok) for tok in line.split()[1:]]
                for i in range(1, len(ids) - 1):
                    triangles.append((ids[0], ids[i], ids[i + 1]))

    if not vertices:
        raise ValueError(f"No vertices found in {path}")
    return (
        np.asarray(vertices, np.float32),
        np.asarray(triangles, np.int32).reshape(-1, 3),
    )


def save_obj(path: str, vertices: np.ndarray, triangles: np.ndarray) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for v in np.asarray(vertices, np.float32):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(triangles, np.int64):
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
