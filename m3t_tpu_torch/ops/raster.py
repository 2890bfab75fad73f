"""Triangle rasterization for the port (m3t_tpu/ops/raster.py without JAX).

Three parts:
  * :func:`triangle_coefficients` and :func:`rasterize`, batched over B independent
    scenes: every triangle's three edge functions and its interpolated inverse depth
    are linear in pixel coordinates (u, v), so coverage and depth at a pixel are
    ``(a*u + b*v) + c`` per plane.  The scene-occlusion queries
    (ops/occlusion.py) evaluate the same planes at single pixels; :func:`rasterize`
    evaluates them over an (H, W) image (the image mode), graphed as the JAX package
    jits it (graphs.py; ``triangle_coefficients``, whose focused intrinsics change every
    frame, stays outside the graph).  :func:`rasterize_windows` evaluates each chunk of
    triangles only over the pixels it can cover (:func:`chunk_windows`, one host read),
    eagerly: the renderers' form.
  * :func:`rasterize_np`, the host-side z-buffer of the JAX module's ``rasterize_np``,
    which renders the model views and the synthetic frames: the C++ rasterizer of
    ``native/``, or its numpy version on request.
  * :func:`decimate_mesh`, a numpy copy of the JAX module's vertex clustering.

Conventions: pixel (iu, iv) samples the projected point (u, v) = (iu, iv); camera frame
x right, y down, z forward, u = x*fu/z + ppu; background depth = +inf; silhouette id 0 =
background.  Every expression keeps the JAX source's operation order with one rounding
per operation.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from m3t_tpu_torch import graphs, native
from m3t_tpu_torch.ops.depth_fn import rdiv


class TriangleSoup(NamedTuple):
    """Triangle batch of B scenes for one render setup.

    coeffs: (B, T, 12) float32 — 3 edge functions (a, b, c each) premultiplied by
            sign(area), then the inverse-depth plane (az, bz, cz); all evaluated as
            ``(a*u + b*v) + c``.
    valid:  (B, T) bool
    ids:    (B, T) int32 — silhouette id per triangle
    bbox:   (B, T, 4) float32 — projected [u_min, u_max, v_min, v_max] per triangle
            (garbage for invalid triangles)
    normals:(B, T, 3) float32 — camera-frame unit normals (for normal rendering)
    """

    coeffs: torch.Tensor
    valid: torch.Tensor
    ids: torch.Tensor
    bbox: torch.Tensor
    normals: torch.Tensor


def _per_scene(x, like: torch.Tensor):
    """A Python number, or a (B,) tensor shaped to broadcast against (B, T, 3)."""
    if isinstance(x, torch.Tensor):
        return x.to(like.dtype).reshape(-1, 1, 1)
    return x


def triangle_coefficients(tri_verts_cam, ids, fu, fv, ppu, ppv, cull_backfaces=False,
                          z_min: float = 1e-3) -> TriangleSoup:
    """Per-triangle linear coefficients from camera-frame triangle vertices
    (m3t_tpu/ops/raster.py:48-115).

    tri_verts_cam: (B, T, 3, 3); ids: (B, T); fu, fv, ppu, ppv: Python numbers or (B,)
    tensors; cull_backfaces: a bool or a (B, T) bool tensor.
    """
    v = tri_verts_cam.to(torch.float32)
    z = v[..., 2]                                                     # (B, T, 3)
    fu, fv, ppu, ppv = (_per_scene(x, z) for x in (fu, fv, ppu, ppv))
    in_front = torch.all(z > z_min, dim=-1)
    z_safe = torch.where(z > z_min, z, torch.ones_like(z))
    u = v[..., 0] * fu / z_safe + ppu
    vv = v[..., 1] * fv / z_safe + ppv
    inv_z = rdiv(1.0, z_safe)

    def edge(pu, pv, qu, qv):
        a = -(qv - pv)
        b = qu - pu
        c = (qv - pv) * pu - (qu - pu) * pv
        return a, b, c

    # Edge k runs from vertex k to vertex k+1.
    a0, b0, c0 = edge(u[..., 0], vv[..., 0], u[..., 1], vv[..., 1])
    a1, b1, c1 = edge(u[..., 1], vv[..., 1], u[..., 2], vv[..., 2])
    a2, b2, c2 = edge(u[..., 2], vv[..., 2], u[..., 0], vv[..., 0])

    # Signed area = edge 0 evaluated at vertex 2.
    area = a0 * u[..., 2] + b0 * vv[..., 2] + c0
    front_facing = area < 0.0  # y-down image coords: CCW-outward meshes project clockwise
    cull = torch.as_tensor(cull_backfaces, dtype=torch.bool, device=v.device)
    big_enough = torch.abs(area) > 1e-12
    valid = in_front & big_enough & (front_facing | ~cull)

    ones = torch.ones_like(area)
    sign = torch.where(area >= 0.0, ones, -ones)
    safe_area = torch.where(big_enough, area, ones)

    # Inverse depth plane: iz(u,v) = (e1*iz0 + e2*iz1 + e0*iz2) / area.
    iz0, iz1, iz2 = inv_z[..., 0], inv_z[..., 1], inv_z[..., 2]
    az = (a1 * iz0 + a2 * iz1 + a0 * iz2) / safe_area
    bz = (b1 * iz0 + b2 * iz1 + b0 * iz2) / safe_area
    cz = (c1 * iz0 + c2 * iz1 + c0 * iz2) / safe_area

    coeffs = torch.stack([a0 * sign, b0 * sign, c0 * sign,
                          a1 * sign, b1 * sign, c1 * sign,
                          a2 * sign, b2 * sign, c2 * sign,
                          az, bz, cz], dim=-1)
    bbox = torch.stack([u.amin(dim=-1), u.amax(dim=-1),
                        vv.amin(dim=-1), vv.amax(dim=-1)], dim=-1)
    n = torch.linalg.cross(v[..., 1, :] - v[..., 0, :], v[..., 2, :] - v[..., 0, :])
    n = n / torch.clamp(torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)), min=1e-12)
    return TriangleSoup(coeffs, valid, ids.to(torch.int32), bbox, n)


# A chunk's window: the boxes of its valid triangles widened by this many pixels.
WINDOW_MARGIN = 2
# |area| / (longest edge)^2 below which a triangle is a sliver (smallest angle under
# about 2e-3 rad): a chunk holding one is evaluated over the whole image.
SLIVER_RATIO = 1e-3


def chunk_windows(soup: TriangleSoup, width: int, height: int, chunk: int) -> list:
    """Per chunk of ``chunk`` triangles, the pixel rectangle (u0, u1, v0, v1), ends
    excluded, outside which none of its valid triangles covers a pixel in any scene, or
    None when none of them reaches the image.

    The rectangle is the union of the triangles' boxes widened by WINDOW_MARGIN pixels.
    At a pixel that far outside a triangle's box, the exact edge function of the edge
    that separates it is at least about margin * sin(smallest angle) * edge length,
    while the float32 rounding of ``(a*u + b*v) + c`` stays below 1e-6 of the terms, so
    the coverage test there is false as evaluated; a chunk with a sliver (SLIVER_RATIO)
    takes the whole image.  One host read for all chunks."""
    b, n_tri, _ = soup.coeffs.shape
    n_chunks = -(-n_tri // chunk)
    pad = n_chunks * chunk - n_tri
    coeffs = soup.coeffs
    # Edge k's vector is (b_k, -a_k) up to sign: |area| = |a0 b1 - a1 b0|.
    area = torch.abs(coeffs[..., 0] * coeffs[..., 4] - coeffs[..., 3] * coeffs[..., 1])
    longest = torch.stack([coeffs[..., 3 * k] ** 2 + coeffs[..., 3 * k + 1] ** 2
                           for k in range(3)], dim=-1).amax(dim=-1)
    sliver = soup.valid & ~(area > SLIVER_RATIO * longest)
    inf = torch.full_like(soup.bbox[..., :2], float("inf"))
    lo = torch.where(soup.valid[..., None], soup.bbox[..., [0, 2]], inf)
    hi = torch.where(soup.valid[..., None], soup.bbox[..., [1, 3]], -inf)
    lo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=-float("inf"))
    sliver = torch.nn.functional.pad(sliver, (0, pad))
    lo = lo.reshape(b, n_chunks, chunk, 2).amin(dim=(0, 2))
    hi = hi.reshape(b, n_chunks, chunk, 2).amax(dim=(0, 2))
    sliver = sliver.reshape(b, n_chunks, chunk).any(dim=2).any(dim=0)
    windows = []
    for (u_lo, v_lo), (u_hi, v_hi), thin in zip(lo.tolist(), hi.tolist(),
                                                 sliver.tolist()):
        if thin:
            windows.append((0, width, 0, height))
            continue
        if not (u_lo <= u_hi and v_lo <= v_hi):          # no valid triangle (or NaN)
            windows.append(None)
            continue
        u0 = max(0, math.floor(u_lo) - WINDOW_MARGIN)
        u1 = min(width, math.ceil(u_hi) + WINDOW_MARGIN + 1)
        v0 = max(0, math.floor(v_lo) - WINDOW_MARGIN)
        v1 = min(height, math.ceil(v_hi) + WINDOW_MARGIN + 1)
        windows.append((u0, u1, v0, v1) if u0 < u1 and v0 < v1 else None)
    return windows


@graphs.graphed(static_argnames=("width", "height", "chunk", "with_normals"))
def rasterize(soup: TriangleSoup, width: int, height: int, chunk: int = 64,
              with_normals: bool = False):
    """Z-buffer rasterization of B scenes (m3t_tpu/ops/raster.py:118-188).

    Returns (depth (B, H, W) f32 meters, +inf background; id_image (B, H, W) int32, 0
    background[; normal_image (B, H, W, 3) f32, 0 background]).  Triangles go in chunks
    of ``chunk``: within a chunk the first index of the closest triangle wins (argmin),
    across chunks only a strictly closer triangle replaces the one stored; the id and
    the normal follow the same triangle, so that the image is the earliest of the
    closest triangles at every pixel, whatever the chunk size.  Every chunk is evaluated
    over the whole image, with no host read."""
    n_chunks = -(-soup.coeffs.shape[1] // chunk)
    return _rasterize_chunks(soup, width, height, chunk, with_normals,
                             [(0, width, 0, height)] * n_chunks)


def rasterize_windows(soup: TriangleSoup, width: int, height: int, windows: list,
                      chunk: int = 64, with_normals: bool = False):
    """:func:`rasterize` with each chunk evaluated over its window only (``windows``:
    :func:`chunk_windows` of the same soup, image and chunk), eagerly: elsewhere the
    chunk covers no pixel, so the images are the same."""
    return _rasterize_chunks(soup, width, height, chunk, with_normals, windows)


def _rasterize_chunks(soup: TriangleSoup, width: int, height: int, chunk: int,
                      with_normals: bool, windows: list):
    b = soup.coeffs.shape[0]
    dev = soup.coeffs.device
    depth = torch.full((b, height, width), float("inf"), device=dev)
    id_img = torch.zeros((b, height, width), dtype=torch.int32, device=dev)
    normal_img = (torch.zeros((b, height, width, 3), device=dev) if with_normals
                  else None)
    for index, window in enumerate(windows):
        if window is None:
            continue
        u0, u1, v0, v1 = window
        start = index * chunk
        iv, iu = torch.meshgrid(torch.arange(v0, v1, dtype=torch.float32, device=dev),
                                torch.arange(u0, u1, dtype=torch.float32, device=dev),
                                indexing="ij")
        uu = iu.reshape(1, 1, -1)
        vv = iv.reshape(1, 1, -1)
        c = soup.coeffs[:, start:start + chunk, :, None]              # (B, t, 12, 1)
        planes = [c[:, :, 3 * k] * uu + c[:, :, 3 * k + 1] * vv + c[:, :, 3 * k + 2]
                  for k in range(4)]                                  # (B, t, hw) each
        inside = ((planes[0] >= 0.0) & (planes[1] >= 0.0) & (planes[2] >= 0.0)
                  & soup.valid[:, start:start + chunk, None])
        inv_z = planes[3]
        z = torch.where(inside & (inv_z > 1e-12),
                        rdiv(1.0, torch.clamp(inv_z, min=1e-12)),
                        torch.full_like(inv_z, float("inf")))
        best = torch.argmin(z, dim=1, keepdim=True)                   # first minimum
        best_z = torch.gather(z, 1, best)[:, 0]
        shape = (b, v1 - v0, u1 - u0)
        stored = depth[:, v0:v1, u0:u1]
        closer = best_z.reshape(shape) < stored
        depth[:, v0:v1, u0:u1] = torch.where(closer, best_z.reshape(shape), stored)
        chunk_ids = torch.gather(soup.ids[:, start:start + chunk], 1, best[:, 0])
        id_img[:, v0:v1, u0:u1] = torch.where(closer, chunk_ids.reshape(shape),
                                              id_img[:, v0:v1, u0:u1])
        if with_normals:
            chunk_normals = torch.gather(soup.normals[:, start:start + chunk], 1,
                                         best[:, 0, :, None].expand(-1, -1, 3))
            normal_img[:, v0:v1, u0:u1] = torch.where(
                closer[..., None], chunk_normals.reshape(shape + (3,)),
                normal_img[:, v0:v1, u0:u1])
    if with_normals:
        return depth, id_img, normal_img
    return depth, id_img


# --------------------------------------------------------------------------------------
# Host-side rasterizer (model generation and synthetic frames)
# --------------------------------------------------------------------------------------


def rasterize_np(
    tri_verts_cam: np.ndarray,
    ids: np.ndarray,
    fu: float,
    fv: float,
    ppu: float,
    ppv: float,
    width: int,
    height: int,
    cull_backfaces=False,
    z_min: float = 1e-3,
    with_normals: bool = False,
    use_native: bool = True,
):
    """Scanline/bbox z-buffer rasterizer on the host (m3t_tpu/ops/raster.py:196-280).

    tri_verts_cam: (T, 3, 3) camera-frame triangle vertices; ids: (T,).  Returns
    (depth (H, W) f32, id_image (H, W) int32[, normal_image (H, W, 3) f32]).
    Runs the C++ rasterizer (``native/rasterizer.cpp``, which projects in float32
    before it divides in double), as the JAX package does for its models; a failed
    build raises.  ``use_native=False`` runs the numpy version, float64 throughout: the
    two need not agree to the last pixel.
    """
    if use_native:
        return _rasterize_native(tri_verts_cam, ids, fu, fv, ppu, ppv, width, height,
                                 cull_backfaces, z_min, with_normals)
    v = np.asarray(tri_verts_cam, np.float64)
    ids = np.asarray(ids)
    n_tri = v.shape[0]
    cull = np.broadcast_to(np.asarray(cull_backfaces, bool), (n_tri,))

    depth = np.full((height, width), np.inf, np.float32)
    id_img = np.zeros((height, width), np.int32)
    normal_img = np.zeros((height, width, 3), np.float32) if with_normals else None

    z = v[:, :, 2]
    ok = np.all(z > z_min, axis=1)
    u = np.where(ok[:, None], v[:, :, 0] * fu / np.where(z > z_min, z, 1.0) + ppu, 0.0)
    vv = np.where(ok[:, None], v[:, :, 1] * fv / np.where(z > z_min, z, 1.0) + ppv, 0.0)
    inv_z = 1.0 / np.where(z > z_min, z, 1.0)

    if with_normals:
        e01 = v[:, 1] - v[:, 0]
        e02 = v[:, 2] - v[:, 0]
        nrm = np.cross(e01, e02)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-12)

    for t in range(n_tri):
        if not ok[t]:
            continue
        u0, u1, u2 = u[t]
        v0, v1, v2 = vv[t]
        area = (u1 - u0) * (v2 - v0) - (v1 - v0) * (u2 - u0)
        if abs(area) < 1e-12:
            continue
        if cull[t] and area >= 0.0:  # front faces project clockwise (area < 0)
            continue
        umin = max(int(np.ceil(min(u0, u1, u2))), 0)
        umax = min(int(np.floor(max(u0, u1, u2))), width - 1)
        vmin = max(int(np.ceil(min(v0, v1, v2))), 0)
        vmax = min(int(np.floor(max(v0, v1, v2))), height - 1)
        if umin > umax or vmin > vmax:
            continue
        gu, gv = np.meshgrid(
            np.arange(umin, umax + 1, dtype=np.float64),
            np.arange(vmin, vmax + 1, dtype=np.float64),
        )
        w0 = (u2 - u1) * (gv - v1) - (v2 - v1) * (gu - u1)
        w1 = (u0 - u2) * (gv - v2) - (v0 - v2) * (gu - u2)
        w2 = (u1 - u0) * (gv - v0) - (v1 - v0) * (gu - u0)
        if area > 0:
            inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        else:
            inside = (w0 <= 0) & (w1 <= 0) & (w2 <= 0)
        if not inside.any():
            continue
        iz = (w0 * inv_z[t, 0] + w1 * inv_z[t, 1] + w2 * inv_z[t, 2]) / area
        zt = np.where(inside & (iz > 1e-12), 1.0 / np.maximum(iz, 1e-12), np.inf)
        sub = depth[vmin : vmax + 1, umin : umax + 1]
        closer = zt < sub
        sub[closer] = zt[closer].astype(np.float32)
        id_img[vmin : vmax + 1, umin : umax + 1][closer] = ids[t]
        if with_normals:
            normal_img[vmin : vmax + 1, umin : umax + 1][closer] = nrm[t]

    if with_normals:
        return depth, id_img, normal_img
    return depth, id_img


def _rasterize_native(tri_verts_cam, ids, fu, fv, ppu, ppv, width, height,
                      cull_backfaces, z_min, with_normals):
    """rasterize_np through the host library (m3t_tpu/ops/raster.py:287-316)."""
    tri = np.ascontiguousarray(tri_verts_cam, np.float32).reshape(-1, 9)
    n_tri = len(tri)
    ids_arr = np.ascontiguousarray(np.asarray(ids, np.int32))
    culls = np.ascontiguousarray(
        np.broadcast_to(np.asarray(cull_backfaces, bool), (n_tri,)).astype(np.uint8))
    depth = np.full((height, width), np.inf, np.float32)
    id_img = np.zeros((height, width), np.int32)
    normal_img = np.zeros((height, width, 3), np.float32) if with_normals else None
    native.library().rasterize_soup(
        tri.ctypes.data_as(ctypes.c_void_p), ids_arr.ctypes.data_as(ctypes.c_void_p),
        culls.ctypes.data_as(ctypes.c_void_p), n_tri,
        np.float32(fu), np.float32(fv), np.float32(ppu), np.float32(ppv),
        width, height, np.float32(z_min),
        depth.ctypes.data_as(ctypes.c_void_p), id_img.ctypes.data_as(ctypes.c_void_p),
        normal_img.ctypes.data_as(ctypes.c_void_p) if with_normals else None,
    )
    if with_normals:
        return depth, id_img, normal_img
    return depth, id_img


def decimate_mesh(vertices: np.ndarray, triangles: np.ndarray, target_triangles: int):
    """Vertex-clustering decimation for occlusion meshes (m3t_tpu/ops/raster.py:318-357,
    bit for bit).

    Modeled-occlusion checks only need coarse geometry (thresholds are centimetres,
    m3t/src/region_modality.cpp:1391-1431), so big meshes are clustered onto a uniform
    grid until the triangle count fits the budget.  Returns (vertices (N, 3) f32,
    triangles (T, 3) int32).
    """
    vertices = np.asarray(vertices, np.float32)
    triangles = np.asarray(triangles, np.int64)
    if len(triangles) <= target_triangles:
        return vertices, triangles.astype(np.int32)

    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    extent = float(np.max(hi - lo)) + 1e-9
    n_cells = 8
    while True:
        cell = extent / n_cells
        keys = np.floor((vertices - lo) / cell).astype(np.int64)
        flat = keys[:, 0] * 73856093 ^ keys[:, 1] * 19349663 ^ keys[:, 2] * 83492791
        uniq, remap = np.unique(flat, return_inverse=True)
        new_tri = remap[triangles]
        good = (
            (new_tri[:, 0] != new_tri[:, 1])
            & (new_tri[:, 1] != new_tri[:, 2])
            & (new_tri[:, 0] != new_tri[:, 2])
        )
        new_tri = new_tri[good]
        if len(new_tri) > target_triangles and n_cells > 2:
            n_cells //= 2
            continue
        # average vertex position per cluster
        new_verts = np.zeros((len(uniq), 3), np.float64)
        counts = np.zeros(len(uniq), np.int64)
        np.add.at(new_verts, remap, vertices)
        np.add.at(counts, remap, 1)
        new_verts /= counts[:, None]
        return new_verts.astype(np.float32), new_tri.astype(np.int32)
