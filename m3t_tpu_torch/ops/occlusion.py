"""Per-iteration focused scene evaluation on PyTorch/CUDA (port of m3t_tpu/ops/occlusion.py).

The reference re-renders the scene around every tracked body each correspondence
iteration to feed the modeled-occlusion and region/silhouette checks
(m3t/src/tracker.cpp:448-451 ``StartRendering``, region_modality.cpp:397-409).  Here, as
in the JAX package, a batch of B independent scenes is evaluated on the device in one
of two modes:

  * query mode (the pipeline's default): :func:`focused_scene_coeffs` computes each
    scene's focused-crop parameters and per-triangle plane coefficients, and
    :func:`query_eval` evaluates the closest triangle at exactly the pixels the checks
    sample.  The coefficients (:func:`scene_coeffs`) and the queries are hand-written
    Hopper kernels (``csrc/occlusion_kernels.cu``) for CUDA tensors and their plain
    PyTorch twins (:func:`scene_coeffs_plain`, :func:`query_eval_plain`) for CPU
    tensors, with no fallback from one to the other;
  * image mode: :func:`focused_render` rasterizes (B, S, S) depth and silhouette crops
    with ops/raster.rasterize.

Body and region silhouette ids are packed into one id (``body_id << 8 | region_id``),
so one evaluation serves the region modality's region checking (``id & 255``) and the
depth modality's body-id silhouette check (``id >> 8``).  Where JAX vmaps over scenes,
the scene batch is a leading dimension.  Host inputs are :class:`SceneBody` records
(a mesh in its body frame and its ids), which take the place of the JAX ``Body``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.ops import _cuda, raster
from m3t_tpu_torch.ops._cuda import require as _require
from m3t_tpu_torch.ops.depth_fn import rdiv
from m3t_tpu_torch.utils import timing

KIMAGE_SIZE_SAFETY_MARGIN = 1.05  # renderer.cpp:352


class SceneBody(NamedTuple):
    """A body of a scene on the host: its mesh in the body frame and its ids.  A
    :class:`m3t_tpu_torch.body.Body` has the same attributes and stands in for one."""

    vertices: np.ndarray  # (N, 3) float32, body frame
    triangles: np.ndarray  # (T, 3) int vertex indices, CCW seen from outside
    body_id: int
    region_id: int
    geometry_enable_culling: bool = True

    @property
    def maximum_body_diameter(self) -> float:
        """Twice the largest vertex distance from the body origin (body.cpp:244-250)."""
        v = np.asarray(self.vertices, np.float32)
        return float(2.0 * np.linalg.norm(v, axis=1).max(initial=0.0))


class SceneGeometry(NamedTuple):
    """Static occlusion geometry of B independent scenes (device-resident).

    Triangle vertices are in each owning body's frame; ``owner`` indexes the per-scene
    pose array handed to :func:`focused_scene_coeffs` / :func:`focused_render`, so
    moving bodies (the tracked body included) are re-posed at every evaluation.
    Padding triangles carry ``tri_valid == False``.
    """

    triangles: torch.Tensor  # (B, T, 3, 3) f32 body-frame vertices
    owner: torch.Tensor      # (B, T) int32 index into the scene poses
    sil_id: torch.Tensor     # (B, T) int32 combined id: body_id << 8 | region_id
    tri_valid: torch.Tensor  # (B, T) bool
    cull: torch.Tensor       # (B, T) bool backface culling per triangle
    ref_owner: torch.Tensor  # (B, NR) int32 referenced bodies (crop computation)
    ref_radius: torch.Tensor  # (B, NR) f32 bounding-sphere radii
    ref_valid: torch.Tensor  # (B, NR) bool
    body_id: torch.Tensor    # (B,) int32 tracked body's body id
    region_id: torch.Tensor  # (B,) int32 tracked body's region id

    @staticmethod
    def from_numpy(arrays, device="cuda") -> "SceneGeometry":
        """From a mapping of field name -> numpy array (the JAX package's
        SceneGeometry as numpy)."""
        dev = resolve_device(device)
        dtypes = dict(triangles=torch.float32, ref_radius=torch.float32,
                      tri_valid=torch.bool, cull=torch.bool, ref_valid=torch.bool)
        return SceneGeometry(*(
            torch.as_tensor(np.ascontiguousarray(arrays[name]),
                            dtype=dtypes.get(name, torch.int32), device=dev)
            for name in SceneGeometry._fields))

    def expand(self, n_scenes: int) -> "SceneGeometry":
        """The single scene of a batch of one, broadcast (as a view) to n_scenes."""
        return SceneGeometry(*(a.expand((n_scenes,) + a.shape[1:]) for a in self))


class SceneCoeffs(NamedTuple):
    """Per-scene focused triangle coefficients for the point queries.

    The validity checks read about 50 pixels per correspondence line (a 6x6 depth
    neighbourhood, region_modality.cpp:1391-1431, and 2x6 silhouette strides,
    cpp:1293-1341), so instead of (S, S) images this carries the plane coefficients
    the rasterizer uses, in focused-crop pixel space, for :func:`query_eval`.
    """

    coeffs: torch.Tensor       # (B, T, 12) f32 edge + inverse-depth planes
    tri_valid: torch.Tensor    # (B, T) bool, valid triangles first
    sil_id: torch.Tensor       # (B, T) int32 combined id
    bbox: torch.Tensor         # (B, T, 4) f32 focused-space [u0, u1, v0, v1]
    corner_u: torch.Tensor     # (B,)
    corner_v: torch.Tensor     # (B,)
    scale: torch.Tensor        # (B,)
    body_visible: torch.Tensor  # (B,) bool


class FocusedRender(NamedTuple):
    """Focused depth + silhouette crops for every scene in the batch (image mode)."""

    depth: torch.Tensor        # (B, S, S) f32 meters, +inf background
    body_sil: torch.Tensor     # (B, S, S) int32 body ids
    region_sil: torch.Tensor   # (B, S, S) int32 region ids
    corner_u: torch.Tensor     # (B,)
    corner_v: torch.Tensor     # (B,)
    scale: torch.Tensor        # (B,)
    body_visible: torch.Tensor  # (B,) bool (any referenced body visible)


# ----------------------------------------------------------------------------------------
# Scene construction on the host
# ----------------------------------------------------------------------------------------


def build_scene_geometry(scenes: Sequence[Sequence[SceneBody]], referenced=None,
                         max_triangles: int | None = None,
                         decimate_to: int | None = None, tracked=None,
                         device="cuda") -> SceneGeometry:
    """Stack host scenes into a :class:`SceneGeometry` (m3t_tpu/ops/occlusion.py:75-151).

    scenes: list (length B) of lists of :class:`SceneBody`; the tracked body (whose pose
    slot is filled from the tracking state each cycle and whose ids feed the silhouette
    checks) is index 0 by default, or ``tracked[i]`` when given.  ``referenced``
    optionally lists, per scene, the body indices used for the crop computation
    (default: all bodies).  ``decimate_to`` clusters each mesh to at most that many
    triangles (ops/raster.decimate_mesh).
    """
    b = len(scenes)
    tri_list, owner_list, id_list, cull_list = [], [], [], []
    for scene in scenes:
        tris, owners, ids, culls = [], [], [], []
        for o, body in enumerate(scene):
            v, t = body.vertices, body.triangles
            if decimate_to is not None:
                v, t = raster.decimate_mesh(v, t, decimate_to)
            tv = np.asarray(v)[np.asarray(t)]  # (t, 3, 3)
            tris.append(np.asarray(tv, np.float32))
            owners.append(np.full(len(tv), o, np.int32))
            ids.append(np.full(len(tv), (int(body.body_id) << 8) | int(body.region_id),
                               np.int32))
            culls.append(np.full(len(tv), bool(body.geometry_enable_culling), bool))
        tri_list.append(np.concatenate(tris))
        owner_list.append(np.concatenate(owners))
        id_list.append(np.concatenate(ids))
        cull_list.append(np.concatenate(culls))

    t_max = max(len(t) for t in tri_list)
    if max_triangles is not None:
        t_max = max(t_max, max_triangles)

    def pad(a):
        out = np.zeros((t_max,) + a.shape[1:], a.dtype)
        out[: len(a)] = a
        return out

    nr_max = max(len(referenced[i]) if referenced is not None else len(scenes[i])
                 for i in range(b))
    ref_owner = np.zeros((b, nr_max), np.int32)
    ref_radius = np.zeros((b, nr_max), np.float32)
    ref_valid = np.zeros((b, nr_max), bool)
    for i, scene in enumerate(scenes):
        refs = referenced[i] if referenced is not None else list(range(len(scene)))
        for j, o in enumerate(refs):
            ref_owner[i, j] = o
            ref_radius[i, j] = 0.5 * scene[o].maximum_body_diameter
            ref_valid[i, j] = True

    if tracked is None:
        tracked = [0] * b
    return SceneGeometry.from_numpy(dict(
        triangles=np.stack([pad(t) for t in tri_list]),
        owner=np.stack([pad(o) for o in owner_list]),
        sil_id=np.stack([pad(i) for i in id_list]),
        tri_valid=np.stack([np.arange(t_max) < len(t) for t in tri_list]),
        cull=np.stack([pad(c) for c in cull_list]),
        ref_owner=ref_owner, ref_radius=ref_radius, ref_valid=ref_valid,
        body_id=np.asarray([int(s[tracked[i]].body_id) for i, s in enumerate(scenes)],
                           np.int32),
        region_id=np.asarray([int(s[tracked[i]].region_id)
                              for i, s in enumerate(scenes)], np.int32)), device)


def build_kinematic_scene_geometry(structures, extras=None, referenced=None,
                                   max_triangles: int | None = None,
                                   decimate_to: int | None = None,
                                   device="cuda") -> SceneGeometry:
    """Per-link scenes of kinematic structures (m3t_tpu/ops/occlusion.py:154-174).

    structures: list (length S) of lists of NL link :class:`SceneBody`s.  Builds S*NL
    scenes — scene s*NL + l tracks link l — whose pose slots 0..NL-1 are the
    structure's links (so the links occlude each other) and slots NL.. are the shared
    ``extras`` occluders.
    """
    extras = list(extras or [])
    scenes, tracked = [], []
    for links in structures:
        for link in range(len(links)):
            scenes.append(list(links) + extras)
            tracked.append(link)
    return build_scene_geometry(scenes, referenced=referenced,
                                max_triangles=max_triangles, decimate_to=decimate_to,
                                tracked=tracked, device=device)


# ----------------------------------------------------------------------------------------
# Focused crop and triangle coefficients (batched over scenes)
# ----------------------------------------------------------------------------------------


def _crop_params(ref_centers, ref_radius, ref_valid, fu: float, fv: float, ppu: float,
                 ppv: float, width: int, height: int, image_size: int, z_min: float,
                 z_max: float):
    """FocusedRenderer::CalculateProjection (renderer.cpp:348-406) for B scenes:
    ref_centers (B, NR, 3) -> (corner_u, corner_v, scale, visible), each (B,)."""
    x, y, z = ref_centers[..., 0], ref_centers[..., 1], ref_centers[..., 2]
    r = ref_radius
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    cond = (z >= r * 1.5) & (z - r >= z_min) & (z + r <= z_max) & ref_valid
    z2_r2 = torch.clamp(z_safe * z_safe - r * r, min=1e-12)
    z3_zr2 = z2_r2 * z_safe
    r_u = fu * (torch.abs(x) * r * r + r * z_safe * torch.sqrt(z2_r2 + x * x)) / z3_zr2
    r_v = fv * (torch.abs(y) * r * r + r * z_safe * torch.sqrt(z2_r2 + y * y)) / z3_zr2
    cu = x * fu / z_safe + ppu
    cv = y * fv / z_safe + ppv
    on_image = ~((cu - r_u > width) | (cu + r_u < 0)
                 | (cv - r_v > height) | (cv + r_v < 0))
    vis = cond & on_image
    big = torch.full_like(cu, 1e30)
    u_min = torch.where(vis, cu - r_u, big).amin(dim=-1)
    u_max = torch.where(vis, cu + r_u, -big).amax(dim=-1)
    v_min = torch.where(vis, cv - r_v, big).amin(dim=-1)
    v_max = torch.where(vis, cv + r_v, -big).amax(dim=-1)
    visible = vis.any(dim=-1)
    d = torch.maximum(u_max - u_min, v_max - v_min) * KIMAGE_SIZE_SAFETY_MARGIN
    d = torch.where(visible & (d > 0), d, torch.full_like(d, float(image_size)))
    zeros = torch.zeros_like(d)
    corner_u = torch.where(visible, 0.5 * (u_min + u_max - d), zeros)
    corner_v = torch.where(visible, 0.5 * (v_min + v_max - d), zeros)
    scale = torch.where(visible, rdiv(float(image_size), d), torch.ones_like(d))
    return corner_u, corner_v, scale, visible


def _focused_projection(geom: SceneGeometry, scene_poses, intr, width: int, height: int,
                        image_size: int, z_min: float, z_max: float):
    """Every scene's focused crop and the projection into it: (corner_u, corner_v,
    scale, visible, (fu * scale, fv * scale, (ppu - corner_u) * scale, (ppv - corner_v)
    * scale)), each (B,) (the shared prologue of both modes, occlusion.py:246-259)."""
    fu, fv, ppu, ppv = (float(x) for x in intr)
    scene = torch.arange(scene_poses.shape[0], device=scene_poses.device)[:, None]
    ref_centers = scene_poses[scene, geom.ref_owner.long()][..., :3, 3]  # (B, NR, 3)
    corner_u, corner_v, scale, visible = _crop_params(
        ref_centers, geom.ref_radius, geom.ref_valid, fu, fv, ppu, ppv,
        width, height, image_size, z_min, z_max)
    projection = (fu * scale, fv * scale, (ppu - corner_u) * scale,
                  (ppv - corner_v) * scale)
    return corner_u, corner_v, scale, visible, projection


def _posed_soup(triangles, owner, sil_id, tri_valid, cull, scene_poses, fu, fv, pu, pv,
                z_min: float) -> raster.TriangleSoup:
    """The triangles posed by their owners' poses and projected with the (B,) focused
    intrinsics, invalid where ``tri_valid`` is False.  Each camera-frame coordinate is
    ``((r0*x + r1*y) + r2*z) + t``, one rounding per operation, as the scene_coeffs
    kernel computes it."""
    scene = torch.arange(scene_poses.shape[0], device=scene_poses.device)[:, None]
    pose = scene_poses[scene, owner.long()]                             # (B, T, 4, 4)
    rot, shift = pose[..., None, :3, :3], pose[..., None, :3, 3]
    x, y, z = (triangles[..., k, None] for k in range(3))               # (B, T, 3, 1)
    v_cam = ((rot[..., 0] * x + rot[..., 1] * y) + rot[..., 2] * z) + shift  # (B, T, 3, 3)
    soup = raster.triangle_coefficients(v_cam, sil_id, fu, fv, pu, pv,
                                        cull_backfaces=cull, z_min=z_min)
    return soup._replace(valid=soup.valid & tri_valid)


def _focused_soup(geom: SceneGeometry, scene_poses, intr, width: int, height: int,
                  image_size: int, z_min: float, z_max: float):
    """Crop parameters and focused-space triangle soup of every scene (image mode)."""
    corner_u, corner_v, scale, visible, projection = _focused_projection(
        geom, scene_poses, intr, width, height, image_size, z_min, z_max)
    soup = _posed_soup(geom.triangles, geom.owner, geom.sil_id, geom.tri_valid, geom.cull,
                       scene_poses, *projection, z_min)
    return soup, corner_u, corner_v, scale, visible


# ----------------------------------------------------------------------------------------
# Kernel 6: the focused scenes' coefficients
# ----------------------------------------------------------------------------------------


def scene_coeffs_plain(triangles, owner, sil_id, tri_valid, cull, scene_poses, fu, fv,
                       pu, pv, z_min: float):
    """Plain PyTorch twin of the scene_coeffs kernel (same arithmetic, same order):
    :func:`_posed_soup`, then the triangles front-compacted by validity with a stable
    sort."""
    soup = _posed_soup(triangles, owner, sil_id, tri_valid, cull, scene_poses, fu, fv, pu,
                       pv, z_min)
    order = torch.argsort((~soup.valid).to(torch.int32), dim=-1, stable=True)

    def take(x):
        idx = order if x.dim() == 2 else order[..., None].expand(x.shape)
        return torch.gather(x, 1, idx)

    return take(soup.coeffs), take(soup.valid), take(soup.ids), take(soup.bbox)


def _scene_rows(x):
    """x with each scene's rows contiguous, and its scene stride in elements (0 for a
    batch expanded from one scene)."""
    if not x[0].is_contiguous():
        x = x.contiguous()
    return x, x.stride(0)


def _check_scene_inputs(triangles, owner, sil_id, tri_valid, cull, scene_poses,
                        projection):
    _require(triangles.dtype == torch.float32 and triangles.dim() == 4
             and tuple(triangles.shape[2:]) == (3, 3),
             "triangles must be (B, T, 3, 3) float32")
    b, t = triangles.shape[:2]
    for name, x, dtype in (("owner", owner, torch.int32), ("sil_id", sil_id, torch.int32),
                           ("tri_valid", tri_valid, torch.bool), ("cull", cull, torch.bool)):
        _require(x.dtype == dtype and tuple(x.shape) == (b, t),
                 f"{name} must be a (B, T) {dtype} tensor")
    _require(scene_poses.dtype == torch.float32 and scene_poses.dim() == 4
             and scene_poses.shape[0] == b and tuple(scene_poses.shape[2:]) == (4, 4),
             "scene_poses must be (B, NO, 4, 4) float32")
    _require(all(p.dtype == torch.float32 and tuple(p.shape) == (b,) for p in projection),
             "fu, fv, pu and pv must be (B,) float32 tensors")
    devices = {x.device for x in (triangles, owner, sil_id, tri_valid, cull, scene_poses,
                                  *projection)}
    _require(len(devices) == 1, f"inputs on different devices: {devices}")


def _block_width(n_tri: int) -> int:
    """Threads of the scene_coeffs kernel's block (one block a scene): 32, 64 or 128 for
    scenes of up to that many triangles, else 256."""
    return next((w for w in (32, 64, 128) if n_tri <= w), 256)


@_cuda.kernel("m3t_scene_coeffs", [_cuda.PTR] * 5 + [_cuda.INT64] * 5 + [_cuda.PTR] * 9
              + [_cuda.INT] * 3 + [_cuda.FLOAT, _cuda.INT])
def scene_coeffs(triangles, owner, sil_id, tri_valid, cull, scene_poses, fu, fv, pu, pv,
                 z_min: float):
    """Focused-space triangle coefficients of B scenes, valid triangles first.

    triangles (B, T, 3, 3) f32 in their owners' frames; owner, sil_id (B, T) int32 (each
    owner indexes the scene's poses); tri_valid, cull (B, T) bool; scene_poses (B, NO,
    4, 4) f32 body-to-camera; fu, fv, pu, pv (B,) f32, the focused crop's intrinsics.
    Returns (coeffs (B, T, 12) f32, tri_valid (B, T) bool, sil_id (B, T) int32, bbox
    (B, T, 4) f32): :func:`raster.triangle_coefficients`' planes and boxes of the posed
    triangles, invalid where culled, degenerate, not wholly in front of ``z_min`` or
    not listed, in a stable valid-first order (the query kernel's loop bound and its
    tie rule rest on it).  One hand-written kernel for CUDA tensors, equal to its plain
    twin bit for bit; the twin for CPU tensors.  Counts ``occlusion.scene_triangles``,
    B * T, with the tracer on (a capture takes the count into its graph)."""
    projection = (fu, fv, pu, pv)
    _check_scene_inputs(triangles, owner, sil_id, tri_valid, cull, scene_poses, projection)
    b, t = triangles.shape[:2]
    timing.count("occlusion.scene_triangles", b * t)
    if triangles.device.type == "cpu":
        return scene_coeffs_plain(triangles, owner, sil_id, tri_valid, cull, scene_poses,
                                  *projection, z_min)
    _require(triangles.device.type == "cuda", f"unsupported device {triangles.device}")
    dev = triangles.device
    coeffs = torch.empty((b, t, 12), dtype=torch.float32, device=dev)
    valid = torch.empty((b, t), dtype=torch.bool, device=dev)
    ids = torch.empty((b, t), dtype=torch.int32, device=dev)
    bbox = torch.empty((b, t, 4), dtype=torch.float32, device=dev)
    if b == 0 or t == 0:
        return coeffs, valid, ids, bbox
    rows = [_scene_rows(x) for x in (triangles, owner, sil_id, tri_valid, cull)]
    poses = scene_poses.contiguous()
    projection = [p.contiguous() for p in projection]
    _cuda.launch("m3t_scene_coeffs", dev, *(x.data_ptr() for x, _ in rows),
                 *(stride for _, stride in rows), poses.data_ptr(),
                 *(p.data_ptr() for p in projection), coeffs.data_ptr(), valid.data_ptr(),
                 ids.data_ptr(), bbox.data_ptr(), b, t, poses.shape[1], z_min,
                 _block_width(t))
    return coeffs, valid, ids, bbox


def _focused_scene_coeffs(evaluate, geom: SceneGeometry, scene_poses, intr, width: int,
                          height: int, image_size: int, z_min: float,
                          z_max: float) -> SceneCoeffs:
    corner_u, corner_v, scale, visible, projection = _focused_projection(
        geom, scene_poses, intr, width, height, image_size, z_min, z_max)
    coeffs, tri_valid, sil_id, bbox = evaluate(
        geom.triangles, geom.owner, geom.sil_id, geom.tri_valid, geom.cull, scene_poses,
        *projection, z_min)
    return SceneCoeffs(coeffs=coeffs, tri_valid=tri_valid, sil_id=sil_id, bbox=bbox,
                       corner_u=corner_u, corner_v=corner_v, scale=scale,
                       body_visible=visible)


def focused_scene_coeffs(geom: SceneGeometry, scene_poses, intr, width: int, height: int,
                         image_size: int = 200, z_min: float = 0.02,
                         z_max: float = 10.0) -> SceneCoeffs:
    """Crop parameters + focused-space triangle coefficients, no rasterization
    (m3t_tpu/ops/occlusion.py:232-269).

    scene_poses: (B, NO, 4, 4) body-to-camera poses per scene body.  The crops are
    computed here; the coefficients by :func:`scene_coeffs` (the kernel on CUDA
    tensors).  Triangles are front-compacted by validity in a stable order
    (backface-culled, degenerate and behind-camera triangles move to the tail, the
    others keep their order, which decides ties), so the query kernel's per-scene loop
    bound skips them.
    """
    return _focused_scene_coeffs(scene_coeffs, geom, scene_poses, intr, width, height,
                                 image_size, z_min, z_max)


def focused_scene_coeffs_plain(geom: SceneGeometry, scene_poses, intr, width: int,
                               height: int, image_size: int = 200, z_min: float = 0.02,
                               z_max: float = 10.0) -> SceneCoeffs:
    """:func:`focused_scene_coeffs` through the plain twin :func:`scene_coeffs_plain`
    on any device (the kernel's yardstick on the card)."""
    return _focused_scene_coeffs(scene_coeffs_plain, geom, scene_poses, intr, width,
                                 height, image_size, z_min, z_max)


# ----------------------------------------------------------------------------------------
# Kernel 4: point queries
# ----------------------------------------------------------------------------------------


def _check_query_inputs(coeffs, tri_valid, sil_id, u, v):
    _require(coeffs.dtype == torch.float32 and coeffs.dim() == 3
             and coeffs.shape[2] == 12, "coeffs must be (B, T, 12) float32")
    b, t = coeffs.shape[:2]
    _require(tri_valid.dtype == torch.bool and tuple(tri_valid.shape) == (b, t),
             "tri_valid must be a (B, T) bool tensor")
    _require(sil_id.dtype == torch.int32 and tuple(sil_id.shape) == (b, t),
             "sil_id must be a (B, T) int32 tensor")
    _require(u.shape == v.shape and u.dim() >= 1 and u.shape[0] == b,
             "u and v must share one shape (B, ...)")
    devices = {x.device for x in (coeffs, tri_valid, sil_id, u, v)}
    _require(len(devices) == 1, f"inputs on different devices: {devices}")


def leading_valid_count(tri_valid):
    """(B,) int32 loop bound per scene: index of the last valid triangle + 1, or 0
    (occlusion.py:341-345).  Equals the valid count for front-compacted triangles and
    over-estimates safely for other masks, since invalid triangles count as zeros.  The
    plain twin loops to it; the kernel finds the same bound from tri_valid itself."""
    t = tri_valid.shape[-1]
    index = torch.arange(1, t + 1, dtype=torch.int32, device=tri_valid.device)
    return torch.where(tri_valid, index, torch.zeros_like(index)).amax(dim=-1)


def box_outside(coeffs, box):
    """The query_eval kernel's cull: True where no pixel of the box can be covered.

    coeffs (..., 12) triangle coefficients, box (..., 4) [u_lo, u_hi, v_lo, v_hi]
    broadcast against them.  Each edge plane is evaluated, with the kernel's rounding, at
    the box corner where it is largest (u_hi where its u factor is >= 0, else u_lo; v
    likewise); the box is out if one of the three is < 0.  Every operation of a plane
    is correctly rounded and so monotone in u and in v, so the plane is < 0 (or NaN) at
    every pixel of the box too: no margin is needed, and a NaN corner value keeps the
    triangle."""
    u_lo, u_hi, v_lo, v_hi = box.unbind(-1)
    out = torch.zeros(torch.broadcast_shapes(coeffs.shape[:-1], box.shape[:-1]),
                      dtype=torch.bool, device=coeffs.device)
    for k in range(3):
        a, b, c = coeffs[..., 3 * k], coeffs[..., 3 * k + 1], coeffs[..., 3 * k + 2]
        u = torch.where(a >= 0, u_hi, u_lo)
        v = torch.where(b >= 0, v_hi, v_lo)
        out |= ((a * u + b * v) + c) < 0
    return out


def query_eval_plain(coeffs, tri_valid, sil_id, u, v):
    """Plain PyTorch twin of the query_eval kernel (same arithmetic, same order).

    It walks the triangles with (B, Q) accumulators on the kernel's two chains and
    never materialises the (B, Q, T) product."""
    _check_query_inputs(coeffs, tri_valid, sil_id, u, v)
    b, n_tri, _ = coeffs.shape
    shape = u.shape
    uf = u.reshape(b, -1).to(torch.float32)
    vf = v.reshape(b, -1).to(torch.float32)
    cz = torch.where(tri_valid[..., None], coeffs, torch.zeros_like(coeffs))
    n = int(leading_valid_count(tri_valid).max()) if b and n_tri else 0
    zero_f = torch.zeros_like(uf)
    best = [zero_f, zero_f]
    best_id = [torch.zeros_like(uf, dtype=torch.int32)] * 2
    for t in range(n):
        c = cz[:, t, :, None]                                           # (B, 12, 1)
        e0, e1, e2, inv = ((c[:, 3 * k] * uf + c[:, 3 * k + 1] * vf) + c[:, 3 * k + 2]
                           for k in range(4))
        m = torch.minimum(torch.minimum(e0, e1), e2)
        s = torch.where((m >= 0.0) & (inv > 1e-12), inv, zero_f)
        chain = t % 2  # t % 4 in {0, 2} -> chain 0, {1, 3} -> chain 1
        sel = s > best[chain]
        best[chain] = torch.where(sel, s, best[chain])
        best_id[chain] = torch.where(sel, sil_id[:, t, None], best_id[chain])
    sel = best[1] > best[0]  # chain 0 wins ties
    return (torch.where(sel, best[1], best[0]).reshape(shape),
            torch.where(sel, best_id[1], best_id[0]).reshape(shape))


QUERY_ROW_COUNTERS = ("occlusion.query_rows_scanned", "occlusion.query_rows_kept")


@_cuda.kernel("m3t_query_eval", [_cuda.PTR] * 7 + [_cuda.INT] * 4 + [_cuda.PTR])
def query_eval(coeffs, tri_valid, sil_id, u, v):
    """Max inverse depth over covering triangles and the silhouette id of that triangle
    at focused pixels (u, v), for B scenes (m3t_tpu/ops/occlusion.py:322-357).

    coeffs (B, T, 12) f32, tri_valid (B, T) bool, sil_id (B, T) int32; u, v (B, ...)
    pixel coordinates of any type (read as float32; int32 pixels go to the kernel as
    they are).  Returns (inv (B, ...) f32, id (B, ...) int32), 0 and 0 where no triangle
    covers the pixel.  Ties: triangles run on two chains (even t, odd t), a triangle
    replaces a chain's best only if strictly greater, and chain 0 wins ties at the merge.
    The kernel culls with :func:`box_outside`'s test: where the scenes hold more than
    512 triangles each block first keeps, in order, the valid rows that can reach the box
    of its 1024 queries (smaller scenes are staged whole), and each warp then skips the
    rows ruled out for the boxes of its queries (two boxes of 16 consecutive queries); it
    gives the plain twin's result bit for bit (the twin has no cull).  In an eager call
    on the card with the tracer on it counts ``occlusion.query_rows_scanned`` (the blocks'
    loop bounds, summed) and ``occlusion.query_rows_kept`` (the rows their lists held) in
    a tally on the card that the tracer's report reads; a captured call, and so a graphed
    replay, counts nothing, and the CPU twin counts nothing.
    """
    if coeffs.device.type == "cpu":
        return query_eval_plain(coeffs, tri_valid, sil_id, u, v)
    _check_query_inputs(coeffs, tri_valid, sil_id, u, v)
    _require(coeffs.device.type == "cuda", f"unsupported device {coeffs.device}")
    b, n_tri, _ = coeffs.shape
    _require(b > 0 and n_tri > 0, "query_eval: need B > 0 and T > 0")
    shape = u.shape
    int_queries = u.dtype == torch.int32 and v.dtype == torch.int32
    qtype = torch.int32 if int_queries else torch.float32
    uq = u.reshape(b, -1).to(qtype).contiguous()
    vq = v.reshape(b, -1).to(qtype).contiguous()
    coeffs, tri_valid, sil_id = (x.contiguous() for x in (coeffs, tri_valid, sil_id))
    # The kernel reads a scene's rows from device memory as 16-byte words.
    _require(coeffs.data_ptr() % 16 == 0, "coeffs must be 16-byte aligned")
    inv = torch.empty(uq.shape, dtype=torch.float32, device=uq.device)
    ids = torch.empty(uq.shape, dtype=torch.int32, device=uq.device)
    if uq.shape[1] == 0:
        return inv.reshape(shape), ids.reshape(shape)
    tally = timing.device_tally(QUERY_ROW_COUNTERS, uq.device)
    _cuda.launch("m3t_query_eval", coeffs.device, coeffs.data_ptr(), tri_valid.data_ptr(),
                 sil_id.data_ptr(), uq.data_ptr(), vq.data_ptr(), inv.data_ptr(),
                 ids.data_ptr(), b, n_tri, uq.shape[1], int(int_queries),
                 None if tally is None else tally.data_ptr())
    return inv.reshape(shape), ids.reshape(shape)


def query_inv_depth(coeffs, tri_valid, u, v):
    """Max inverse depth over covering triangles at focused pixels; 0 = no hit.

    ``min z == 1 / max inv_z`` for positive depths, so callers that need a depth
    comparison or a min over samples reduce in inverse-depth space and divide once."""
    zeros = torch.zeros(tri_valid.shape, dtype=torch.int32, device=tri_valid.device)
    return query_eval(coeffs, tri_valid, zeros, u, v)[0]


def inv_to_depth(inv_best):
    """Convert a reduced max inverse depth to meters (+inf where no hit)."""
    return torch.where(inv_best > 0.0, rdiv(1.0, torch.clamp(inv_best, min=1e-12)),
                       torch.full_like(inv_best, float("inf")))


def query_depth(coeffs, tri_valid, u, v):
    """Depth at focused pixels (u, v): min over covering triangles, +inf if none."""
    return inv_to_depth(query_inv_depth(coeffs, tri_valid, u, v))


def query_id(coeffs, tri_valid, sil_id, u, v):
    """Combined silhouette id of the closest covering triangle; 0 = background."""
    return query_eval(coeffs, tri_valid, sil_id, u, v)[1]


def query_depth_id(coeffs, tri_valid, sil_id, u, v):
    """(depth, combined silhouette id) at focused pixels; id 0 = background.  One
    evaluation gives both: the inverse depth does not depend on the ids."""
    inv, ids = query_eval(coeffs, tri_valid, sil_id, u, v)
    return inv_to_depth(inv), ids


def window_pixels(uu, vv):
    """Pixel coordinates (..., K, K) of every (kv, ku) sample of a strided window given
    by its columns uu and rows vv (..., K)."""
    shape = uu.shape + uu.shape[-1:]
    return uu[..., None, :].expand(shape), vv[..., :, None].expand(shape)


def window_min_depth_from_inv(inv, sample_ok):
    """Min depth over the (..., K, K) window samples from their inverse depths:
    min z == 1 / max inv z, so the division comes after the reduction."""
    best = torch.where(sample_ok, inv, torch.zeros_like(inv)).flatten(-2).amax(dim=-1)
    return inv_to_depth(best)


def window_min_depth(scene, uu, vv, sample_ok):
    """Min scene depth over strided (B, N, K, K) windows of focused pixels, the
    modeled-occlusion test of both modalities.  ``scene`` carries either triangle
    coefficients (``coeffs``, ``tri_valid``: point queries) or rendered (B, S, S)
    ``focused_depth`` crops; both give the same depth."""
    if hasattr(scene, "coeffs"):
        inv = query_inv_depth(scene.coeffs, scene.tri_valid, *window_pixels(uu, vv))
        return window_min_depth_from_inv(inv, sample_ok)
    body = torch.arange(uu.shape[0], device=uu.device).reshape((-1,) + (1,) * 3)
    d = scene.focused_depth[body, vv[..., :, None].long(), uu[..., None, :].long()]
    return torch.where(sample_ok, d, torch.full_like(d, float("inf"))
                       ).flatten(-2).amin(dim=-1)


# ----------------------------------------------------------------------------------------
# Image mode
# ----------------------------------------------------------------------------------------


def focused_render(geom: SceneGeometry, scene_poses, intr, width: int, height: int,
                   image_size: int = 200, z_min: float = 0.02, z_max: float = 10.0,
                   chunk: int = 64) -> FocusedRender:
    """Render focused depth + silhouette crops for every scene in the batch
    (m3t_tpu/ops/occlusion.py:426-460).

    scene_poses: (B, NO, 4, 4) body-to-camera poses per scene body (slot 0 = the
    tracked body)."""
    soup, corner_u, corner_v, scale, visible = _focused_soup(
        geom, scene_poses, intr, width, height, image_size, z_min, z_max)
    depth, id_img = raster.rasterize(soup, image_size, image_size, chunk=chunk)
    shown = visible[:, None, None]
    depth = torch.where(shown, depth, torch.full_like(depth, float("inf")))
    id_img = torch.where(shown, id_img, torch.zeros_like(id_img))
    return FocusedRender(depth=depth, body_sil=id_img >> 8, region_sil=id_img & 255,
                         corner_u=corner_u, corner_v=corner_v, scale=scale,
                         body_visible=visible)
