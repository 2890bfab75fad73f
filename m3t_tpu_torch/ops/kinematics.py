"""Batched kinematic trees (port of m3t_tpu/ops/kinematics.py).

Fixed-topology structures are static-shape tensors: links padded to NL, hard
constraints to NC and soft constraints to NS, each with a validity mask.  A batch of S
independent structures is a leading axis (the JAX package vmaps over it); the static
NL, NC and NS are Python loops.  Every link keeps its full 6 twist coordinates and
non-free directions are pinned exactly: their Jacobian columns are zero, which zeroes
their KKT rows and columns, and the diagonal is set to 1 with a zero right-hand side,
so theta == 0 there and the solution on free coordinates equals the reference's
compacted solve (optimizer.cpp:144-167, 304-346).  Padded links and inactive
constraint rows are pinned the same way.

Pose-update convention: the root link's parent frame is the camera frame, so the state
stores ``joint2parent`` for every link with ``joint2parent_root = body2camera_root @
joint2body_root``, and one rule, ``joint2parent' = joint2parent @ variation``, updates
the whole tree (link.cpp:228-238).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3t_tpu_torch.common import (adjoint, pose_inverse, pose_variation, resolve_device,
                                  skew, so3_log, xcotx)
from m3t_tpu_torch.ops.depth_fn import rdiv
from m3t_tpu_torch.utils import timing

_DTYPES = dict(parent=torch.int32, link_valid=torch.bool, c_link1=torch.int32,
               c_link2=torch.int32, c_valid=torch.bool, s_link1=torch.int32,
               s_link2=torch.int32, s_valid=torch.bool)


class KinematicModel(NamedTuple):
    """Static description of a batch of S kinematic structures (NL padded links).

    Topology is in pre-order: ``parent[s, l] < l`` (roots have parent -1).  ``free`` is
    a float mask over the twist coordinates [wx wy wz tx ty tz] (link.h:56-66).
    """

    parent: torch.Tensor          # (S, NL) int32, -1 for roots
    body2joint: torch.Tensor      # (S, NL, 4, 4)
    joint2body: torch.Tensor      # (S, NL, 4, 4) precomputed inverse
    free: torch.Tensor            # (S, NL, 6) f32 mask
    link_valid: torch.Tensor      # (S, NL) bool
    # hard constraints (constraint.cpp)
    c_link1: torch.Tensor         # (S, NC) int32
    c_link2: torch.Tensor         # (S, NC) int32
    c_body12joint1: torch.Tensor  # (S, NC, 4, 4)
    c_body22joint2: torch.Tensor  # (S, NC, 4, 4)
    c_dirs: torch.Tensor          # (S, NC, 6) f32 mask
    c_valid: torch.Tensor         # (S, NC) bool
    # soft constraints (soft_constraint.cpp)
    s_link1: torch.Tensor         # (S, NS) int32
    s_link2: torch.Tensor         # (S, NS) int32
    s_body12joint1: torch.Tensor  # (S, NS, 4, 4)
    s_body22joint2: torch.Tensor  # (S, NS, 4, 4)
    s_dirs: torch.Tensor          # (S, NS, 6) f32 mask
    s_max_rotation: torch.Tensor  # (S, NS)
    s_max_translation: torch.Tensor  # (S, NS)
    s_std_rotation: torch.Tensor     # (S, NS)
    s_std_translation: torch.Tensor  # (S, NS)
    s_valid: torch.Tensor         # (S, NS) bool

    @staticmethod
    def from_numpy(arrays, device="cuda") -> "KinematicModel":
        """From a mapping of field name -> numpy array (the JAX package's
        KinematicModel as numpy, or an npz that holds its fields)."""
        dev = resolve_device(device)
        return KinematicModel(*(
            torch.as_tensor(np.ascontiguousarray(arrays[name]),
                            dtype=_DTYPES.get(name, torch.float32), device=dev)
            for name in KinematicModel._fields))

    def to_numpy(self) -> dict:
        return {name: getattr(self, name).cpu().numpy() for name in self._fields}

    def expand(self, n_structures: int) -> "KinematicModel":
        """The single structure of a batch of one, broadcast (as a view) to
        n_structures."""
        return KinematicModel(*(a.expand((n_structures,) + a.shape[1:]) for a in self))

    @property
    def n_links(self) -> int:
        return self.parent.shape[-1]


def _rows(x, index):
    """x[s, index[s]] for a leading structure axis: (S, N, ...) x (S, ...) -> (S, ...)."""
    s = torch.arange(x.shape[0], device=x.device).reshape((-1,) + (1,) * (index.dim() - 1))
    return x[s, index.long()]


def forward_kinematics(model: KinematicModel, joint2parent):
    """body2camera poses (S, NL, 4, 4) of every link (link.cpp:228-241), composed
    ``parent_pose @ joint2parent @ body2joint`` left to right."""
    nl = model.n_links
    poses = torch.zeros(joint2parent.shape, dtype=torch.float32, device=joint2parent.device)
    eye = torch.eye(4, dtype=torch.float32, device=joint2parent.device)
    for l in range(nl):
        p = model.parent[:, l]
        parent_pose = torch.where((p >= 0)[:, None, None],
                                  _rows(poses, torch.clamp(p, 0, nl - 1)), eye)
        poses[:, l] = parent_pose @ joint2parent[:, l] @ model.body2joint[:, l]
    return poses


def link_jacobians(model: KinematicModel, joint2parent):
    """Adjoint-chained tree Jacobians (link.cpp:159-182) in the full-width layout:
    (S, NL, 6, NL*6), row block l maps the packed theta to link l's body-frame twist.
    Non-free columns are exactly zero."""
    s, nl = model.parent.shape
    d = nl * 6
    adj_own = adjoint(model.joint2body) * model.free[:, :, None, :]   # (S, NL, 6, 6)
    jac = torch.zeros((s, nl, 6, d), dtype=torch.float32, device=joint2parent.device)
    for l in range(nl):
        p = model.parent[:, l]
        parent2body = pose_inverse(joint2parent[:, l] @ model.body2joint[:, l])
        chained = adjoint(parent2body) @ _rows(jac, torch.clamp(p, 0, nl - 1))
        chained = torch.where((p >= 0)[:, None, None], chained, torch.zeros_like(chained))
        own = torch.zeros((s, 6, d), dtype=torch.float32, device=jac.device)
        own[:, :, l * 6:(l + 1) * 6] = adj_own[:, l]
        jac[:, l] = chained + own
    return jac


def _angle_axis(rot):
    w = so3_log(rot)
    angle = torch.sqrt(torch.sum(w * w, dim=-1))
    x_axis = torch.zeros_like(w)
    x_axis[..., 0] = 1.0
    axis = torch.where((angle > 1e-12)[..., None],
                       w / torch.where(angle > 0, angle, torch.ones_like(angle))[..., None],
                       x_axis)
    return angle, axis


def _variation_matrix(angle, axis):
    """Rotation-vector variation matrices (constraint.cpp:226-232)."""
    half = 0.5 * angle
    xc = xcotx(half)[..., None, None]
    eye = torch.eye(3, dtype=torch.float32, device=angle.device)
    return (xc * eye - half[..., None, None] * skew(axis)
            + (1.0 - xc) * (axis[..., :, None] * axis[..., None, :]))


def _unprojected_rows(joint22joint1, body2joint1):
    """The rotation and translation rows of the full 6x6 UnprojectedConstraintJacobian
    (constraint.cpp:213-275), each (..., 3, 6)."""
    body2joint2 = pose_inverse(joint22joint1) @ body2joint1
    joint22body_t = pose_inverse(body2joint2)[..., :3, 3]
    rot1 = body2joint1[..., :3, :3]
    angle, axis = _angle_axis(joint22joint1[..., :3, :3])
    vm = _variation_matrix(angle, axis)
    rot_rows = torch.cat([vm @ rot1, torch.zeros_like(rot1)], dim=-1)
    cross_rows = torch.linalg.cross(joint22body_t[..., None, :].expand(rot1.shape), rot1,
                                    dim=-1)
    return rot_rows, torch.cat([cross_rows, rot1], dim=-1)


def _unprojected_jacobian(joint22joint1, body2joint1):
    """Full (..., 6, 6) UnprojectedConstraintJacobian (constraint.cpp:213-275)."""
    return torch.cat(_unprojected_rows(joint22joint1, body2joint1), dim=-2)


def constraint_terms(model: KinematicModel, body2camera, jac):
    """Residuals and projected Jacobians of all NC hard constraints.

    body2camera: (S, NL, 4, 4) link poses in any common frame; jac: (S, NL, 6, NL*6).
    Returns (residual (S, NC, 6), cjac (S, NC, 6, NL*6)), rows masked by
    c_dirs * c_valid."""
    nl = model.n_links
    link12cam = _rows(body2camera, torch.clamp(model.c_link1, 0, nl - 1))
    link22cam = _rows(body2camera, torch.clamp(model.c_link2, 0, nl - 1))
    b12j1 = model.c_body12joint1
    body22joint1 = b12j1 @ pose_inverse(link12cam) @ link22cam
    joint22joint1 = body22joint1 @ pose_inverse(model.c_body22joint2)
    residual = torch.cat([so3_log(joint22joint1[..., :3, :3]), joint22joint1[..., :3, 3]],
                         dim=-1)
    j2 = _unprojected_jacobian(joint22joint1, body22joint1)
    j1 = _unprojected_jacobian(joint22joint1, b12j1)
    cjac = (j2 @ _rows(jac, torch.clamp(model.c_link2, 0, nl - 1))
            - j1 @ _rows(jac, torch.clamp(model.c_link1, 0, nl - 1)))
    mask = model.c_dirs * model.c_valid.to(torch.float32)[..., None]
    return residual * mask, cjac * mask[..., None]


def _penalty(vec, mask, jac_rows, max_dist, std):
    """Quadratic penalty gradient (S, 6) and Hessian (S, 6, 6) on the masked subspace."""
    vec_m = vec * mask
    dist = torch.sqrt(torch.sum(vec_m * vec_m, dim=-1))
    active = (dist > max_dist) & (torch.sum(mask, dim=-1) > 0)
    safe = torch.where(dist > 0, dist, torch.ones_like(dist))
    unit = vec_m / safe[:, None]
    inv_var = rdiv(1.0, std * std)[:, None]
    eye_m = torch.diag_embed(mask)
    outer = unit[:, :, None] * unit[:, None, :]
    m = eye_m - (max_dist / safe)[:, None, None] * (eye_m - outer)
    jac_t = jac_rows.transpose(1, 2)
    g = -inv_var * (jac_t @ (vec_m - unit * max_dist[:, None])[..., None])[..., 0]
    h = -inv_var[..., None] * (jac_t @ m @ jac_rows)
    return (torch.where(active[:, None], g, torch.zeros_like(g)),
            torch.where(active[:, None, None], h, torch.zeros_like(h)))


def soft_constraint_terms(model: KinematicModel, body2camera):
    """Per-link gradient and Hessian additions of the soft constraints
    (soft_constraint.cpp:113-272): ((S, NL, 6), (S, NL, 6, 6))."""
    s, nl = model.parent.shape
    dev = body2camera.device
    g_add = torch.zeros((s, nl, 6), dtype=torch.float32, device=dev)
    h_add = torch.zeros((s, nl, 6, 6), dtype=torch.float32, device=dev)
    structure = torch.arange(s, device=dev)
    for i in range(model.s_link1.shape[1]):
        l1 = torch.clamp(model.s_link1[:, i], 0, nl - 1).long()
        l2 = torch.clamp(model.s_link2[:, i], 0, nl - 1).long()
        b12j1 = model.s_body12joint1[:, i]
        body22joint1 = (b12j1 @ pose_inverse(body2camera[structure, l1])
                        @ body2camera[structure, l2])
        joint22joint1 = body22joint1 @ pose_inverse(model.s_body22joint2[:, i])
        dirs = model.s_dirs[:, i] * model.s_valid[:, i].to(torch.float32)[:, None]
        w = so3_log(joint22joint1[:, :3, :3])
        t = joint22joint1[:, :3, 3]
        for sign, link, b2j1 in ((-1.0, l1, b12j1), (1.0, l2, body22joint1)):
            rot_rows, trans_rows = _unprojected_rows(joint22joint1, b2j1)
            g_r, h_r = _penalty(w, dirs[:, :3], rot_rows * dirs[:, :3, None],
                                model.s_max_rotation[:, i], model.s_std_rotation[:, i])
            g_t, h_t = _penalty(t, dirs[:, 3:], trans_rows * dirs[:, 3:, None],
                                model.s_max_translation[:, i],
                                model.s_std_translation[:, i])
            g_add[structure, link] += sign * g_r + sign * g_t
            h_add[structure, link] += h_r + h_t
    return g_add, h_add


def _solve(a, b):
    """Batched LU solve with partial pivoting, no error check (a singular system gives a
    non-finite result).  On the card it takes cuBLAS's batched LU for any batch: for
    more than 16 systems PyTorch's default takes MAGMA's, which waits on the host and so
    cannot be captured in a CUDA graph (graphs.py), and the eager and graphed cycles
    must compute alike.  PyTorch's choice of library is process-wide: it is set for
    this call and put back."""
    if a.device.type != "cuda":
        return torch.linalg.solve_ex(a, b, check_errors=False).result
    preferred = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return torch.linalg.solve_ex(a, b, check_errors=False).result
    finally:
        torch.backends.cuda.preferred_linalg_library(preferred)


def kkt_rows(model: KinematicModel) -> int:
    """Rows of each structure's KKT system in the full-width layout: NL * 6 + NC * 6."""
    return (model.n_links + model.c_link1.shape[1]) * 6


def count_work(model: KinematicModel) -> None:
    """Count one cycle's structures, links and KKT rows (utils/timing counters
    ``kinematics.structures``, ``kinematics.links`` and ``kinematics.kkt_rows``)."""
    s, nl = model.parent.shape
    timing.count("kinematics.structures", s)
    timing.count("kinematics.links", s * nl)
    timing.count("kinematics.kkt_rows", s * kkt_rows(model))


def update_structures(model: KinematicModel, joint2parent, gradients, hessians,
                      tikhonov_rotation: float, tikhonov_translation: float):
    """One Newton step for S structures, soft constraints included
    (optimizer.cpp:144-167, 304-346).

    joint2parent is (S, NL, 4, 4); gradients (S, NL, 6) and hessians (S, NL, 6, 6) are
    the per-link modality sums in the body frame (link.cpp:184-193).  The (NL*6 + NC*6)^2 KKT systems are solved in
    one batched call (_solve), and nothing is copied from the host, so the host never
    waits on the device here; a step that is not finite (a singular system) becomes zero.
    Returns the updated joint2parent (S, NL, 4, 4).

    Two stages are marked (utils/timing.stage): ``kinematic_terms`` (forward
    kinematics, the link Jacobians, the soft and hard constraint terms and the KKT
    assembly) and ``kkt_solve`` (the batched solve and the pose update)."""
    s, nl = model.parent.shape
    nc = model.c_link1.shape[1]
    d = nl * 6
    size = kkt_rows(model)
    dev = joint2parent.device

    timing.stage("kinematic_terms")
    body2camera = forward_kinematics(model, joint2parent)
    jac = link_jacobians(model, joint2parent)

    lv = model.link_valid.to(torch.float32)
    g = gradients * lv[..., None]
    h = hessians * lv[..., None, None]
    if model.s_link1.shape[1] > 0:
        g_add, h_add = soft_constraint_terms(model, body2camera)
        g = g + g_add * lv[..., None]
        h = h + h_add * lv[..., None, None]

    b = torch.zeros((s, size), dtype=torch.float32, device=dev)
    a = torch.zeros((s, size, size), dtype=torch.float32, device=dev)
    # AddProjectedGradientsAndHessians (optimizer.cpp:304-321).
    b[:, :d] = torch.einsum("slrd,slr->sd", jac, g)
    a[:, :d, :d] = -torch.einsum("slrd,slrq,slqe->sde", jac, h, jac)
    if nc > 0:
        residual, cjac = constraint_terms(model, body2camera, jac)
        b[:, d:] = residual.reshape(s, -1)
        rows = -cjac.reshape(s, nc * 6, d)
        a[:, d:, :d] = rows
        a[:, :d, d:] = rows.transpose(1, 2)

    # Diagonal: Tikhonov on free coordinates (optimizer.h:52-53, cpp:159); exact pinning
    # (diagonal 1, right-hand side 0) on non-free or padded coordinates and inactive
    # constraint rows, whose rows and columns are all zero by construction.
    col_free = (model.free * lv[..., None]).reshape(s, d) > 0
    tik = torch.full((nl, 6), tikhonov_rotation, dtype=torch.float32, device=dev)
    tik[:, 3:] = tikhonov_translation
    tik = tik.reshape(d)
    row_active = (model.c_dirs * model.c_valid.to(torch.float32)[..., None]
                  ).reshape(s, nc * 6) > 0
    diag = a.diagonal(dim1=-2, dim2=-1)
    one = torch.ones_like(diag)
    diag.copy_(torch.cat([torch.where(col_free, diag[:, :d] + tik, one[:, :d]),
                          torch.where(row_active, diag[:, d:], one[:, d:])], dim=-1))
    b = b * torch.cat([col_free, row_active], dim=-1)

    timing.stage("kkt_solve")
    theta = _solve(a, b[..., None])[..., 0]
    theta = torch.where(torch.isfinite(theta).all(dim=-1, keepdim=True), theta,
                        torch.zeros_like(theta))
    theta_links = theta[:, :d].reshape(s, nl, 6) * model.free * lv[..., None]
    return joint2parent @ pose_variation(theta_links)


# ----------------------------------------------------------------------------------------
# Host-side builders (object graph -> device tensors)
# ----------------------------------------------------------------------------------------


def build_kinematic_model(optimizers, n_links: int | None = None,
                          n_constraints: int | None = None,
                          n_soft_constraints: int | None = None,
                          device="cuda") -> KinematicModel:
    """A batched KinematicModel from host Optimizer object graphs
    (m3t_tpu/ops/kinematics.py:323-423).

    Links are indexed in the pre-order walk of each optimizer's tree
    (``ReferencedLinks()``), so parent[l] < l.  Child links with
    ``fixed_body2joint_pose == False`` are rejected: the batched path supports the
    (default) fixed convention only."""
    dev = resolve_device(device)
    structs = []
    for opt in optimizers:
        links = opt.ReferencedLinks()
        index = {id(l): i for i, l in enumerate(links)}
        parents = []

        def find_parent(link, links=links, index=index):
            for cand in links:
                if any(child is link for child in cand.child_link_ptrs):
                    return index[id(cand)]
            return -1

        for l in links:
            if not l.fixed_body2joint_pose and find_parent(l) >= 0:
                raise ValueError(
                    f"link {l.name}: fixed_body2joint_pose=False is not supported "
                    "on the batched kinematic path")
            parents.append(find_parent(l))
        structs.append((opt, links, index, parents))

    nl = max(len(st[1]) for st in structs)
    if n_links is not None:
        nl = max(nl, n_links)
    nc = max((len(st[0].constraint_ptrs) for st in structs), default=0)
    if n_constraints is not None:
        nc = max(nc, n_constraints)
    ns = max((len(st[0].soft_constraint_ptrs) for st in structs), default=0)
    if n_soft_constraints is not None:
        ns = max(ns, n_soft_constraints)

    s = len(structs)

    def eyes(n):
        return np.tile(np.eye(4, dtype=np.float32), (s, n, 1, 1))

    a = dict(
        parent=np.full((s, nl), -1, np.int32), body2joint=eyes(nl),
        free=np.zeros((s, nl, 6), np.float32), link_valid=np.zeros((s, nl), bool),
        c_link1=np.zeros((s, nc), np.int32), c_link2=np.zeros((s, nc), np.int32),
        c_body12joint1=eyes(nc), c_body22joint2=eyes(nc),
        c_dirs=np.zeros((s, nc, 6), np.float32), c_valid=np.zeros((s, nc), bool),
        s_link1=np.zeros((s, ns), np.int32), s_link2=np.zeros((s, ns), np.int32),
        s_body12joint1=eyes(ns), s_body22joint2=eyes(ns),
        s_dirs=np.zeros((s, ns, 6), np.float32),
        s_max_rotation=np.zeros((s, ns), np.float32),
        s_max_translation=np.zeros((s, ns), np.float32),
        s_std_rotation=np.ones((s, ns), np.float32),
        s_std_translation=np.ones((s, ns), np.float32),
        s_valid=np.zeros((s, ns), bool))

    for i, (opt, links, index, parents) in enumerate(structs):
        for j, l in enumerate(links):
            a["parent"][i, j] = parents[j]
            a["body2joint"][i, j] = l.body2joint_pose
            a["free"][i, j] = np.asarray(l.free_directions, np.float32)
            a["link_valid"][i, j] = True
        for k, c in enumerate(opt.constraint_ptrs):
            a["c_link1"][i, k] = index[id(c.link1_ptr)]
            a["c_link2"][i, k] = index[id(c.link2_ptr)]
            a["c_body12joint1"][i, k] = c.body12joint1_pose
            a["c_body22joint2"][i, k] = c.body22joint2_pose
            a["c_dirs"][i, k] = np.asarray(c.constraint_directions, np.float32)
            a["c_valid"][i, k] = True
        for k, sc in enumerate(opt.soft_constraint_ptrs):
            a["s_link1"][i, k] = index[id(sc.link1_ptr)]
            a["s_link2"][i, k] = index[id(sc.link2_ptr)]
            a["s_body12joint1"][i, k] = sc.body12joint1_pose
            a["s_body22joint2"][i, k] = sc.body22joint2_pose
            a["s_dirs"][i, k] = np.asarray(sc.constraint_directions, np.float32)
            a["s_max_rotation"][i, k] = sc.max_distance_rotation
            a["s_max_translation"][i, k] = sc.max_distance_translation
            a["s_std_rotation"][i, k] = sc.standard_deviation_rotation
            a["s_std_translation"][i, k] = sc.standard_deviation_translation
            a["s_valid"][i, k] = True

    a["joint2body"] = np.linalg.inv(a["body2joint"].astype(np.float64)).astype(np.float32)
    return KinematicModel.from_numpy(a, dev)


def initial_joint2parent(optimizers, world2camera=None, n_links: int | None = None,
                         device="cuda") -> torch.Tensor:
    """Per-link joint2parent poses (S, NL, 4, 4) in the camera frame
    (m3t_tpu/ops/kinematics.py:426-457): root links get ``world2camera @ link2world @
    joint2body``, child links keep their joint2parent, padded links the identity."""
    dev = resolve_device(device)
    w2c = (np.eye(4, dtype=np.float32) if world2camera is None
           else np.asarray(world2camera, np.float32))
    per_struct = []
    for opt in optimizers:
        links = opt.ReferencedLinks()
        children = {id(child) for l in links for child in l.child_link_ptrs}
        poses = []
        for l in links:
            if id(l) in children:
                poses.append(np.asarray(l.joint2parent_pose, np.float32))
            else:
                j2b = np.linalg.inv(l.body2joint_pose.astype(np.float64)).astype(np.float32)
                poses.append(w2c @ l.link2world_pose @ j2b)
        per_struct.append(np.stack(poses))
    nl = max(p.shape[0] for p in per_struct)
    if n_links is not None:
        nl = max(nl, n_links)
    out = np.tile(np.eye(4, dtype=np.float32), (len(per_struct), nl, 1, 1))
    for i, p in enumerate(per_struct):
        out[i, :p.shape[0]] = p
    return torch.as_tensor(out, device=dev)
