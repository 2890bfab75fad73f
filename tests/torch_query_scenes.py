"""Scenes and queries for the query_eval kernel's tests, and a CPU emulation of its
cull (tests/test_torch_culling.py on the CPU, tests/test_torch_kernels.py on the card).

- :func:`robot_scenes` and :func:`robot_queries`: the kinematic cell's per-link focused
  scenes and windowed int32 queries.
- :func:`trap_scene`: a scene that only an exact, order-keeping block cull answers right.
- :func:`culled_query_eval`: the kernel's algorithm, step for step, on the CPU, with the
  tally of rows that the kernel counts.
"""

import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from m3t_tpu_torch.ops import occlusion as oc
from m3t_tpu_torch.ops import raster

QUERIES_PER_TILE, TILES_PER_BLOCK, LIST_ROWS = 256, 4, 512  # the kernel's constants
inf = float("inf")


class BlockCull(NamedTuple):
    scanned: int          # the blocks' loop bounds, summed: the kernel's tally[0]
    kept: torch.Tensor    # (B, blocks) rows of each block's lists: summed, tally[1]


def culled_query_eval(coeffs, tri_valid, sil_id, u, v):
    """A CPU emulation of the query_eval kernel's cull; returns (inv, ids, BlockCull).
    Block level: per block of TILES_PER_BLOCK x QUERIES_PER_TILE queries, a list of rows,
    each on the chain of its t.  Where the scenes hold more than LIST_ROWS rows the list
    holds the valid rows under the scene's loop bound that box_outside does not rule out
    for the box of the block's non-NaN queries, in increasing t, cut into lists of
    LIST_ROWS rows (rounds), and no row where the block has no non-NaN query; otherwise
    it holds every row under the loop bound, invalid rows as the edge plane (0, 0, -1).
    Warp level: per warp of 32 queries two half-warp boxes; the warp evaluates, list by
    list and in list order, only the rows that box_outside does not rule out for both
    boxes.  Equals query_eval_plain wherever the culls drop only pairs that cover nothing
    and the lists keep each chain's order."""
    b, n_tri = coeffs.shape[:2]
    uf = u.reshape(b, -1).to(torch.float32)
    vf = v.reshape(b, -1).to(torch.float32)
    q = uf.shape[1]
    per_block = QUERIES_PER_TILE * TILES_PER_BLOCK
    n_blocks = -(-q // per_block)
    qu, qv = (torch.nn.functional.pad(x, (0, n_blocks * per_block - q), value=float("nan"))
              .reshape(b, n_blocks, per_block // 32, 32) for x in (uf, vf))
    counted = ~(qu.isnan() | qv.isnan())
    lo = [torch.where(counted, x, inf) for x in (qu, qv)]
    hi = [torch.where(counted, x, -inf) for x in (qu, qv)]
    block_box = torch.stack([lo[0].amin((-2, -1)), hi[0].amax((-2, -1)),
                             lo[1].amin((-2, -1)), hi[1].amax((-2, -1))], -1)
    block_has = counted.any(-1).any(-1)                                  # (B, blocks)
    lo, hi = ([x.reshape(b, n_blocks, -1, 2, 16) for x in ends] for ends in (lo, hi))
    half_box = torch.stack([lo[0].amin(-1), hi[0].amax(-1), lo[1].amin(-1), hi[1].amax(-1)],
                           -1)                                       # (B, blocks, 32, 2, 4)
    half_has = counted.reshape(b, n_blocks, -1, 2, 16).any(-1)

    # Block level: each block's list of rows, in increasing t.
    bound = oc.leading_valid_count(tri_valid)
    if n_tri > LIST_ROWS:
        keep = (tri_valid[:, None, :] & block_has[..., None]
                & ~oc.box_outside(coeffs[:, None], block_box[:, :, None]))  # (B, blocks, T)
        rows = coeffs
    else:
        under = torch.arange(n_tri) < bound[:, None]
        keep = under[:, None, :].expand(b, n_blocks, n_tri)
        empty_row = torch.zeros(12)
        empty_row[2] = -1.0
        rows = torch.where(tri_valid[..., None], coeffs, empty_row)
    kept = keep.sum(-1)
    order = torch.sort((~keep).to(torch.int8), dim=-1, stable=True).indices
    scene = torch.arange(b)[:, None, None]
    n_list = int(kept.max()) if keep.numel() else 0
    listed_t = order[..., :n_list]                              # (B, blocks, n_list)
    listed_rows = rows[scene, listed_t]
    listed_ids = sil_id[scene, listed_t]

    # Warp level: every list position of every round, on the warps of its block.
    zero = torch.zeros_like(qu)
    best, best_id = [zero, zero], [torch.zeros_like(qu, dtype=torch.int32)] * 2
    for start in range(0, n_list, LIST_ROWS):                   # rounds
        for j in range(start, min(start + LIST_ROWS, n_list)):
            c = listed_rows[:, :, j]                                    # (B, blocks, 12)
            cc = c[:, :, None, None, :]
            survives = (~oc.box_outside(cc, half_box) & half_has).any(-1)
            survives &= (j < kept)[..., None]
            e0, e1, e2, inv = ((cc[..., 3 * k] * qu + cc[..., 3 * k + 1] * qv)
                               + cc[..., 3 * k + 2] for k in range(4))
            s = torch.where((e0 >= 0) & (e1 >= 0) & (e2 >= 0) & (inv > 1e-12), inv, zero)
            s = torch.where(survives[..., None], s, zero)
            odd = (listed_t[:, :, j] % 2 == 1)[:, :, None, None]
            ids = listed_ids[:, :, j, None, None]
            for chain, on in ((0, ~odd), (1, odd)):
                sel = on & (s > best[chain])
                best[chain] = torch.where(sel, s, best[chain])
                best_id[chain] = torch.where(sel, ids, best_id[chain])
    sel = best[1] > best[0]
    inv = torch.where(sel, best[1], best[0]).reshape(b, -1)[:, :q]
    ids = torch.where(sel, best_id[1], best_id[0]).reshape(b, -1)[:, :q]
    tally = BlockCull(scanned=int(bound.sum()) * n_blocks, kept=kept)
    return inv.reshape(u.shape), ids.reshape(u.shape), tally


def trap_scene(n_scenes: int, device):
    """query_eval inputs (coeffs, tri_valid, sil_id, u, v) that only an exact block
    cull answers right, the same scene n_scenes times.  Pixel-space triangles: t0 and t3
    far from every query, so the block cull drops them and a row's place in its list
    has another parity than its t; t1, t2, t4 and t5 one triangle T (ids 21, 22, 24,
    25), where the answer is t2 (the first of chain 0, which wins the tie); t6 a
    triangle R (26) that only the block's last tile of queries reaches; then invalid
    rows up to LIST_ROWS + 8, so that the kernel culls the block's rows rather than
    staging them whole.  Queries: one block of 1024 float pixels, 768 on a grid over T
    and the last 256 on a grid over R."""
    far = [[500, 500], [530, 500], [500, 530]]
    t = [[8, 8], [8, 40], [40, 8]]
    r = [[100, 100], [100, 130], [130, 100]]
    tris = np.array([far, t, t, far, t, t, r], np.float32)
    z = np.array([1, 2, 2, 1, 2, 2, 1.5], np.float32)[:, None, None]
    verts = np.concatenate([tris * z, np.broadcast_to(z, tris.shape[:2] + (1,))], -1)
    soup = raster.triangle_coefficients(
        torch.as_tensor(verts[None], device=device),
        torch.tensor([[20, 21, 22, 23, 24, 25, 26]], dtype=torch.int32, device=device),
        1.0, 1.0, 0.0, 0.0)
    pad = LIST_ROWS + 8 - len(tris)
    coeffs = torch.nn.functional.pad(soup.coeffs, (0, 0, 0, pad))
    valid, ids = (torch.nn.functional.pad(x, (0, pad)) for x in (soup.valid, soup.ids))
    near_v, near_u = np.meshgrid(np.arange(24) * 2.0, np.arange(32) * 1.5, indexing="ij")
    far_v, far_u = np.meshgrid(100 + np.arange(16) * 2.0, 100 + np.arange(16) * 2.0,
                               indexing="ij")
    u, v = ([torch.as_tensor(np.concatenate([a.ravel(), b.ravel()]), dtype=torch.float32,
                             device=device)[None].expand(n_scenes, -1)
             for a, b in ((near_u, far_u), (near_v, far_v))])
    return (coeffs.expand(n_scenes, -1, -1), valid.expand(n_scenes, -1),
            ids.expand(n_scenes, -1), u, v)


def robot_scenes(device, seed, n_structures=4):
    """(geom, scene_poses, intr, width, height): the kinematic cell's per-link scenes
    (its configuration's seven icospheres, scene l focused on link l) of n_structures
    robots, each joint turned by up to 8 degrees and the root moved by up to 2 cm from
    the configured pose (seeded), on the cell's camera."""
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    from benchmark.harness import spec
    from benchmark.traffic import generator

    module = spec.load_module("drivers", "fused_kinematic")
    config = spec.config("rtb_kinematic_rgbd")
    vertices, triangles = module.scene_meshes(config)
    nl = len(config["structure"]["parent"])
    bodies = [oc.SceneBody(vertices, triangles, body_id=link + 1, region_id=link + 1)
              for link in range(nl)]
    one = oc.build_kinematic_scene_geometry([bodies], referenced=[[k] for k in range(nl)],
                                            device=device)
    geom = type(one)(*(a.repeat((n_structures,) + (1,) * (a.dim() - 1)) for a in one))
    body2joint, joint2parent = module.joint_poses(config)
    rng = np.random.default_rng(seed)
    joints = np.tile(joint2parent.astype(np.float64), (n_structures, 1, 1, 1))
    for s in range(n_structures):
        for link in range(nl):
            axis = rng.normal(size=3)
            axis *= np.deg2rad(rng.uniform(-8, 8)) / np.linalg.norm(axis)
            k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                          [-axis[1], axis[0], 0]])
            angle = np.linalg.norm(axis)
            turn = np.eye(3) + np.sin(angle) / angle * k + (
                1 - np.cos(angle)) / angle ** 2 * k @ k
            joints[s, link, :3, :3] = joints[s, link, :3, :3] @ turn
        joints[s, 0, :3, 3] += rng.uniform(-0.02, 0.02, 3)
    links = generator.forward_kinematics(config["structure"]["parent"], joints,
                                         body2joint.astype(np.float64))
    scene_poses = torch.as_tensor(np.repeat(links, nl, axis=0), dtype=torch.float32,
                                  device=device)
    intr = tuple(float(config[k]) for k in ("fu", "fv", "ppu", "ppv"))
    return geom, scene_poses, intr, int(config["width"]), int(config["height"])


def robot_queries(device, seed, n_structures):
    """query_eval inputs at the kinematic cell's shape: the focused scenes of
    robot_scenes (the plain twin's coefficients) and, in every scene, 200 windows of
    6 x 6 int32 pixels at a stride of 3 about points of the link's contour (94 pixels
    from the crop's centre, where its silhouette ends), spread by the golden angle as
    the cell's lines and points are: Q = 7200, so each scene's last block of 1024
    queries is ragged."""
    geom, scene_poses, intr, width, height = robot_scenes(device, seed, n_structures)
    sc = oc.focused_scene_coeffs_plain(geom, scene_poses, intr, width, height, 200)
    angle = np.arange(200) * np.pi * (3.0 - np.sqrt(5.0))
    centre = np.floor(99.5 + 94.0 * np.stack([np.cos(angle), np.sin(angle)], -1))
    step = 3 * (np.arange(6) - 2)
    u = np.broadcast_to(centre[:, 0, None, None] + step[None, None, :], (200, 6, 6))
    v = np.broadcast_to(centre[:, 1, None, None] + step[None, :, None], (200, 6, 6))
    b = sc.coeffs.shape[0]
    u, v = (torch.as_tensor(x.reshape(1, -1), dtype=torch.int32, device=device).expand(b, -1)
            for x in (u, v))
    return sc.coeffs, sc.tri_valid, sc.sil_id, u, v
