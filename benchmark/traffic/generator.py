"""The one traffic generator: frames of moving spheres, made on the device from a seed.

A traffic mix is a JSON file beside this one (``<traffic>.json``) holding numbers only:
the batch (sequences or structures), the frames of each sequence's ring, the motion per
frame, the spread of the sequences' positions, the jitter of the initial poses and the
pixel noise.  Every seed gets the same sizes and the same motion; the seed draws only the
positions, the jitter and the noise.

Frames are rendered analytically: a pixel shows the nearest sphere its ray meets, shaded
by a Lambertian term so that the colour histograms are broad, or the background colour;
depth frames hold the sphere's depth in ``depth_scale`` units and ``background_depth``
elsewhere.  Camera frame: x right, y down, z forward, pixel (u, v) samples the ray
through ((u - ppu) / fu, (v - ppv) / fv, 1).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
LIGHT = (0.4, -0.5, -0.77)
BACKGROUND_BGR = (40, 120, 190)
# Rows of frames rendered together: bounds the float temporaries to a few hundred MB.
BLOCK = 16


def load(name: str) -> dict:
    """The parameters of traffic mix ``name`` (``<name>.json`` beside this file)."""
    return json.loads((HERE / f"{name}.json").read_text())


def pingpong(i: int, n: int) -> int:
    """Frame i of a replay 0, 1, .., n-1, n-2, .., 1, 0, 1, ..: one step of motion per
    frame, without end."""
    i %= 2 * (n - 1)
    return i if i < n else 2 * (n - 1) - i


def seeded(seed: int) -> tuple[np.random.Generator, int]:
    """A host generator and a 63-bit device seed, both from ``seed`` (any integer)."""
    rng = np.random.default_rng(np.random.SeedSequence(abs(int(seed))))
    return rng, int(rng.integers(0, 2 ** 62))


def render(centers, radius: float, colours, intr, width: int, height: int, noise: int,
           generator: torch.Generator, depth_scale: float | None = None,
           background_depth: float = 2.0):
    """Frames of spheres: centers (N, K, 3) float camera-frame positions of K spheres of
    ``radius`` in each of N frames, colours (K, 3) BGR; intr (fu, fv, ppu, ppv).
    Returns planar colour (N, 3, H, W) uint8 with integer noise in [-noise, noise] drawn
    from ``generator``, and with ``depth_scale`` also depth (N, H, W) uint16."""
    device = centers.device
    fu, fv, ppu, ppv = intr
    n, k = centers.shape[:2]
    du = (torch.arange(width, device=device, dtype=torch.float32) - ppu) / fu
    dv = (torch.arange(height, device=device, dtype=torch.float32) - ppv) / fv
    d = torch.stack(torch.broadcast_tensors(du[None, :], dv[:, None],
                                            torch.ones(height, width, device=device)), -1)
    dd = (d * d).sum(-1)                                            # (H, W)
    light = torch.tensor(LIGHT, device=device)
    colours = torch.as_tensor(colours, dtype=torch.float32, device=device)
    background = torch.tensor(BACKGROUND_BGR, dtype=torch.float32, device=device)
    colour = torch.empty((n, 3, height, width), dtype=torch.uint8, device=device)
    depth = (torch.empty((n, height, width), dtype=torch.int16, device=device)
             if depth_scale is not None else None)
    for i in range(0, n, BLOCK):
        c = centers[i:i + BLOCK].to(torch.float32)                  # (M, K, 3)
        m = c.shape[0]
        dc = torch.einsum("hwx,mkx->mkhw", d, c)
        cc = (c * c).sum(-1)[..., None, None]
        disc = dc * dc - dd * (cc - radius * radius)
        t = (dc - disc.clamp_min(0).sqrt()) / dd
        t = torch.where(disc >= 0, t, torch.inf)                    # (M, K, H, W)
        z, which = t.min(1)                                         # (M, H, W)
        hit = torch.isfinite(z)
        point = z[..., None] * d                                    # (M, H, W, 3)
        centre = torch.gather(c, 1, which.reshape(m, -1, 1).expand(-1, -1, 3)
                              ).reshape(m, height, width, 3)
        normal = (point - centre) / radius
        shade = 0.55 + 0.45 * (-(normal * light).sum(-1)).clamp(0.0, 1.0)
        fg = colours[which] * shade[..., None]                      # (M, H, W, 3)
        pixel = torch.where(hit[..., None], fg, background).floor()
        jitter = torch.randint(-noise, noise + 1, pixel.shape, generator=generator,
                               device=device, dtype=torch.int16)
        pixel = (pixel.to(torch.int16) + jitter).clamp(0, 255).to(torch.uint8)
        colour[i:i + m] = pixel.permute(0, 3, 1, 2)
        if depth is not None:
            metric = torch.where(hit, z, background_depth)
            # Depths stay under 32768 units, so int16 holds them as uint16 would.
            depth[i:i + m] = torch.round(metric / depth_scale).to(torch.int16)
    return colour, None if depth is None else depth.view(torch.uint16)


def forward_kinematics(parent, joint2parent, body2joint):
    """Link poses (..., NL, 4, 4) of structures: ``parent_pose @ joint2parent @
    body2joint`` from the root down (a root's parent pose is the camera frame)."""
    poses = np.zeros(joint2parent.shape, np.float64)
    for link in range(joint2parent.shape[-3]):
        p = parent[link]
        base = np.eye(4) if p < 0 else poses[..., p, :, :]
        poses[..., link, :, :] = base @ joint2parent[..., link, :, :] @ body2joint[link]
    return poses


class Sequences(NamedTuple):
    """One traffic mix made from a seed.  ``colour`` (F, N, 3, H, W) uint8 and ``depth``
    (F, N, H, W) uint16 (or None): each of the N sequences has a ring of F frames of its
    own.  ``truth`` (F, N, NL, 3): every sphere's centre in each frame.  ``start`` (N,
    NL, 4, 4) or (N, 4, 4): the initial poses (joint poses of a structure, body poses of a
    rigid body), the true ones of frame 0 with their jitter."""

    colour: torch.Tensor
    depth: torch.Tensor | None
    truth: np.ndarray
    start: np.ndarray


def sequences(traffic: dict, config: dict, seed: int, device, structure=None) -> Sequences:
    """The frames, truths and initial poses of a traffic mix for a configuration.

    Sequence n's spheres sit at ``offset_m``-uniform x/y offsets from their place in the
    configuration (the rigid body at depth ``depth_m`` on the optical axis; a
    structure's links where its joint state puts them) and move ``step_m`` along x per
    frame.  The initial pose is frame 0's with a ``jitter_m``-uniform x/y error (of the
    root joint, for a structure).  structure: the raw arrays of a kinematic structure
    (``parent``, ``body2joint``, ``joint2parent``), or None for one rigid body."""
    rng, device_seed = seeded(seed)
    n, n_frames = traffic["batch"], traffic["ring_frames"]
    offsets = np.zeros((n, 3))
    offsets[:, :2] = rng.uniform(-traffic["offset_m"], traffic["offset_m"], (n, 2))
    jitter = np.zeros((n, 3))
    jitter[:, :2] = rng.uniform(-traffic["jitter_m"], traffic["jitter_m"], (n, 2))
    motion = np.arange(n_frames)[:, None, None] * np.asarray(traffic["step_m"])
    if structure is None:
        place = np.array([0.0, 0.0, traffic["depth_m"]])
        truth = (place + offsets)[None, :, None] + motion[:, :, None]   # (F, N, 1, 3)
        start = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
        start[:, :3, 3] = truth[0, :, 0] + jitter
    else:
        parent = structure["parent"][0]
        body2joint = structure["body2joint"][0].astype(np.float64)
        joints = np.tile(structure["joint2parent"][0].astype(np.float64), (n_frames, n, 1, 1, 1))
        joints[:, :, 0, :3, 3] += offsets + motion
        truth = forward_kinematics(parent, joints, body2joint)[..., :3, 3]  # (F, N, NL, 3)
        start = joints[0].astype(np.float32)
        start[:, 0, :3, 3] += jitter
    colours = np.asarray(config["link_colours_bgr"], np.float32)
    generator = torch.Generator(device=device).manual_seed(device_seed)
    centres = torch.as_tensor(truth.reshape(n_frames * n, -1, 3), dtype=torch.float32,
                              device=device)
    depth_scale = config.get("depth_scale") if "depth_model" in config else None
    colour, depth = render(centres, config["body_radius"], colours,
                           tuple(float(config[k]) for k in ("fu", "fv", "ppu", "ppv")),
                           config["width"], config["height"], traffic["noise"], generator,
                           depth_scale, config.get("background_depth", 2.0))
    colour = colour.reshape((n_frames, n) + colour.shape[1:])
    if depth is not None:
        depth = depth.reshape((n_frames, n) + depth.shape[1:])
    return Sequences(colour, depth, truth, start)


def checkpoints(traffic: dict, seed: int) -> list[int]:
    """Window steps (0-based) whose outputs the reference recomputes, drawn from the seed
    among the first ``checkpoint_span`` steps."""
    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)), 1]))
    return sorted(int(i) for i in rng.choice(traffic["checkpoint_span"],
                                             traffic["checkpoints"], replace=False))
