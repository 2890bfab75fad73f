"""Parity tests: the texture terms (ops/texture_fn.py), the rigid cycles' texture and
depth-budget inputs, and texture_points_from_modalities against the JAX package on the
CPU.

Cycle inputs are tests/test_pipeline.py::_build_batch (160x120 frames, 64 lines, scales
(2, 1), 3x2 iterations) with texture matches of each body at the frame's rendered pose
(surface points facing the camera, 1 px noise, about a third invalid) and, for the RGB-D
cycle, depth models and frames as tests/test_torch_pipeline.py builds them.
Tolerances: the terms 1e-5 relative to their largest entry; poses and histograms atol
1e-4, as tests/test_torch_pipeline.py holds them.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu import common as jcommon
from m3t_tpu import pipeline as jpipe
from m3t_tpu.depth_model import DepthModel
from m3t_tpu.ops import texture_fn as jtex
from m3t_tpu.ops.depth_fn import DepthConfig as JDepthConfig
from m3t_tpu.ops.region_fn import RegionConfig as JRegionConfig
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.ops import texture_fn as ttex
from m3t_tpu_torch.ops.depth_fn import DepthConfig as TDepthConfig
from m3t_tpu_torch.ops.region_fn import RegionConfig as TRegionConfig
from tests import fixtures
from tests.test_pipeline import _build_batch

K_TEX = 32
DEPTH_SCALE = 0.001


def _t(a):
    return torch.as_tensor(np.array(a))


def _random_points(rng, n_bodies=6, k=64):
    """Random matches: body-frame points within 5 cm, poses 0.3-0.7 m away (the last
    body 2 cm away, so that some of its points lie behind the camera), image points at
    the projections plus offsets from 0.5 px to 60 px (both sides of the Tukey constant
    20), about a third invalid."""
    p3 = rng.uniform(-0.05, 0.05, (n_bodies, k, 3)).astype(np.float32)
    theta = rng.normal(scale=0.3, size=(n_bodies, 6)).astype(np.float32)
    pose = np.array(jcommon.pose_variation(theta))
    pose[:, :3, 3] = np.stack([rng.uniform(-0.05, 0.05, n_bodies),
                               rng.uniform(-0.05, 0.05, n_bodies),
                               rng.uniform(0.3, 0.7, n_bodies)], 1)
    pose[-1, 2, 3] = 0.02
    cam = p3 @ np.swapaxes(pose[:, :3, :3], 1, 2) + pose[:, None, :3, 3]
    z = np.where(np.abs(cam[..., 2]) > 1e-3, cam[..., 2], 1.0)
    uv = np.stack([cam[..., 0] * 150.0 / z + 80.0, cam[..., 1] * 150.0 / z + 60.0], -1)
    offset = rng.normal(size=(n_bodies, k, 2))
    offset *= (rng.uniform(0.5, 60.0, (n_bodies, k))
               / np.linalg.norm(offset, axis=-1))[..., None]
    return (p3, (uv + offset).astype(np.float32), rng.random((n_bodies, k)) > 0.3), pose


@pytest.mark.parametrize("tukey", [20.0, 5.0])
def test_texture_terms_match_jax(rng, tukey):
    points, pose = _random_points(rng)
    assert (points[0][-1] @ pose[-1, :3, :3].T + pose[-1, :3, 3])[:, 2].min() < 0
    intr = (np.float32(150.0), np.float32(150.0), np.float32(80.0), np.float32(60.0))
    want_g, want_h = jax.jit(jax.vmap(
        lambda tp, p: jtex.calculate_gradient_and_hessian(tp, p, *intr, 7.5, tukey)))(
        jtex.TexturePoints(*(jnp.asarray(x) for x in points)), jnp.asarray(pose))
    got_g, got_h = ttex.calculate_gradient_and_hessian(
        ttex.TexturePoints(*(_t(x) for x in points)), _t(pose), *intr, 7.5, tukey)
    for got, want in ((got_g, want_g), (got_h, want_h)):
        want = np.asarray(want)
        scale = np.abs(want).max(axis=tuple(range(1, want.ndim)), keepdims=True)
        np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=0, atol=1e-5)
    assert np.abs(got_g.numpy()).min(axis=1).max() > 0


def test_texture_points_from_modalities_match_jax(rng):
    modalities = [SimpleNamespace(data_points_3d=rng.normal(size=(n, 3)),
                                  data_points_2d=rng.normal(size=(n, 2)))
                  for n in (0, 5, 40)]
    want = jpipe.texture_points_from_modalities(modalities, 32)
    got = tpipe.texture_points_from_modalities(modalities, 32, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return _build_batch(tmp_path_factory.mktemp("ttex"))


@pytest.fixture(scope="module")
def scene(built, tmp_path_factory):
    """The batch's models (JAX and port), depth models and frames, and per-frame texture
    matches of every body at its rendered pose."""
    intr_t, bodies, models, gt_poses, frames = built
    tmp = tmp_path_factory.mktemp("ttexd")
    dmodels = [DepthModel(f"ttdm{i}", body, str(tmp / f"dm{i}.npz"), n_divides=1,
                          n_points=64, image_size=200) for i, body in enumerate(bodies)]
    assert all(m.SetUp() for m in dmodels)
    rng = np.random.default_rng(12)
    texture = []
    for poses in gt_poses:
        p3 = np.zeros((len(bodies), K_TEX, 3), np.float32)
        p2 = np.zeros((len(bodies), K_TEX, 2), np.float32)
        for i, pose in enumerate(poses):
            d = rng.normal(size=(K_TEX, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            d[:, 2] = -np.abs(d[:, 2])
            p3[i] = (0.05 + 0.01 * i) * d
            cam = p3[i] @ pose[:3, :3].T + pose[:3, 3]
            p2[i] = np.stack([cam[:, 0] * intr_t.fu / cam[:, 2] + intr_t.ppu,
                              cam[:, 1] * intr_t.fv / cam[:, 2] + intr_t.ppv], 1)
        p2 += rng.normal(size=p2.shape)
        texture.append((p3, p2, rng.random((len(bodies), K_TEX)) > 0.3))
    depth_frames = np.stack([
        np.stack([fixtures.render_synthetic_depth_frame(body, intr_t, gt_poses[t][i])
                  for i, body in enumerate(bodies)]) for t in range(len(gt_poses))])
    return dict(intr=tuple(np.float32(x) for x in (intr_t.fu, intr_t.fv, intr_t.ppu,
                                                   intr_t.ppv)),
                models=models, dmodels=dmodels, gt_poses=gt_poses, frames=frames,
                depth_frames=depth_frames, texture=texture)


def _pcfgs(rgbd):
    common = dict(scales=(2, 1), standard_deviations=(5.0, 1.5), n_corr_iterations=3,
                  n_update_iterations=2, use_texture=True,
                  texture_standard_deviations=(15.0, 5.0), use_depth=rgbd,
                  considered_distances=(0.03, 0.02), depth_standard_deviations=(0.05, 0.03))
    return (jpipe.PipelineConfig(cfg=JRegionConfig(n_lines_max=64),
                                 depth_cfg=JDepthConfig(n_points_max=64), **common),
            tpipe.PipelineConfig(cfg=TRegionConfig(n_lines_max=64),
                                 depth_cfg=TDepthConfig(n_points_max=64), **common))


def _assert_states_close(t_state, j_state, label):
    for name in ("body2camera_pose", "histogram_f", "histogram_b"):
        np.testing.assert_allclose(getattr(t_state, name).numpy(),
                                   np.asarray(getattr(j_state, name)), rtol=0, atol=1e-4,
                                   err_msg=f"{name}, {label}")


CASES = {
    # Both bodies, texture terms on the region cycle.
    "region": dict(slots=(0, 1), rgbd=False),
    # Both bodies, depth and texture terms, body 1 with a depth budget of 20 points.
    "rgbd": dict(slots=(0, 1), rgbd=True, depth_n_points=(64, 20)),
    # Two slots of body 0 tied to one pose; the second slot has no depth points, as the
    # non-primary slots of a multi-region entry (ycb_evaluator.cpp:427-453).
    "rgbd pose group": dict(slots=(0, 0), rgbd=True, depth_n_points=(64, 0),
                            pose_group=(0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_cycle_with_texture_matches_jax_and_tracks(scene, case):
    """initialize_histograms and three cycles with texture_points (and depth_n_points,
    pose_group) against the JAX cycles; every body within 5 mm of the last frame's
    pose."""
    c = CASES[case]
    slots = list(c["slots"])
    intr = scene["intr"]
    jpcfg, tpcfg = _pcfgs(c["rgbd"])
    jmodel = jpipe.RegionModelArrays.from_models([scene["models"][i] for i in slots], 64)
    tmodel = tpipe.RegionModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in jmodel._asdict().items()}, device="cpu")
    jdmodel = jpipe.DepthModelArrays.from_models([scene["dmodels"][i] for i in slots], 64)
    tdmodel = tpipe.DepthModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in jdmodel._asdict().items()}, device="cpu")
    gt, frames = scene["gt_poses"][:, slots], scene["frames"][:, slots]
    j_state = jpipe.initialize_histograms(jpcfg, intr, jnp.asarray(frames[0]), jmodel,
                                          jnp.asarray(gt[0]))
    t_state = tpipe.initialize_histograms(tpcfg, intr, _t(frames[0]), tmodel, _t(gt[0]))
    extra = {k: np.asarray(c[k], np.int32) for k in ("depth_n_points", "pose_group")
             if k in c}
    for t in range(1, len(frames)):
        tex = [x[slots] for x in scene["texture"][t]]
        jkw = dict(texture_points=jtex.TexturePoints(*(jnp.asarray(x) for x in tex)),
                   **{k: jnp.asarray(v) for k, v in extra.items()})
        tkw = dict(texture_points=ttex.TexturePoints(*(_t(x) for x in tex)),
                   **{k: _t(v) for k, v in extra.items()})
        if c["rgbd"]:
            depth = scene["depth_frames"][t][slots]
            j_state = jpipe.tracking_cycle_rgbd(
                jpcfg, intr, intr, jnp.float32(DEPTH_SCALE), jnp.asarray(frames[t]),
                jnp.asarray(depth), jmodel, jdmodel, j_state, **jkw)
            t_state = tpipe.tracking_cycle_rgbd(tpcfg, intr, intr, DEPTH_SCALE,
                                                _t(frames[t]), _t(depth), tmodel, tdmodel,
                                                t_state, **tkw)
        else:
            j_state = jpipe.tracking_cycle(jpcfg, intr, jnp.asarray(frames[t]), jmodel,
                                           j_state, **jkw)
            t_state = tpipe.tracking_cycle(tpcfg, intr, _t(frames[t]), tmodel, t_state,
                                           **tkw)
        _assert_states_close(t_state, j_state, f"cycle {t}")
    est = t_state.body2camera_pose.numpy()
    err = np.linalg.norm(est[:, :3, 3] - gt[-1][:, :3, 3], axis=1)
    assert np.all(np.isfinite(est)) and np.all(err < 0.005), f"translation errors {err}"
    if "pose_group" in c:
        assert torch.equal(t_state.body2camera_pose[0], t_state.body2camera_pose[1])
