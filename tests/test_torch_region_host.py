"""Parity tests: the host path's region functions of the port
(m3t_tpu_torch.ops.region_fn: calculate_correspondences, calculate_gradient_and_hessian,
add_line_pixel_colors, dynamic_region_distance, over a leading batch of bodies) against
m3t_tpu.ops.region_fn, one body at a time, on the CPU.

Inputs: 100 points of the committed bench sphere model's closest view, two bodies 0.6 m
from a 160x120 camera with jittered poses, a rendered noisy colour frame, histograms
built by the JAX package at the first pose, and a depth frame with a wall 0.45 m away
over the columns left of u = 75 (over the sphere's left side) for the measured
occlusions, at both ends of handle_occlusions; region checking reads a focused
silhouette (region 3, the sphere's disk, a foreign region 5 over its right side).
Validity masks, sampled bins and histogram counts are exact; float32 line values within
atol 1e-4; gradients and Hessians within 1e-5 of their largest entry.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu import region_modality as jregion_modality
from m3t_tpu.ops import histogram as jhist
from m3t_tpu.ops import region_fn as jrfn
from m3t_tpu_torch.ops import depth_fn as tdn
from m3t_tpu_torch.ops import region_fn as trfn
from tests import fixtures

REPO = Path(__file__).resolve().parent.parent
NPZ = REPO / "m3t_tpu_torch" / "data" / "bench_sphere_region_model.npz"
N_LINES, N_BINS, DEPTH_SCALE = 100, 16, 0.001
FOCUSED, FOCUSED_SCALE = 200, 2.0
INTR = fixtures.test_intrinsics(160, 120)
F32 = tuple(np.float32(x) for x in (INTR.fu, INTR.fv, INTR.ppu, INTR.ppv))
CFG_KW = dict(n_lines_max=N_LINES, n_histogram_bins=N_BINS, min_n_unoccluded_lines=5)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def scene():
    with np.load(NPZ) as f:
        model = {k: f[k] for k in f.files}
    rng = np.random.default_rng(3)
    pose0 = fixtures.look_at_pose(0.6)
    poses = np.stack([pose0, pose0]).astype(np.float32)
    poses[:, :2, 3] += rng.uniform(-0.004, 0.004, (2, 2)).astype(np.float32)
    view = int(np.argmax(model["orientations"] @ np.array([0.0, 0.0, 1.0])))
    body = fixtures.sphere_body("host_sphere", radius=0.06, n_subdiv=2)
    frame = fixtures.render_synthetic_color_frame(body, INTR, pose0,
                                                  noise_rng=np.random.default_rng(4))
    depth = fixtures.render_synthetic_depth_frame(body, INTR, pose0, DEPTH_SCALE)
    depth[:, :75] = 450
    points = jrfn.ViewPoints(*(jnp.asarray(a) for a in (
        model["centers"][view, :N_LINES], model["normals"][view, :N_LINES],
        model["foreground_distances"][view, :N_LINES],
        model["background_distances"][view, :N_LINES],
        model["depth_offsets"][view, :N_LINES, 5], model["depth_offsets"][view, :N_LINES, 5])))
    cfg = jrfn.RegionConfig(**CFG_KW)
    n = N_BINS ** 3
    mem_f, mem_b = jrfn.add_line_pixel_colors(
        cfg, points, N_LINES, pose0, jnp.asarray(frame), jnp.zeros(n), jnp.zeros(n),
        *F32, INTR.width, INTR.height, False)
    uniform = jnp.full((n,), 1.0 / n, jnp.float32)
    hist = [np.asarray(jhist.calculate_histogram(uniform, m, 1.0)) for m in (mem_f, mem_b)]
    # The focused silhouette: region 3 where the sphere's disk is, region 5 over its
    # right side, corner 50 px up and left of the projected centre, at scale 2.
    cu = INTR.fu * pose0[0, 3] / pose0[2, 3] + INTR.ppu
    cv = INTR.fv * pose0[1, 3] / pose0[2, 3] + INTR.ppv
    corner = (np.float32(cu - 50.0), np.float32(cv - 50.0))
    yy, xx = np.mgrid[:FOCUSED, :FOCUSED]
    u = corner[0] + (xx + 0.5) / FOCUSED_SCALE
    v = corner[1] + (yy + 0.5) / FOCUSED_SCALE
    radius = INTR.fu * 0.06 / 0.6
    sil = np.where((u - cu) ** 2 + (v - cv) ** 2 < radius ** 2, 3, 0).astype(np.int32)
    sil[(u > cu + 8) & (np.abs(v - cv) < 10)] = 5
    return dict(points=points, poses=poses, frame=frame, depth=depth, hist=hist, sil=sil,
                corner=corner)


def _jax_inputs(scene, b, measured, region_check, visible=True):
    meas = chk = None
    if measured:
        meas = jrfn.MeasuredOcclusionInputs(
            depth_image=jnp.asarray(scene["depth"]),
            body2depth_camera_pose=jnp.asarray(scene["poses"][b]),
            fu=F32[0], fv=F32[1], ppu=F32[2], ppv=F32[3],
            depth_scale=np.float32(DEPTH_SCALE))
    if region_check:
        chk = jrfn.RegionCheckInputs(
            silhouette=jnp.asarray(scene["sil"]), corner_u=scene["corner"][0],
            corner_v=scene["corner"][1], scale=np.float32(FOCUSED_SCALE),
            region_id=np.int32(3), body_visible=jnp.asarray(visible))
    return meas, chk


def _torch_inputs(scene, measured, region_check, visible=True):
    meas = chk = None
    if measured:
        meas = trfn.MeasuredOcclusionInputs(
            depth_image=_t(np.stack([scene["depth"]] * 2)),
            body2depth_camera_pose=_t(scene["poses"]), fu=float(F32[0]), fv=float(F32[1]),
            ppu=float(F32[2]), ppv=float(F32[3]), depth_scale=float(np.float32(DEPTH_SCALE)))
    if region_check:
        chk = trfn.RegionCheckInputs(
            silhouette=_t(np.stack([scene["sil"]] * 2)), corner_u=_t([scene["corner"][0]] * 2),
            corner_v=_t([scene["corner"][1]] * 2), scale=_t([np.float32(FOCUSED_SCALE)] * 2),
            region_id=_t(np.array([3, 3], np.int32)), body_visible=_t([visible] * 2))
    return meas, chk


def _torch_points(points):
    return trfn.ViewPoints(*(_t(np.stack([np.asarray(a)] * 2)) for a in points))


def _assert_lines_close(got, want, b):
    for name in jrfn.DataLines._fields:
        g, w = getattr(got, name)[b].numpy(), np.asarray(getattr(want, name))
        if name == "valid":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("scale", [1, 3])
@pytest.mark.parametrize("measured,handle,region_check", [
    (False, False, False), (True, False, False), (True, True, False), (True, True, True)])
def test_calculate_correspondences_matches_jax(scene, scale, measured, handle, region_check):
    cfg_j, cfg_t = jrfn.RegionConfig(**CFG_KW), trfn.RegionConfig(**CFG_KW)
    meas_t, chk_t = _torch_inputs(scene, measured, region_check)
    hist_t = [_t(np.stack([h, h])) for h in scene["hist"]]
    got = trfn.calculate_correspondences(
        cfg_t, scale, _torch_points(scene["points"]), N_LINES, _t(scene["poses"]),
        _t(np.stack([scene["frame"]] * 2)), *hist_t, *map(float, F32), INTR.width,
        INTR.height, handle, measured_occlusion=meas_t, region_check=chk_t)
    n_valid = []
    for b in range(2):
        meas_j, chk_j = _jax_inputs(scene, b, measured, region_check)
        want = jrfn.calculate_correspondences(
            cfg_j, scale, scene["points"], N_LINES, scene["poses"][b],
            jnp.asarray(scene["frame"]), *scene["hist"], *F32, INTR.width, INTR.height,
            jnp.asarray(handle), measured_occlusion=meas_j, region_check=chk_j)
        _assert_lines_close(got, want, b)
        n_valid.append(int(got.valid[b].sum()))
    assert min(n_valid) > 10, n_valid


def test_scale_quotient_matches_jitted_jax(scene, monkeypatch):
    """normal_component_to_scale = |normal_p| / scale at scale 3 (a static argument of
    the JAX modality's jit), bit for bit as jitted JAX computes it: XLA multiplies by the
    float32 reciprocal of the constant; a plain division differs on some lines."""
    cfg_j, cfg_t = jrfn.RegionConfig(**CFG_KW), trfn.RegionConfig(**CFG_KW)
    want = [jregion_modality._correspondences_jit(
        cfg_j, 3, INTR.width, INTR.height, False, False, False, scene["points"],
        jnp.int32(N_LINES), jnp.asarray(scene["poses"][b]), jnp.asarray(scene["frame"]),
        *scene["hist"], F32, jnp.asarray(True), None, None, None,
        *cfg_j.function_lookups()) for b in range(2)]

    def got():
        return trfn.calculate_correspondences(
            cfg_t, 3, _torch_points(scene["points"]), N_LINES, _t(scene["poses"]),
            _t(np.stack([scene["frame"]] * 2)), *(_t(np.stack([h, h])) for h in scene["hist"]),
            *map(float, F32), INTR.width, INTR.height, True)

    lines = got()
    # Jitted JAX may round the normalized normals another way (XLA's rsqrt): the lines
    # whose normals are the same bits on both sides (|normal_p| is the larger of the two).
    same = np.stack([(lines.normal_u[b].numpy() == np.asarray(want[b].normal_u))
                     & (lines.normal_v[b].numpy() == np.asarray(want[b].normal_v))
                     for b in range(2)])
    want = np.stack([np.asarray(w.normal_component_to_scale) for w in want])
    assert same.sum() > N_LINES
    np.testing.assert_array_equal(lines.normal_component_to_scale.numpy()[same], want[same])
    monkeypatch.setattr(tdn, "div_const", lambda x, n: x / n)
    assert (got().normal_component_to_scale.numpy()[same] != want[same]).any()


def test_occlusions_and_region_check_drop_lines(scene):
    """The wall and the foreign region take lines away (so the parity cases above hold
    the masks where they matter)."""
    cfg = trfn.RegionConfig(**CFG_KW)
    counts = {}
    for label, measured, handle, region_check in (
            ("plain", False, False, False), ("measured", True, True, False),
            ("checked", False, False, True)):
        meas, chk = _torch_inputs(scene, measured, region_check)
        lines = trfn.calculate_correspondences(
            cfg, 1, _torch_points(scene["points"]), N_LINES, _t(scene["poses"]),
            _t(np.stack([scene["frame"]] * 2)), *(_t(np.stack([h, h])) for h in scene["hist"]),
            *map(float, F32), INTR.width, INTR.height, handle, measured_occlusion=meas,
            region_check=chk)
        counts[label] = int(lines.valid.sum())
    assert counts["measured"] < counts["plain"] and counts["checked"] < counts["plain"], counts


@pytest.mark.parametrize("global_iteration", [True, False])
def test_calculate_gradient_and_hessian_matches_jax(scene, global_iteration):
    cfg_j, cfg_t = jrfn.RegionConfig(**CFG_KW), trfn.RegionConfig(**CFG_KW)
    lines_j = [jrfn.calculate_correspondences(
        cfg_j, 2, scene["points"], N_LINES, scene["poses"][b], jnp.asarray(scene["frame"]),
        *scene["hist"], *F32, INTR.width, INTR.height, jnp.asarray(True)) for b in range(2)]
    lines_t = trfn.DataLines(*(_t(np.stack([np.asarray(getattr(lj, name)) for lj in lines_j]))
                               for name in jrfn.DataLines._fields))
    # The pose the terms are taken at moved from the one the lines were found at.
    poses = scene["poses"].copy()
    poses[:, :3, 3] += np.float32([0.001, -0.0005, 0.002])
    grad_t, hess_t = trfn.calculate_gradient_and_hessian(
        cfg_t, lines_t, _t(poses), *map(float, F32), 3.5, global_iteration)
    for b in range(2):
        grad_j, hess_j = jrfn.calculate_gradient_and_hessian(
            cfg_j, lines_j[b], poses[b], *F32, 3.5, global_iteration)
        for g, w in ((grad_t[b], grad_j), (hess_t[b], hess_j)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("measured,handle,region_check", [
    (False, True, False), (True, False, False), (True, True, False), (False, True, True)])
def test_add_line_pixel_colors_matches_jax(scene, measured, handle, region_check):
    cfg_j, cfg_t = jrfn.RegionConfig(**CFG_KW), trfn.RegionConfig(**CFG_KW)
    n = N_BINS ** 3
    start = np.random.default_rng(8).integers(0, 3, (2, 2, n)).astype(np.float32)
    meas_t, chk_t = _torch_inputs(scene, measured, region_check)
    got = trfn.add_line_pixel_colors(
        cfg_t, _torch_points(scene["points"]), N_LINES, _t(scene["poses"]),
        _t(np.stack([scene["frame"]] * 2)), _t(start[0]), _t(start[1]), *map(float, F32),
        INTR.width, INTR.height, handle, measured_occlusion=meas_t, region_check=chk_t)
    for b in range(2):
        meas_j, chk_j = _jax_inputs(scene, b, measured, region_check)
        want = jrfn.add_line_pixel_colors(
            cfg_j, scene["points"], N_LINES, scene["poses"][b], jnp.asarray(scene["frame"]),
            jnp.asarray(start[0, b]), jnp.asarray(start[1, b]), *F32, INTR.width,
            INTR.height, jnp.asarray(handle), measured_occlusion=meas_j, region_check=chk_j)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
        assert float(got[0][b].sum() - start[0, b].sum()) > 100


@pytest.mark.parametrize("visible", [True, False])
def test_dynamic_region_distance_matches_jax(scene, visible):
    cfg_j, cfg_t = jrfn.RegionConfig(**CFG_KW), trfn.RegionConfig(**CFG_KW)
    _, chk_t = _torch_inputs(scene, False, True, visible)
    geo = [jrfn._project_lines(scene["points"], scene["poses"][b], *F32) for b in range(2)]
    cu, cv, nu, nv = (_t(np.stack([np.asarray(g[i]) for g in geo])) for i in (2, 3, 4, 5))
    got = trfn.dynamic_region_distance(cfg_t, cu, cv, nu, nv, chk_t, FOCUSED)
    limited = 0
    for b in range(2):
        _, chk_j = _jax_inputs(scene, b, False, True, visible)
        want = jrfn.dynamic_region_distance(cfg_j, *geo[b][2:], chk_j, FOCUSED)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
            limited += int((np.asarray(w) < cfg_j.max_considered_line_length).sum())
    assert (limited > 0) == visible
