"""Parity tests: m3t_tpu_torch.ops.depth_fast and depth_fn (PyTorch twins on the CPU)
against the JAX package's m3t_tpu.ops.depth_fast (Pallas in interpret mode on the CPU)
and depth_fn (under vmap).

Inputs follow tests/test_depth_fast.py: random 160x120 uint16 depth images, 4 bodies of
P=64 random points, crop 128, made with numpy from a seed and handed to both sides; the
JAX side gathers its int32 crops, the port reads the frames.  Corners, window samples,
masks and validity must match exactly; correspondences to atol 1e-6 and
gradients/Hessians to rtol 1e-5 (float32 sums taken in another order).  The kernel
itself is held against its twin on the card by tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu.ops import depth_fast as jdf
from m3t_tpu.ops import depth_fn as jdn
from m3t_tpu_torch.ops import depth_fast as tdf
from m3t_tpu_torch.ops import depth_fn as tdn

B, P, H, W, C = 4, 64, 120, 160, 128
FU = FV = 150.0
PPU, PPV = W / 2 - 0.5, H / 2 - 0.5
CD = 0.03
DEPTH_SCALE = 0.001


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(3)
    depth = rng.integers(300, 900, size=(B, H, W)).astype(np.uint16)
    # Near patches occlude some points' windows, so the occlusion masks are mixed.
    depth[:, 40:60, 50:90] = rng.integers(200, 400, size=(B, 20, 40)).astype(np.uint16)
    centers = rng.normal(scale=0.04, size=(B, P, 3)).astype(np.float32)
    # A few points near the image border, whose windows leave the 128-pixel crop.
    centers[:, :8, 0] = np.where(np.arange(8) % 2, 0.21, -0.21)
    normals = rng.normal(size=(B, P, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    offsets = rng.uniform(0.1, 0.3, size=(B, P)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    poses[:, 0, 3] = rng.uniform(-0.02, 0.02, B)
    poses[:, 1, 3] = rng.uniform(-0.02, 0.02, B)
    poses[:, 2, 3] = 0.5
    return dict(depth=depth, centers=centers, normals=normals, offsets=offsets,
                poses=poses)


def _jax_crops(depth, poses, crop=C, ppu=PPU, ppv=PPV):
    return jdf.depth_crops(jnp.asarray(depth), jnp.asarray(poses), FU, FV, ppu, ppv, crop)


def _corners(depth, poses, crop=C, ppu=PPU, ppv=PPV):
    return tdf.depth_corners(_t(depth), _t(poses), FU, FV, ppu, ppv, crop)


def _configs(use_depth_scaling):
    return (jdn.DepthConfig(n_points_max=P, use_depth_scaling=use_depth_scaling),
            tdn.DepthConfig(n_points_max=P, use_depth_scaling=use_depth_scaling))


def _presampled_pair(depth, centers, poses, use_depth_scaling, occlusion, crop=C,
                     ppu=PPU, ppv=PPV, radius=0.01, cd=CD):
    """(JAX, port) results of presample_windows (occlusion False) or
    presample_occlusion_windows (True) on the same frames and points."""
    h, w = depth.shape[1:]
    cropT, cu, cv = _jax_crops(depth, poses, crop, ppu, ppv)
    tcu, tcv = _corners(depth, poses, crop, ppu, ppv)
    jargs = (jnp.asarray(centers), jnp.asarray(poses), cropT, cu, cv, crop, FU, FV, ppu,
             ppv)
    targs = (_t(centers), _t(poses), _t(depth), tcu, tcv, crop, FU, FV, ppu, ppv)
    if occlusion:
        return (jdf.presample_occlusion_windows(radius, use_depth_scaling, *jargs, w, h),
                tdf.presample_occlusion_windows(radius, use_depth_scaling, *targs, w, h))
    jcfg, tcfg = _configs(use_depth_scaling)
    return (jdf.presample_windows(jcfg, cd, *jargs),
            tdf.presample_windows(tcfg, cd, *targs))


def _assert_same(want, got):
    (d, mask), (td, tmask) = want, got
    assert td.dtype == torch.float32 and td.shape == d.shape
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(td.numpy(), np.asarray(d))


def test_depth_corners_match(inputs):
    _, cu, cv = _jax_crops(inputs["depth"], inputs["poses"])
    tcu, tcv = _corners(inputs["depth"], inputs["poses"])
    assert tcu.dtype == torch.int32 and tcu.shape == (B,)
    np.testing.assert_array_equal(tcu.numpy(), np.asarray(cu))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(cv))


def test_depth_crops_pad_small_images_and_read_uint16_exactly():
    """Values above 32767 survive the int16 gather; outside a frame smaller than the
    crop the windows read 0, as from the JAX package's zero-padded crop."""
    depth = np.full((2, 20, 30), 65535, np.uint16)
    depth[1, 3, 4] = 40000
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 0.5
    cu, cv = tdf.depth_corners(_t(depth), _t(poses), FU, FV, 14.5, 9.5, 32)
    assert (cu.tolist(), cv.tolist()) == ([0, 0], [0, 0])
    u_min = torch.tensor([[0, 4, 20], [2, 26, 0]], dtype=torch.int32)
    v_min = torch.tensor([[0, 3, 15], [1, 0, 18]], dtype=torch.int32)
    stride = torch.tensor([[1, 3, 4], [1, 2, 5]], dtype=torch.int32)
    got = tdf.sample_windows(_t(depth), u_min, v_min, stride, cu, cv, 32, 4).numpy()
    padded = np.zeros((2, 32, 32), np.float32)
    padded[:, :20, :30] = depth
    for b in range(2):
        for p in range(3):
            k = np.arange(4)
            rows = np.clip(v_min[b, p].item() + k * stride[b, p].item(), 0, 31)
            cols = np.clip(u_min[b, p].item() + k * stride[b, p].item(), 0, 31)
            np.testing.assert_array_equal(got[b, p], padded[b][np.ix_(rows, cols)])
    assert got[1, 0, 2, 2] == 40000 and (got == 65535).any() and (got == 0).any()


@pytest.mark.parametrize("use_depth_scaling", [False, True])
def test_presample_windows_match(inputs, use_depth_scaling):
    want, got = _presampled_pair(inputs["depth"], inputs["centers"], inputs["poses"],
                                 use_depth_scaling, occlusion=False)
    _assert_same(want, got)
    assert 0 < got[1].numpy().mean() < 1, "the crop-coverage mask must be exercised"


@pytest.mark.parametrize("use_depth_scaling", [False, True])
def test_presample_occlusion_windows_match(inputs, use_depth_scaling):
    _assert_same(*_presampled_pair(inputs["depth"], inputs["centers"], inputs["poses"],
                                   use_depth_scaling, occlusion=True))


@pytest.mark.parametrize("k", [11, 6, 3])
def test_sample_windows_plain_matches_pallas(inputs, k):
    """The twin against the JAX window fetch (the Pallas kernel in interpret mode on the
    int32 crops, then the slice, transpose and cast), on the window geometry of the
    correspondence search."""
    cropT, cu, cv = _jax_crops(inputs["depth"], inputs["poses"])
    tcu, tcv = _corners(inputs["depth"], inputs["poses"])
    cfg = tdn.DepthConfig(n_points_max=P)
    u_min, v_min, stride, _ = tdf.correspondence_windows(
        cfg, (k - 1) * cfg.stride_length, _t(inputs["centers"]), _t(inputs["poses"]),
        FU, FV, PPU, PPV)
    want, _ = jdf._fetch_strided_windows(*(jnp.asarray(x.numpy())
                                           for x in (u_min, v_min, stride)),
                                         cu, cv, cropT, C, k)
    got = tdf.sample_windows_plain(_t(inputs["depth"]), u_min, v_min, stride, tcu, tcv,
                                   C, k)
    assert got.dtype == torch.float32 and got.shape == (B, P, k, k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("occlusion", [False, True])
def test_presampled_windows_leaving_the_crop_on_every_side_match(occlusion):
    """Points on a ring around the body centre whose windows cross all four edges of the
    128-pixel crop inside a 300x300 frame: values and masks equal the JAX package's."""
    rng = np.random.default_rng(8)
    depth = rng.integers(300, 60000, size=(2, 300, 300)).astype(np.uint16)
    angle = rng.uniform(0, 2 * np.pi, (2, 48))
    radius = rng.uniform(0.17, 0.25, (2, 48))
    centers = np.stack([radius * np.cos(angle), radius * np.sin(angle),
                        rng.normal(scale=0.01, size=(2, 48))], -1).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :2, 3] = [[0.01, -0.02], [-0.03, 0.015]]
    poses[:, 2, 3] = 0.5
    want, got = _presampled_pair(depth, centers, poses, False, occlusion, ppu=149.5,
                                 ppv=149.5, radius=0.03)
    _assert_same(want, got)
    cu, cv = _corners(depth, poses, C, 149.5, 149.5)
    _, mask = got
    # Every side of the crop cuts some window: its first or last row or column.
    assert not mask[:, :, :, 0].all() and not mask[:, :, :, -1].all()
    assert not mask[:, :, 0, :].all() and not mask[:, :, -1, :].all()
    assert mask.any() and (cu > 0).all() and (cv > 0).all()


@pytest.mark.parametrize("use_depth_scaling", [False, True])
def test_presampled_windows_on_a_frame_smaller_than_the_crop_match(use_depth_scaling):
    """A 100x90 frame under the 128-pixel crop: the correspondence and measured-occlusion
    windows read 0 beyond the frame, as from the JAX package's zero-padded crop, and
    some leave the crop."""
    rng = np.random.default_rng(9)
    depth = rng.integers(32000, 65535, size=(3, 90, 100)).astype(np.uint16)
    centers = rng.normal(scale=0.05, size=(3, 24, 3)).astype(np.float32)
    centers[:, :8, 0] = [[0.3, -0.3, 0.15, -0.15, 0.0, 0.0, 0.3, 0.15]] * 3
    centers[:, :8, 1] = [[0.0, 0.0, 0.1, -0.1, 0.3, -0.3, 0.3, 0.15]] * 3
    poses = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    poses[:, 2, 3] = 0.5
    for occlusion in (False, True):
        want, got = _presampled_pair(depth, centers, poses, use_depth_scaling, occlusion,
                                     ppu=49.5, ppv=44.5)
        _assert_same(want, got)
        d, mask = got
        assert (d == 0).any() and (d[mask] > 0).any() and not mask.all()


def test_sample_windows_expanded_frame_matches_materialised(inputs):
    """One frame shared by the batch as an expanded view (batch stride 0) gives what
    its materialised copy gives."""
    frame = _t(inputs["depth"][1])
    shared = frame.expand(B, H, W)
    assert shared.stride(0) == 0
    cu, cv = tdf.depth_corners(shared, _t(inputs["poses"]), FU, FV, PPU, PPV, C)
    u_min, v_min, stride, k = tdf.correspondence_windows(
        tdn.DepthConfig(n_points_max=P), 0.05, _t(inputs["centers"]), _t(inputs["poses"]),
        FU, FV, PPU, PPV)
    args = (u_min, v_min, stride, cu, cv, C, k)
    assert torch.equal(tdf.sample_windows(shared, *args),
                       tdf.sample_windows(shared.contiguous(), *args))


def _jax_correspondences(inp, jcfg, measure, presampled, cd=CD, jit=False):
    cropT, cu, cv = _jax_crops(inp["depth"], inp["poses"])
    pre = mpre = None
    if presampled:
        pre = jdf.presample_windows(jcfg, CD, jnp.asarray(inp["centers"]),
                                    jnp.asarray(inp["poses"]), cropT, cu, cv, C,
                                    FU, FV, PPU, PPV)
        mpre = jdf.presample_occlusion_windows(
            jcfg.measured_occlusion_radius, jcfg.use_depth_scaling,
            jnp.asarray(inp["centers"]), jnp.asarray(inp["poses"]), cropT, cu, cv, C,
            FU, FV, PPU, PPV, W, H)
    points = jdn.DepthViewPoints(jnp.asarray(inp["centers"]), jnp.asarray(inp["normals"]),
                                 jnp.asarray(inp["offsets"]), jnp.asarray(inp["offsets"]))
    batched = jax.vmap(
        lambda pts, pose, img, pr, mp: jdn.calculate_correspondences(
            jcfg, cd, pts, jnp.int32(P - 3), pose, img, FU, FV, PPU, PPV, W, H,
            jnp.float32(DEPTH_SCALE), jnp.asarray(True), measure_occlusions=measure,
            presampled=pr, measured_presampled=mp))
    return (jax.jit(batched) if jit else batched)(
        points, jnp.asarray(inp["poses"]), jnp.asarray(inp["depth"]), pre, mpre)


def _torch_correspondences(inp, tcfg, measure, presampled, cd=CD):
    cu, cv = _corners(inp["depth"], inp["poses"])
    centers, poses, depth = _t(inp["centers"]), _t(inp["poses"]), _t(inp["depth"])
    pre = mpre = None
    if presampled:
        pre = tdf.presample_windows(tcfg, CD, centers, poses, depth, cu, cv, C,
                                    FU, FV, PPU, PPV)
        mpre = tdf.presample_occlusion_windows(
            tcfg.measured_occlusion_radius, tcfg.use_depth_scaling, centers, poses, depth,
            cu, cv, C, FU, FV, PPU, PPV, W, H)
    points = tdn.DepthViewPoints(centers, _t(inp["normals"]), _t(inp["offsets"]),
                                 _t(inp["offsets"]))
    return tdn.calculate_correspondences(
        tcfg, cd, points, P - 3, poses, depth, FU, FV, PPU, PPV, W, H,
        DEPTH_SCALE, torch.ones(B, dtype=torch.bool), measure_occlusions=measure,
        presampled=pre, measured_presampled=mpre)


@pytest.mark.parametrize("measure,presampled,use_depth_scaling", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, False), (True, True, True)])
def test_calculate_correspondences_match(inputs, measure, presampled, use_depth_scaling):
    jcfg, tcfg = _configs(use_depth_scaling)
    want = _jax_correspondences(inputs, jcfg, measure, presampled)
    got = _torch_correspondences(inputs, tcfg, measure, presampled)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert 20 < valid.sum() < valid.size
    np.testing.assert_allclose(got.correspondence_center_f_camera.numpy(),
                               np.asarray(want.correspondence_center_f_camera),
                               rtol=0, atol=1e-6)


def test_correspondence_windows_on_a_whole_stride_match_jitted_jax(inputs):
    """With depth scaling the search window's diameter 2 * considered_distance * fu is
    free of z: 60 px at 0.2 m and fu 150, over int(0.2 / 0.032 + 0.5) = 6 strides, so
    its stride 60 / 6 + 1 truncates on an integer.  Jitted JAX (every cycle and modality
    of the JAX package) divides by the constant 6 as a product with its float32
    reciprocal, which gives 11 for every point; a true quotient gives 10 where z * (fu /
    z) rounds below 60."""
    # A surface within the windows' depth range (z +- 0.2 z) of most points.
    depth = np.random.default_rng(5).integers(480, 520, size=(B, H, W)).astype(np.uint16)
    inp = dict(inputs, depth=depth)
    jcfg = jdn.DepthConfig(n_points_max=P, use_depth_scaling=True, stride_length=0.032)
    tcfg = tdn.DepthConfig(n_points_max=P, use_depth_scaling=True, stride_length=0.032)
    want = _jax_correspondences(inp, jcfg, False, False, cd=0.2, jit=True)
    got = _torch_correspondences(inp, tcfg, False, False, cd=0.2)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() > valid.size // 4
    np.testing.assert_allclose(got.correspondence_center_f_camera.numpy(),
                               np.asarray(want.correspondence_center_f_camera),
                               rtol=0, atol=1e-6)


def test_measured_occlusions_drop_points(inputs):
    """The occlusion patch must remove some points, and the two-pass fallback must
    restore them when too few survive or occlusion handling is off."""
    _, tcfg = _configs(False)
    base = _torch_correspondences(inputs, tcfg, False, True).valid
    occl = _torch_correspondences(inputs, tcfg, True, True).valid
    assert (occl <= base).all() and occl.sum() < base.sum()
    strict = _torch_correspondences(
        inputs, tcfg._replace(min_n_unoccluded_points=P), True, True).valid
    assert torch.equal(strict, base)


def test_gradient_and_hessian_match(inputs):
    jcfg, tcfg = _configs(False)
    want = _jax_correspondences(inputs, jcfg, True, True)
    got = _torch_correspondences(inputs, tcfg, True, True)
    jg, jh = jax.vmap(lambda pts, pose: jdn.calculate_gradient_and_hessian(pts, pose, 0.03))(
        want, jnp.asarray(inputs["poses"]))
    tg, th = tdn.calculate_gradient_and_hessian(got, _t(inputs["poses"]), 0.03)
    assert tg.shape == (B, 6) and th.shape == (B, 6, 6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jh)).max())
