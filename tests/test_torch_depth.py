"""Parity tests: m3t_tpu_torch.ops.depth_fast and depth_fn (PyTorch twins on the CPU)
against the JAX package's m3t_tpu.ops.depth_fast (Pallas in interpret mode on the CPU)
and depth_fn (under vmap).

Inputs follow tests/test_depth_fast.py: random 160x120 uint16 depth images, 4 bodies of
P=64 random points, crop 128, made with numpy from a seed and handed to both sides.
Crops, window samples, masks and validity must match exactly; correspondences to atol
1e-6 and gradients/Hessians to rtol 1e-5 (float32 sums taken in another order).  The
kernel itself is held against its twin on the card by tests/test_torch_kernels.py.
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


def _crops(inp):
    jcrop = jdf.depth_crops(jnp.asarray(inp["depth"]), jnp.asarray(inp["poses"]),
                            FU, FV, PPU, PPV, C)
    tcrop = tdf.depth_crops(_t(inp["depth"]), _t(inp["poses"]), FU, FV, PPU, PPV, C)
    return jcrop, tcrop


def _configs(use_depth_scaling):
    return (jdn.DepthConfig(n_points_max=P, use_depth_scaling=use_depth_scaling),
            tdn.DepthConfig(n_points_max=P, use_depth_scaling=use_depth_scaling))


def test_depth_crops_match(inputs):
    (cropT, cu, cv), (crop, tcu, tcv) = _crops(inputs)
    assert crop.dtype == torch.int32 and crop.shape == (B, C, C)
    np.testing.assert_array_equal(crop.numpy(), np.swapaxes(np.asarray(cropT), 1, 2))
    np.testing.assert_array_equal(tcu.numpy(), np.asarray(cu))
    np.testing.assert_array_equal(tcv.numpy(), np.asarray(cv))


def test_depth_crops_pad_small_images_and_read_uint16_exactly():
    """Values above 32767 survive the int16 gather; images smaller than the crop are
    zero-padded."""
    depth = np.full((2, 20, 30), 65535, np.uint16)
    depth[1, 3, 4] = 40000
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, 2, 3] = 0.5
    crop, cu, cv = tdf.depth_crops(_t(depth), _t(poses), FU, FV, 14.5, 9.5, 32)
    assert (cu.tolist(), cv.tolist()) == ([0, 0], [0, 0])
    want = np.zeros((2, 32, 32), np.int32)
    want[:, :20, :30] = depth
    np.testing.assert_array_equal(crop.numpy(), want)


@pytest.mark.parametrize("use_depth_scaling", [False, True])
def test_presample_windows_match(inputs, use_depth_scaling):
    jcfg, tcfg = _configs(use_depth_scaling)
    (cropT, cu, cv), (crop, tcu, tcv) = _crops(inputs)
    d, in_crop = jdf.presample_windows(jcfg, CD, jnp.asarray(inputs["centers"]),
                                       jnp.asarray(inputs["poses"]), cropT, cu, cv, C,
                                       FU, FV, PPU, PPV)
    td, tin = tdf.presample_windows(tcfg, CD, _t(inputs["centers"]), _t(inputs["poses"]),
                                    crop, tcu, tcv, C, FU, FV, PPU, PPV)
    assert td.dtype == torch.float32 and td.shape == d.shape
    np.testing.assert_array_equal(tin.numpy(), np.asarray(in_crop))
    np.testing.assert_array_equal(td.numpy(), np.asarray(d))
    assert 0 < tin.numpy().mean() < 1, "the crop-coverage mask must be exercised"


@pytest.mark.parametrize("use_depth_scaling", [False, True])
def test_presample_occlusion_windows_match(inputs, use_depth_scaling):
    (cropT, cu, cv), (crop, tcu, tcv) = _crops(inputs)
    d, ok = jdf.presample_occlusion_windows(
        0.01, use_depth_scaling, jnp.asarray(inputs["centers"]),
        jnp.asarray(inputs["poses"]), cropT, cu, cv, C, FU, FV, PPU, PPV, W, H)
    td, tok = tdf.presample_occlusion_windows(
        0.01, use_depth_scaling, _t(inputs["centers"]), _t(inputs["poses"]), crop, tcu,
        tcv, C, FU, FV, PPU, PPV, W, H)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(td.numpy(), np.asarray(d))


@pytest.mark.parametrize("k", [11, 6, 3])
def test_sample_windows_plain_matches_pallas(inputs, k):
    """The twin against the JAX kernel in Pallas interpret mode, padded lanes included,
    on the window parameters of the correspondence search."""
    (cropT, _, _), (crop, tcu, tcv) = _crops(inputs)
    cfg = tdn.DepthConfig(n_points_max=P)
    u_min, v_min, stride, _ = tdf.correspondence_windows(
        cfg, (k - 1) * cfg.stride_length, _t(inputs["centers"]), _t(inputs["poses"]),
        FU, FV, PPU, PPV)
    params, _ = tdf.window_params(u_min, v_min, stride, tcu, tcv, k)
    kp = tdf.round_up(k, 8)
    want = np.asarray(jdf.sample_windows(jnp.asarray(params.numpy()), cropT, kp=kp))
    got = tdf.sample_windows_plain(params, crop, kp)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_correspondences(inp, jcfg, measure, presampled):
    (cropT, cu, cv), _ = _crops(inp)
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
    return jax.vmap(
        lambda pts, pose, img, pr, mp: jdn.calculate_correspondences(
            jcfg, CD, pts, jnp.int32(P - 3), pose, img, FU, FV, PPU, PPV, W, H,
            jnp.float32(DEPTH_SCALE), jnp.asarray(True), measure_occlusions=measure,
            presampled=pr, measured_presampled=mp)
    )(points, jnp.asarray(inp["poses"]), jnp.asarray(inp["depth"]), pre, mpre)


def _torch_correspondences(inp, tcfg, measure, presampled):
    _, (crop, cu, cv) = _crops(inp)
    centers, poses = _t(inp["centers"]), _t(inp["poses"])
    pre = mpre = None
    if presampled:
        pre = tdf.presample_windows(tcfg, CD, centers, poses, crop, cu, cv, C,
                                    FU, FV, PPU, PPV)
        mpre = tdf.presample_occlusion_windows(
            tcfg.measured_occlusion_radius, tcfg.use_depth_scaling, centers, poses, crop,
            cu, cv, C, FU, FV, PPU, PPV, W, H)
    points = tdn.DepthViewPoints(centers, _t(inp["normals"]), _t(inp["offsets"]),
                                 _t(inp["offsets"]))
    return tdn.calculate_correspondences(
        tcfg, CD, points, P - 3, poses, _t(inp["depth"]), FU, FV, PPU, PPV, W, H,
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
