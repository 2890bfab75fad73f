"""Parity tests: the port's TextureModality (texture_modality.py, utils/features.py)
against the JAX package's, on the CPU.

The setup is tests/test_texture_fused.py's: a sphere (radius 0.08 m) with a colour per
face, 0.5 m from a 320x240 camera, moving 1.5 mm along x and 1 mm along y per frame;
both packages read the same frames, and their bodies carry the same ids.  The
keyframe is built at frame 0 (StartModality), frame 1 is matched against it; keypoints,
descriptors and matched keypoints must be equal, keyframe points within 1e-6 m
(they unproject rendered depth, which may differ in its last bit), and the Gauss-Newton
terms within rtol 1e-5.  The occluded case adds a cube in front of the sphere, with modeled
occlusions through a FocusedBasicDepthRenderer and measured ones through a depth camera.
"""

import cv2
import numpy as np
import pytest
import torch

from m3t_tpu import camera as jcamera
from m3t_tpu import fused_serve as jfused_serve
from m3t_tpu import link as jlink
from m3t_tpu import optimizer as joptimizer
from m3t_tpu import renderer as jrenderer
from m3t_tpu import tracker as jtracker
from m3t_tpu.ops.raster import rasterize_np
from m3t_tpu.renderer_geometry import RendererGeometry as JRendererGeometry
from m3t_tpu.texture_modality import TextureModality as JTextureModality
from m3t_tpu.utils import features as jfeatures
from m3t_tpu_torch import camera as tcamera
from m3t_tpu_torch import fused_serve as tfused_serve
from m3t_tpu_torch import link as tlink
from m3t_tpu_torch import optimizer as toptimizer
from m3t_tpu_torch import pipeline as tpipeline
from m3t_tpu_torch import renderer as trenderer
from m3t_tpu_torch import tracker as ttracker
from m3t_tpu_torch.common import np_pose
from m3t_tpu_torch.ops import texture_fn as ttexture_fn
from m3t_tpu_torch.renderer_geometry import RendererGeometry as TRendererGeometry
from m3t_tpu_torch.texture_modality import TextureModality as TTextureModality
from m3t_tpu_torch.utils import features as tfeatures
from m3t_tpu_torch.utils import procedural as tproc
from tests import fixtures
from tests.test_texture_modality import _render_textured_frame

INTR = fixtures.test_intrinsics(320, 240)
POSES = [np_pose(translation=[0.0015 * i, 0.001 * i, 0.5]) for i in range(2)]
CUBE_POSE = np_pose(translation=[-0.09, 0.0, 0.35])
IDS = {"sphere": 31, "cube": 32}


@pytest.fixture(scope="module")
def frames():
    """Colour frames of the textured sphere (and uint16 depth frames with the cube in
    front of it), shared by both packages."""
    body = fixtures.sphere_body("tm_frames_sphere", radius=0.08, n_subdiv=2)
    cube = fixtures.cube_body("tm_frames_cube", half=0.05)
    rng = np.random.default_rng(2)
    face_colors = rng.integers(40, 255, size=(len(body.triangles), 3)).astype(np.uint8)
    colours = [_render_textured_frame(body, INTR, p, face_colors, rng=rng) for p in POSES]
    depths = []
    for pose in POSES:
        tri = [body.triangle_vertices_f_body() @ pose[:3, :3].T + pose[:3, 3],
               cube.triangle_vertices_f_body() @ CUBE_POSE[:3, :3].T + CUBE_POSE[:3, 3]]
        depth, _ = rasterize_np(np.concatenate(tri), np.ones(sum(map(len, tri))), INTR.fu,
                                INTR.fv, INTR.ppu, INTR.ppv, INTR.width, INTR.height,
                                cull_backfaces=True)
        depths.append(np.round(np.where(np.isfinite(depth), depth, 2.0) / 0.001
                               ).astype(np.uint16))
    return colours, depths


def _setup(pkg, frames, descriptor_type, occluded=False, name="tm"):
    """tests/test_texture_fused.py's _textured_setup on the package's classes."""
    is_jax = pkg == "jax"
    kw = {} if is_jax else {"device": "cpu"}
    cam_mod, rmod = (jcamera, jrenderer) if is_jax else (tcamera, trenderer)
    make = fixtures if is_jax else tproc
    body = make.sphere_body(f"{name}_sphere", radius=0.08, n_subdiv=2)
    body.body_id = body.region_id = IDS["sphere"]
    camera = cam_mod.ImageColorCamera(f"{name}_cam", INTR, frames[0])
    assert camera.SetUp()
    rg = (JRendererGeometry if is_jax else TRendererGeometry)(f"{name}_rg", **kw)
    rg.AddBody(body)
    sil = rmod.FocusedSilhouetteRenderer(f"{name}_sil", rg, camera, image_size=200,
                                         id_type=rmod.IDType.BODY, **kw)
    sil.AddReferencedBody(body)
    modality = (JTextureModality if is_jax else TTextureModality)(
        f"{name}_texture", body, camera, sil)
    modality.descriptor_type = descriptor_type
    modality.orb_n_features = 500
    renderers = [sil]
    if occluded:
        cube = make.cube_body(f"{name}_cube", half=0.05)
        cube.body_id = cube.region_id = IDS["cube"]
        cube.set_body2world_pose(CUBE_POSE)
        rg.AddBody(cube)
        depth_renderer = rmod.FocusedBasicDepthRenderer(f"{name}_dr", rg, camera, **kw)
        depth_renderer.AddReferencedBody(body)
        depth_camera = cam_mod.ImageDepthCamera(f"{name}_dcam", INTR, frames[1],
                                                depth_scale=0.001)
        assert depth_camera.SetUp()
        modality.ModelOcclusions(depth_renderer)
        modality.MeasureOcclusions(depth_camera)
        renderers.append(depth_renderer)
    assert rg.SetUp()
    for r in renderers:
        assert r.SetUp()
    return body, camera, modality, renderers


def _run(pkg, frames, descriptor_type, occluded=False):
    """Keyframe at frame 0, then frame 1's correspondences and Gauss-Newton terms."""
    body, camera, modality, renderers = _setup(pkg, frames, descriptor_type, occluded,
                                               name=f"tm_{pkg}_{descriptor_type}")
    assert modality.SetUp()
    for i, pose in enumerate(POSES):
        body.set_body2world_pose(pose)
        assert camera.UpdateImage()
        if modality.depth_camera_ptr is not None:
            assert modality.depth_camera_ptr.UpdateImage()
        for r in renderers:
            assert r.StartRendering()
        if i == 0:
            assert modality.StartModality(0, 0)
    assert modality.CalculateCorrespondences(1, 0)
    assert modality.CalculateGradientAndHessian(1, 0, 0)
    return modality


@pytest.mark.parametrize("descriptor_type,occluded", [
    ("ORB", False), ("DAISY", False), ("FREAK", False), ("ORB", True)],
    ids=["orb", "daisy", "freak", "orb occluded"])
def test_texture_step_matches_jax(frames, descriptor_type, occluded):
    jm, tm = (_run(pkg, frames, descriptor_type, occluded) for pkg in ("jax", "torch"))
    np.testing.assert_array_equal(tm._keypoints, jm._keypoints)
    np.testing.assert_array_equal(tm._descriptors, jm._descriptors)
    assert len(tm._points_keyframes) == len(jm._points_keyframes) == 1
    np.testing.assert_array_equal(tm._descriptors_keyframes[0], jm._descriptors_keyframes[0])
    np.testing.assert_array_equal(tm.data_points_2d, jm.data_points_2d)
    # Keyframe points unproject the rendered depth, whose planes the port evaluates
    # elementwise and JAX as an einsum: the last bit of a depth may differ, a few 1e-8 m
    # that the camera-to-body transform (0.5 m away) turns into about 1e-7 m.
    for got, want in ((tm._points_keyframes[0], jm._points_keyframes[0]),
                      (tm.data_points_3d, jm.data_points_3d)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert len(tm.data_points_3d) > 20
    for got, want in ((tm.gradient, jm.gradient), (tm.hessian, jm.hessian)):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    if occluded:
        plain = _run("torch", frames, descriptor_type)
        assert 0 < len(tm._points_keyframes[0]) < len(plain._points_keyframes[0])


@pytest.mark.parametrize("kind", ["daisy", "freak"])
def test_native_descriptors_match_jax(frames, kind):
    """utils/features' DAISY and FREAK on ORB keypoints of a frame, in both packages."""
    gray = cv2.cvtColor(frames[0][0], cv2.COLOR_BGR2GRAY)
    keypoints = cv2.ORB_create(nfeatures=300).detect(gray, None)
    assert len(keypoints) > 50
    if kind == "daisy":
        made = [m.DaisyDescriptor(radius=7.0, q_radius=3, q_theta=4, q_hist=8)
                for m in (jfeatures, tfeatures)]
    else:
        made = [m.FreakDescriptor(pattern_scale=18.0) for m in (jfeatures, tfeatures)]
    (_, want), (_, got) = (d.compute(gray, keypoints) for d in made)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_fused_texture_terms_match_host(frames):
    """Twin of tests/test_texture_fused.py::test_fused_texture_terms_match_host: the
    port's device terms from its texture_points_from_modalities equal the port's host
    TextureModality gradient and Hessian."""
    modality = _run("torch", frames, "ORB")
    std = modality.standard_deviations[0]
    tp = tpipeline.texture_points_from_modalities([modality], k_max=256, device="cpu")
    assert int(tp.valid.sum()) == len(modality.data_points_3d) > 20
    pose = torch.as_tensor(modality.color_camera_ptr.world2camera_pose @ POSES[1])[None]
    g, h = ttexture_fn.calculate_gradient_and_hessian(
        tp, pose, float(np.float32(INTR.fu)), float(np.float32(INTR.fv)),
        float(np.float32(INTR.ppu)), float(np.float32(INTR.ppv)), float(np.float32(std)),
        tukey_norm_constant=modality.tukey_norm_constant)
    scale_g = max(np.abs(modality.gradient).max(), 1e-6)
    scale_h = max(np.abs(modality.hessian).max(), 1e-6)
    np.testing.assert_allclose(g[0].numpy() / scale_g, modality.gradient / scale_g,
                               atol=2e-4)
    np.testing.assert_allclose(h[0].numpy() / scale_h, modality.hessian / scale_h,
                               atol=2e-4)


def test_try_build_refuses_texture_as_jax(frames):
    reasons = {}
    for pkg, (link_mod, opt_mod, tracker_mod, fused) in {
            "jax": (jlink, joptimizer, jtracker, jfused_serve),
            "torch": (tlink, toptimizer, ttracker, tfused_serve)}.items():
        body, _, modality, _ = _setup(pkg, frames, "ORB", name="tb")
        link = link_mod.Link("tb_link", body)
        link.AddModality(modality)
        tracker = tracker_mod.Tracker("tb_tracker", use_fused_cycle=True)
        tracker.AddOptimizer(opt_mod.Optimizer("tb_opt", link))
        assert tracker.SetUp()
        backend, reasons[pkg] = fused.FusedServeBackend.try_build(tracker)
        assert backend is None
    assert reasons["torch"] == reasons["jax"]
    assert "needs exactly one region modality" in reasons["torch"]
