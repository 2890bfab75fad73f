"""Parity tests: the port's renderers (renderer_geometry.py, renderer.py and the normal
path of ops/raster.rasterize) against the JAX package's, on the CPU.

The scene is tests/test_occlusions.py's: a sphere (radius 0.06 m) 0.7 m from a 200x150
camera and a cube (half size 0.05 m) 0.5 m away in front of its left half.  Both packages
get bodies with the same ids, set explicitly (Body ids come from a process-wide counter).
Depth within rtol 1e-5 where both cover a pixel, ids exact, normals within 1e-6.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu import camera as jcamera
from m3t_tpu import renderer as jrenderer
from m3t_tpu.ops import raster as jraster
from m3t_tpu.renderer_geometry import RendererGeometry as JRendererGeometry
from m3t_tpu_torch import camera as tcamera
from m3t_tpu_torch import renderer as trenderer
from m3t_tpu_torch.common import np_pose
from m3t_tpu_torch.ops import raster as traster
from m3t_tpu_torch.renderer_geometry import RendererGeometry as TRendererGeometry
from m3t_tpu_torch.utils import procedural as tproc
from tests import fixtures

INTR = fixtures.test_intrinsics(200, 150)
SPHERE_POSE = np_pose(translation=[0.0, 0.0, 0.7])
CUBE_POSE = np_pose(translation=[-0.05, 0.0, 0.5])
# (body id, region id) of the sphere and the cube, set on both sides.
IDS = {"sphere": (11, 3), "cube": (12, 4)}


def scene_bodies(pkg: str, prefix: str = "rend"):
    """The sphere and the cube of the package, posed, with the ids of IDS."""
    make = fixtures if pkg == "jax" else tproc
    bodies = [make.sphere_body(f"{prefix}_sphere", radius=0.06, n_subdiv=2),
              make.cube_body(f"{prefix}_cube", half=0.05)]
    for body, pose, (bid, rid) in zip(bodies, (SPHERE_POSE, CUBE_POSE), IDS.values()):
        body.set_body2world_pose(pose)
        body.body_id, body.region_id = bid, rid
    return bodies


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_images_match(got_depth, want_depth, got_ids=None, want_ids=None,
                        got_normals=None, want_normals=None):
    gd, wd = _n(got_depth), _n(want_depth)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    both = np.isfinite(wd)
    assert both.mean() > 0.02
    np.testing.assert_allclose(gd[both], wd[both], rtol=1e-5)
    if want_ids is not None:
        np.testing.assert_array_equal(_n(got_ids), _n(want_ids))
    if want_normals is not None:
        np.testing.assert_allclose(_n(got_normals), _n(want_normals), rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def graphs():
    """Each package's bodies, colour camera, RendererGeometry (decimated to 60 triangles
    for the occlusion meshes) and every renderer kind over it, set up."""
    out = {}
    for pkg in ("jax", "torch"):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        cam_mod, rmod = (jcamera, jrenderer) if pkg == "jax" else (tcamera, trenderer)
        rg_cls = JRendererGeometry if pkg == "jax" else TRendererGeometry
        bodies = scene_bodies(pkg)
        camera = cam_mod.ImageColorCamera(
            f"{pkg}_cam", INTR, [np.zeros((INTR.height, INTR.width, 3), np.uint8)])
        assert camera.SetUp()
        rg = rg_cls("rg", max_occlusion_triangles=60, **kw)
        for body in bodies:
            assert rg.AddBody(body)
        assert rg.SetUp()
        renderers = {
            "full_depth": rmod.FullBasicDepthRenderer("fd", rg, camera, **kw),
            "full_silhouette": rmod.FullSilhouetteRenderer("fs", rg, camera, **kw),
            "full_normal": rmod.FullNormalRenderer("fn", rg, camera, **kw),
            "focused_depth": rmod.FocusedBasicDepthRenderer("cd", rg, camera, **kw),
            "focused_silhouette_body": rmod.FocusedSilhouetteRenderer(
                "csb", rg, camera, id_type=rmod.IDType.BODY, **kw),
            "focused_silhouette_region": rmod.FocusedSilhouetteRenderer(
                "csr", rg, camera, id_type=rmod.IDType.REGION, **kw),
            "focused_normal": rmod.FocusedNormalRenderer("cn", rg, camera, image_size=120,
                                                         **kw),
            "focused_decimated": rmod.FocusedBasicDepthRenderer(
                "cdd", rg, camera, use_decimated_meshes=True, **kw),
        }
        for name, renderer in renderers.items():
            if name.startswith("focused"):
                # The sphere only: the crop is the sphere's, the cube still occludes.
                assert renderer.AddReferencedBody(bodies[0])
            assert renderer.SetUp()
            assert renderer.StartRendering()
        out[pkg] = dict(bodies=bodies, rg=rg, renderers=renderers)
    return out


def test_rasterize_with_normals_matches_jax():
    """The same triangles through both packages' triangle_coefficients and
    rasterize(with_normals=True), in chunks of 64 (several chunks, so that both tie
    rules are reached)."""
    verts, ids, culls = [], [], []
    for body, pose in zip(scene_bodies("jax", "rast"), (SPHERE_POSE, CUBE_POSE)):
        tri = body.triangle_vertices_f_body()
        verts.append(tri @ pose[:3, :3].T + pose[:3, 3])
        ids.append(np.full(len(tri), body.body_id, np.int32))
        culls.append(np.full(len(tri), True))
    tri, ids, culls = (np.concatenate(a) for a in (verts, ids, culls))
    intr = INTR
    want = jraster.rasterize(
        jraster.triangle_coefficients(jnp.asarray(tri), jnp.asarray(ids), intr.fu, intr.fv,
                                      intr.ppu, intr.ppv, cull_backfaces=jnp.asarray(culls),
                                      z_min=0.02),
        intr.width, intr.height, chunk=64, with_normals=True)
    soup = traster.triangle_coefficients(
        torch.as_tensor(tri)[None], torch.as_tensor(ids)[None], intr.fu, intr.fv, intr.ppu,
        intr.ppv, cull_backfaces=torch.as_tensor(culls)[None], z_min=0.02)
    got = traster.rasterize(soup, intr.width, intr.height, chunk=64, with_normals=True)
    assert len(tri) > 64 * 3
    assert_images_match(got[0][0], want[0], got[1][0], want[1], got[2][0], want[2])
    # Without normals the depth and ids are the same images.
    plain = traster.rasterize(soup, intr.width, intr.height, chunk=64)
    for a, b in zip(plain, got[:2]):
        assert torch.equal(a, b)
    # Both bodies show, and the normals face the camera.
    assert set(np.unique(_n(got[1]))) == {0, IDS["sphere"][0], IDS["cube"][0]}
    covered = _n(got[1][0]) > 0
    assert (_n(got[2][0])[covered][:, 2] < 0).all()


def test_renderer_geometry_matches_jax(graphs):
    for jbody, tbody in zip(graphs["jax"]["bodies"], graphs["torch"]["bodies"]):
        jd = graphs["jax"]["rg"].render_data(jbody.name)
        td = graphs["torch"]["rg"].render_data(tbody.name)
        assert td.n_triangles == jd.n_triangles
        for name in ("tri_verts_f_body", "occlusion_tri_verts_f_body"):
            got, want = _n(getattr(td, name)), np.asarray(getattr(jd, name))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=name)
    sphere = graphs["torch"]["rg"].render_data(graphs["torch"]["bodies"][0].name)
    assert sphere.occlusion_tri_verts_f_body.shape[0] <= 60 < sphere.n_triangles


@pytest.mark.parametrize("name", [
    "full_depth", "full_silhouette", "full_normal", "focused_depth",
    "focused_silhouette_body", "focused_silhouette_region", "focused_normal",
    "focused_decimated"])
def test_renderers_match_jax(graphs, name):
    jr, tr = graphs["jax"]["renderers"][name], graphs["torch"]["renderers"][name]
    if name.startswith("focused"):
        assert (tr.corner_u, tr.corner_v, tr.scale) == (jr.corner_u, jr.corner_v, jr.scale)
        assert tr.visible_body_names == jr.visible_body_names == [
            graphs["torch"]["bodies"][0].name]
    assert tr.depth_image.device.type == "cpu"
    if "silhouette" in name:
        assert_images_match(tr.focused_depth_image(), jr.focused_depth_image(),
                            tr.focused_silhouette_image(), jr.focused_silhouette_image())
        ids = set(np.unique(_n(tr.silhouette_image)))
        which = 0 if "body" in name or name == "full_silhouette" else 1
        assert ids == {0, IDS["sphere"][which], IDS["cube"][which]}
        if name.startswith("focused"):
            center = (tr.image_size // 2, tr.image_size // 2)
            assert tr.SilhouetteValue(center) == jr.SilhouetteValue(center) > 0
    elif "normal" in name:
        assert_images_match(tr.depth_image, jr.depth_image,
                            got_normals=tr.normal_image, want_normals=jr.normal_image)
        np.testing.assert_array_equal(tr.normal_image_rgb(), jr.normal_image_rgb())
    else:
        assert_images_match(tr.focused_depth_image(), jr.focused_depth_image())


def test_focused_renderer_without_visible_bodies(graphs):
    """A referenced body behind the camera: no crop, empty images on both sides."""
    images = {}
    for pkg, g in graphs.items():
        renderer = g["renderers"]["focused_silhouette_body"]
        body = g["bodies"][0]
        body.set_body2world_pose(np_pose(translation=[0.0, 0.0, -0.5]))
        try:
            assert renderer.StartRendering()
        finally:
            body.set_body2world_pose(SPHERE_POSE)
        assert renderer.visible_body_names == []
        assert (renderer.corner_u, renderer.corner_v, renderer.scale) == (0.0, 0.0, 1.0)
        images[pkg] = (_n(renderer.focused_depth_image()),
                       _n(renderer.focused_silhouette_image()))
        assert renderer.StartRendering()
    for got, want in zip(images["torch"], images["jax"]):
        np.testing.assert_array_equal(got, want)
    assert np.isinf(images["torch"][0]).all() and not images["torch"][1].any()


def test_renderers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        TRendererGeometry("rg_default")
    rg = TRendererGeometry("rg_cpu", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        trenderer.FocusedSilhouetteRenderer("sil", rg)


@pytest.mark.parametrize("seed", [0, 1])
def test_windowed_chunks_equal_the_whole_image_loop(seed):
    """rasterize_windows evaluates each chunk over its window only (chunk_windows); on
    random triangles (slivers, sub-pixel ones, some off
    the image, some behind the camera) in two scenes, the images equal those of every
    chunk over the whole image."""
    rng = np.random.default_rng(seed)
    n = 320                                       # ten chunks of 32, sorted along x
    center = rng.uniform([-0.3, -0.25, 0.3], [0.3, 0.25, 1.2], (2, n, 1, 3))
    center = np.take_along_axis(center, np.argsort(center[..., 0] / center[..., 2],
                                                   axis=1)[..., None], axis=1)
    tri = (center + rng.normal(0, 0.03, (2, n, 3, 3))).astype(np.float32)
    tri[:, :10, 2] = tri[:, :10, 1] + rng.normal(0, 1e-5, (2, 10, 3))     # slivers
    tri[:, 100:120] = center[:, 100:120] + rng.normal(0, 1e-4, (2, 20, 3, 3))  # tiny
    tri[:, 256:288, :, 2] = -0.2                                         # behind
    tri[:, 288:, :, 0] += 2.0                                            # off the image
    soup = traster.triangle_coefficients(
        torch.as_tensor(tri), torch.as_tensor(rng.integers(1, 9, (2, n), dtype=np.int32)),
        150.0, 150.0, 99.5, 74.5, cull_backfaces=torch.as_tensor(rng.random((2, n)) > 0.5),
        z_min=0.02)
    windows = traster.chunk_windows(soup, 200, 150, 32)
    assert windows[0] == (0, 200, 0, 150) and windows[-2:] == [None, None]
    assert sum((u1 - u0) * (v1 - v0) < 200 * 150 for u0, u1, v0, v1 in windows[1:-2]) >= 4
    got = traster.rasterize_windows(soup, 200, 150, windows, chunk=32, with_normals=True)
    want = traster.rasterize(soup, 200, 150, chunk=32, with_normals=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got[1] > 0).float().mean() > 0.1


@pytest.mark.parametrize("kind", ["ImageColorViewer", "ImageDepthViewer",
                                  "NormalColorViewer", "NormalDepthViewer"])
def test_viewers_save_the_images_of_jax(graphs, kind, tmp_path):
    """Each viewer over the scene's cameras (a colour frame with a gradient, a depth
    frame of the scene), saving to disk with display off: the port's files equal the
    JAX package's, pixel for pixel (a normal viewer blends the FullNormalRenderer image
    at opacity 0.5)."""
    from m3t_tpu import viewer as jviewer
    from m3t_tpu_torch import viewer as tviewer

    colour = np.broadcast_to(np.arange(INTR.width, dtype=np.uint8)[None, :, None] * 2,
                             (INTR.height, INTR.width, 3)).copy()
    depth = np.full((INTR.height, INTR.width), 900, np.uint16)
    depth[:, :50] = 400
    saved = {}
    for pkg, vmod, cmod in (("jax", jviewer, jcamera), ("torch", tviewer, tcamera)):
        if "Color" in kind:
            camera = cmod.ImageColorCamera(f"v_{pkg}", INTR, [colour])
        else:
            camera = cmod.ImageDepthCamera(f"v_{pkg}", INTR, [depth], depth_scale=0.001)
        assert camera.SetUp() and camera.UpdateImage()
        cls = getattr(vmod, kind)
        viewer = (cls("viewer", camera, graphs[pkg]["rg"]) if kind.startswith("Normal")
                  else cls("viewer", camera))
        viewer.set_display_images(False)
        viewer.StartSavingImages(str(tmp_path / pkg))
        (tmp_path / pkg).mkdir()
        assert viewer.SetUp() and viewer.UpdateViewer(3)
        saved[pkg] = cv2.imread(str(tmp_path / pkg / "viewer_image_3.png"),
                                cv2.IMREAD_UNCHANGED)
    assert saved["torch"] is not None
    np.testing.assert_array_equal(saved["torch"], saved["jax"])
    if kind.startswith("Normal"):
        assert len(np.unique(saved["torch"].reshape(-1, 3), axis=0)) > 10
