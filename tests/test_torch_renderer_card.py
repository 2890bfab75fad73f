"""The port's renderers and host path on the card against the CPU, with no JAX anywhere.

The tests need a card and skip without one.  The machine with the card has no JAX, so
run them there without the JAX test configuration:

    python -m pytest --noconftest -q tests/test_torch_renderer_card.py
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from m3t_tpu_torch import camera, pipeline, renderer
from m3t_tpu_torch.common import Intrinsics, np_pose
from m3t_tpu_torch.ops import raster
from m3t_tpu_torch.renderer_geometry import RendererGeometry
from m3t_tpu_torch.utils import procedural

DATA = Path(pipeline.__file__).parent / "data"
INTR = Intrinsics(520.0, 520.0, 319.5, 255.5, 640, 512)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's rasterizer runs there")
    return torch.device("cuda")


def _scene(device):
    """Three spheres and a cube, two spheres overlapping, the cube in front of one."""
    bodies = [procedural.sphere_body(f"card_sphere{i}", 0.06, 2) for i in range(3)]
    bodies.append(procedural.cube_body("card_cube", 0.03))
    positions = [(-0.05, 0.0, 0.5), (0.04, 0.02, 0.56), (0.2, -0.1, 0.6), (-0.04, 0.0, 0.4)]
    rg = RendererGeometry("card_rg", device=device)
    for i, (body, p) in enumerate(zip(bodies, positions)):
        body.set_body2world_pose(np_pose(translation=p))
        body.body_id, body.region_id = i + 1, 10 + i
        rg.AddBody(body)
    cam = camera.ImageColorCamera("card_cam", INTR,
                                  [np.zeros((INTR.height, INTR.width, 3), np.uint8)])
    assert cam.SetUp() and rg.SetUp()
    return bodies, rg, cam


@pytest.mark.cuda
def test_rasterize_with_normals_on_card_matches_cpu(cuda_device):
    """The same soup (several scenes' worth of triangles, in chunks of 64) through
    rasterize(with_normals=True) on both devices: at most 0.1 % of the pixels differ in
    id (a triangle edge through a pixel centre can round either way), and where the ids
    agree depth within rtol 1e-5 and normals within 1e-6."""
    bodies, _, _ = _scene("cpu")
    tri = np.concatenate([b.triangle_vertices_f_body() @ b.body2world_pose[:3, :3].T
                          + b.body2world_pose[:3, 3] for b in bodies])
    ids = np.repeat(np.arange(1, len(bodies) + 1),
                    [b.triangle_vertices_f_body().shape[0] for b in bodies])
    out = {}
    for dev in ("cpu", cuda_device):
        soup = raster.triangle_coefficients(
            torch.as_tensor(tri, device=dev)[None].repeat(2, 1, 1, 1),
            torch.as_tensor(ids, device=dev)[None].repeat(2, 1), INTR.fu, INTR.fv,
            INTR.ppu, INTR.ppv, cull_backfaces=True, z_min=0.02)
        out[str(dev)] = [t.cpu().numpy() for t in
                         raster.rasterize(soup, INTR.width, INTR.height, with_normals=True)]
    (cd, ci, cn), (pd, pi, pn) = out["cuda"], out["cpu"]
    same = ci == pi
    assert same.mean() >= 0.999
    both = same & np.isfinite(pd)
    assert both.mean() > 0.05
    np.testing.assert_allclose(cd[both], pd[both], rtol=1e-5)
    np.testing.assert_allclose(cn[both], pn[both], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["depth", "silhouette body", "silhouette region",
                                  "normal"])
def test_focused_renderers_on_card_match_cpu(cuda_device, kind):
    """A focused renderer of each kind referencing the first sphere, on both devices:
    the crop exactly, and the images as in the rasterize test."""
    images, crops = {}, {}
    for dev in ("cpu", cuda_device):
        bodies, rg, cam = _scene(dev)
        kw = dict(device=dev)
        if kind == "depth":
            r = renderer.FocusedBasicDepthRenderer("card_r", rg, cam, **kw)
        elif kind == "normal":
            r = renderer.FocusedNormalRenderer("card_r", rg, cam, **kw)
        else:
            r = renderer.FocusedSilhouetteRenderer(
                "card_r", rg, cam, id_type=renderer.IDType.REGION if "region" in kind
                else renderer.IDType.BODY, **kw)
        r.AddReferencedBody(bodies[0])
        assert r.SetUp() and r.StartRendering()
        assert r.depth_image.device.type == torch.device(dev).type
        crops[str(dev)] = (r.corner_u, r.corner_v, r.scale, r.visible_body_names)
        images[str(dev)] = [r.depth_image.cpu().numpy()] + (
            [r.silhouette_image.cpu().numpy()] if "silhouette" in kind else []) + (
            [r.normal_image.cpu().numpy()] if kind == "normal" else [])
    assert crops["cuda"] == crops["cpu"]
    card, cpu = images["cuda"], images["cpu"]
    covered = np.isfinite(cpu[0])
    same = np.isfinite(card[0]) == covered
    if "silhouette" in kind:
        same &= card[1] == cpu[1]
        assert len(np.unique(cpu[1])) == 4  # background, two spheres and the cube
    assert same.mean() >= 0.999
    both = same & covered
    np.testing.assert_allclose(card[0][both], cpu[0][both], rtol=1e-5)
    if kind == "normal":
        np.testing.assert_allclose(card[1][both], cpu[1][both], rtol=0, atol=1e-6)


@pytest.fixture
def bench_models(tmp_path):
    """bench.py's sphere models, the committed npz loaded as the port's model caches."""
    from m3t_tpu_torch.depth_model import DepthModel
    from m3t_tpu_torch.region_model import RegionModel

    models = []
    for cls, name in ((RegionModel, "bench_sphere_region_model.npz"),
                      (DepthModel, "bench_sphere_depth_model.npz")):
        shutil.copy(DATA / name, tmp_path / name)
        models.append(cls(name, procedural.sphere_body("bench_sphere", 0.06, 2),
                          str(tmp_path / name), n_divides=2, n_points=200, image_size=800))
        assert models[-1].SetUp()
    return models


@pytest.mark.cuda
def test_occluded_host_step_on_card_matches_cpu(cuda_device, bench_models):
    """chip_smoke.py phase 10o's graph (five spheres, the cube, every scene check) for
    one step on the card and on the CPU from equal states: poses and histograms within
    1e-4, but for at most one body, within 1e-2 and 1e-3 (phase 10x)."""
    import chip_smoke

    inp = chip_smoke.flagship_inputs("cpu", 2, bench_models)
    result = chip_smoke.check_host_card_against_cpu(
        "card test", chip_smoke.occluded_scene_graph, inp, bench_models, n_steps=1)
    assert len(result["parted"]) <= 1 and not result["beyond_bounds"], result
