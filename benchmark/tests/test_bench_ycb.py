"""The YCB-class cell's parts on the CPU: the closed-form models of multi-region bodies
(``harness/multi_sphere.py``) against rendered ones and against the centred sphere's, the
scene's layout, the imports of its reference and of a run, and the K3 work of one cycle.

Run from the repository root: ``python -m pytest -q benchmark/tests``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import models, multi_sphere, spec, sphere_depth

REPO = Path(__file__).resolve().parents[2]
CONFIG = "ycb_rgbd_texture"
CELL = "ycb_rgbd_texture.eval_s128"


def _camera(config):
    return tuple(float(config[k]) for k in ("fu", "fv", "ppu", "ppv"))


def test_a_sphere_at_the_origin_is_the_centred_sphere():
    """offset_sphere_region_model at c = 0 is models.sphere_region_model but for the
    depth offsets, which it gives in closed form; union_depth_model of one sphere holds
    sphere_depth_model's points."""
    config = spec.config(CONFIG)
    centred = models.sphere_region_model(config)
    moved = multi_sphere.offset_sphere_region_model(config, [0.0, 0.0, 0.0])
    for name, value in centred.items():
        if name != "depth_offsets":
            assert np.array_equal(value, moved[name]), name
    assert (moved["depth_offsets"] > 0).all()
    one = multi_sphere.union_depth_model(config, [[0.0, 0.0, 0.0]])
    for name, value in sphere_depth.sphere_depth_model(config).items():
        if name != "depth_offsets":
            assert np.array_equal(value, one[name]), name


def test_offset_sphere_model_matches_a_rendered_one():
    """The closed-form model of a sphere 4 cm off the body's origin against the port's
    model of that sphere rendered at n_divides 2 (800 px, six views): the same views,
    each rendered contour point near the circle, its normal near the circle's, its
    foreground about as long and its depth offsets close.  The rendered body is a
    polyhedron of 1280 faces, so its contour strays from the sphere's along the view
    (measured: 4.7 mm), 0.6 mm across it, 10 degrees in its normal, 2.4 % in its
    foreground and 6 mm in its offsets (12.6 mm at the first, 2 mm radius)."""
    from m3t_tpu_torch.body import Body
    from m3t_tpu_torch.region_model import RegionModel

    config = spec.config(CONFIG)
    r, d = config["body_radius"], config["region_model"]["sphere_radius"]
    centre = np.array([0.04, 0.0, 0.0])
    vertices, faces = models.icosphere(3, r)
    body = Body("offset_sphere", vertices=vertices + centre.astype(np.float32),
                triangles=faces)
    assert body.SetUp()
    closed = multi_sphere.offset_sphere_region_model(
        dict(config, region_model=dict(config["region_model"], n_divides=2)), centre)
    with tempfile.TemporaryDirectory() as tmp:
        rendered = RegionModel("r", body, os.path.join(tmp, "r.npz"), sphere_radius=d,
                               n_divides=2, n_points=200, image_size=800,
                               view_subset=[0, 5, 40, 77, 120, 161])
        assert rendered.SetUp()
    match = np.argmax(rendered.orientations @ closed["orientations"].T, axis=1)
    assert np.allclose(rendered.orientations, closed["orientations"][match], atol=1e-6)
    w = -d * rendered.orientations - centre
    dist = np.linalg.norm(w, axis=1)
    axis = (w / dist[:, None])[:, None]
    rel = rendered.centers - centre
    height = (rel * axis).sum(-1)
    radial = rel - height[..., None] * axis
    rho = np.linalg.norm(radial, axis=-1)
    assert np.abs(height - r * r / dist[:, None]).max() < 6e-3
    assert np.abs(rho - r * np.sqrt(1 - (r / dist[:, None]) ** 2)).max() < 1e-3
    assert ((rendered.normals * radial).sum(-1) / rho).min() > np.cos(np.radians(12.0))
    assert np.abs(rendered.foreground_distances / closed["foreground_distances"][match]
                  - 1.0).max() < 0.03
    gap = np.abs(rendered.depth_offsets - closed["depth_offsets"][match])
    assert gap[..., 0].max() < 0.015 and gap[..., 1:].max() < 0.008


def test_union_depth_model_points_are_seen_by_their_view():
    """Every point of a bottle's depth model lies on one of its spheres, faces its view's
    camera, and no other sphere hides it; a view along the bottle's axis sees the near
    sphere alone, and a view across it both."""
    config = spec.config(CONFIG)
    centres = np.asarray(config["objects"][0]["spheres_m"])
    r, d = config["body_radius"], config["depth_model"]["sphere_radius"]
    model = multi_sphere.union_depth_model(config, centres)
    to_camera = -model["orientations"].astype(np.float64)
    points = model["centers"].astype(np.float64)
    owner = np.argmin(np.linalg.norm(points[..., None, :] - centres, axis=-1), -1)
    assert np.abs(np.linalg.norm(points - centres[owner], axis=-1) - r).max() < 1e-6
    camera = d * to_camera[:, None]
    normal = model["normals"].astype(np.float64)
    assert ((normal * (camera - points)).sum(-1) > 0).all()
    for k, centre in enumerate(centres):
        other = owner != k
        assert not multi_sphere.hidden(camera, points, centre, r)[other].any()
    along = np.argmax(to_camera @ [1.0, 0.0, 0.0])
    across = np.argmax(to_camera @ [0.0, 0.0, -1.0])
    assert (owner[along] == 1).all()
    assert (owner[across] == 0).sum() == (owner[across] == 1).sum()


def _hits(config, centre, u, v):
    fu, fv, ppu, ppv = _camera(config)
    d = np.stack(np.broadcast_arrays((u - ppu) / fu, (v - ppv) / fv, 1.0), -1)
    t = (d @ centre) / (d * d).sum(-1)
    return np.linalg.norm(t[..., None] * d - centre, axis=-1) <= config["body_radius"]


def test_each_bottle_is_hidden_by_its_ball_by_about_a_centimetre():
    """Along the image column through the hidden sphere's centre, the ball in front
    covers 10-11 mm of it at the hidden sphere's depth; no two spheres of different
    bodies overlap otherwise."""
    config = spec.config(CONFIG)
    fu, fv, ppu, ppv = _camera(config)
    objects = config["objects"]
    places = [(o, np.add(obj["position_m"], c)) for o, obj in enumerate(objects)
              for c in obj["spheres_m"]]
    hidden = {(0, 0): 1, (2, 1): 3}
    for (o, k), front in hidden.items():
        centre = np.add(objects[o]["position_m"], objects[o]["spheres_m"][k])
        u = centre[0] * fu / centre[2] + ppu
        v = np.arange(0.0, config["height"], 1e-3)
        both = (_hits(config, centre, u, v)
                & _hits(config, np.asarray(objects[front]["position_m"]), u, v))
        assert 10.0 <= both.sum() * 1e-3 * centre[2] / fv * 1e3 <= 11.0
    uu, vv = np.meshgrid(np.arange(config["width"]), np.arange(config["height"]))
    masks = [(o, _hits(config, c, uu, vv)) for o, c in places]
    pairs = {(0, 1), (2, 3)}
    for i, (a, mask_a) in enumerate(masks):
        for b, mask_b in masks[i + 1:]:
            if a != b and (a, b) not in pairs:
                assert not (mask_a & mask_b).any(), (a, b)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_the_rgbd_reference_loads_neither_jax_nor_the_program():
    loaded = _loaded("import benchmark.reference.rgbd")
    assert not loaded & {"jax", "jaxlib", "flax", "m3t_tpu", "m3t_tpu_torch"}


def test_a_run_of_the_cell_loads_no_jax():
    code = ("import io, sys, torch\nsys.path.insert(0, 'tests')\n"
            "import test_bench_ycb_rgbd_texture as t\n"
            "from benchmark import run\nfrom benchmark.harness import spec\n"
            "spec.config = lambda n, c=t.small_config(): dict(c)\n"
            "spec.traffic = lambda n, m=t.small_traffic(): dict(m)\n"
            f"a = run.parse_args(['--workload', '{CELL}', '--seed', '5',"
            " '--seconds', '0.2'])\n"
            "assert run.measure(a, out=io.StringIO(), card=torch.device('cpu')) == 0")
    loaded = _loaded(code)
    assert "m3t_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "m3t_tpu"}


def test_kernel_work_counts_every_k1_and_k3_call():
    """One eager cycle's recorded calls: per correspondence iteration K1 once in ratio
    mode and K3 three times (the region lines' measured-occlusion windows, the depth
    correspondence windows and the depth points' measured-occlusion windows), K1 once
    more in bins mode; the measured-occlusion calls take one window per line or point."""
    sys.path.insert(0, str(REPO / "tests"))
    import test_bench_ycb_rgbd_texture as small

    from benchmark.harness import roofline_scene

    torch.set_num_threads(4)
    driver = small.stepped()
    frame = driver.frame(driver.t + 1)
    with roofline_scene.recorded_calls() as calls:
        driver.side.cycle(*driver.frame_inputs(frame), driver.state)
    config = driver.config
    corr = config["n_corr_iterations"]
    assert len(calls["sample_lines"]) == corr + 1
    windows = calls["sample_windows"]
    assert len(windows) == 3 * corr
    slots = driver.n * driver.j
    occlusion = [w for i, w in enumerate(windows) if i % 3 != 1]
    assert [args[1].shape for args, _ in occlusion] == [
        (slots, config["n_lines"]), (slots, config["n_points"])] * corr
    assert {args[-1] for args, _ in occlusion} == {6}
    work = driver.kernel_work()
    assert set(work) == {"sample_lines", "sample_windows"}
    assert all(n > 0 for pair in work.values() for n in pair)
