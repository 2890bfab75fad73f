"""The parts of the articulated RGB-D cell (``rtb_kinematic_rgbd``) on the CPU: the
closed-form depth model, the structure from the driver's object graph through
``kin_ops.build_kinematic_model``, the structure's overlaps in the image, the stage marks
and counters of the articulated cycle on the configuration's structure, the K3 and K4
work counts against hand counts, the reference's slab cast against a plain triangle
cast, and the imports of the reference.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import models, roofline_scene, spec, sphere_depth  # noqa: E402
from benchmark.traffic import generator  # noqa: E402

CONFIG = "rtb_kinematic_rgbd"


def _driver_module():
    return spec.load_module("drivers", "fused_kinematic")


def test_depth_model_points_lie_on_the_visible_cap():
    """Every point on the sphere and on the cap its view sees (x . o >= r^2 / D), its
    normal radial and of unit length; neighbouring views hold nearly the same points."""
    config = spec.config(CONFIG)
    model = sphere_depth.sphere_depth_model(config)
    r, d = config["body_radius"], config["depth_model"]["sphere_radius"]
    centers, normals = model["centers"].astype(np.float64), model["normals"]
    to_camera = -model["orientations"].astype(np.float64)
    assert centers.shape == (10 * 4 ** 4 + 2, config["depth_model"]["n_points"], 3)
    assert np.allclose(np.linalg.norm(centers, axis=-1), r, rtol=1e-6)
    assert ((centers * to_camera[:, None]).sum(-1) >= r * r / d - 1e-7).all()
    assert np.allclose(np.linalg.norm(normals, axis=-1), 1.0, atol=1e-6)
    assert np.allclose(normals, centers / r, atol=1e-6)
    assert not model["depth_offsets"].any()
    # Neighbouring views (the two closest directions) move each point by a fraction of
    # the view's angle: r * 0.06 rad is 2 mm, about 3 pixels at 0.8 m and fu 1000.
    angle = np.arccos(np.clip(to_camera @ to_camera[0], -1, 1))
    near = np.argsort(angle)[1]
    step = np.linalg.norm(centers[near] - centers[0], axis=-1).max()
    assert step < r * 1.5 * angle[near]


def test_build_kinematic_model_gives_the_configured_structure():
    from m3t_tpu_torch.ops import kinematics as kin_ops

    config = spec.config(CONFIG)
    st = config["structure"]
    optimizer, bodies = _driver_module().object_graph(config)
    kin = kin_ops.build_kinematic_model([optimizer], device="cpu")
    assert kin.parent[0].tolist() == st["parent"]
    assert kin.free[0].tolist() == [[float(f) for f in row] for row in st["free"]]
    assert kin.link_valid.all()
    (c,) = st["constraints"]
    assert (kin.c_link1[0].tolist(), kin.c_link2[0].tolist()) == ([c["link1"]], [c["link2"]])
    assert kin.c_dirs[0].tolist() == [[float(x) for x in c["directions"]]]
    body2joint, joint2parent = _driver_module().joint_poses(config)
    assert np.allclose(kin.c_body22joint2[0, 0].numpy(), body2joint[c["link2"]])
    assert np.allclose(kin.c_body12joint1[0, 0].numpy(), np.eye(4))
    assert np.allclose(kin.body2joint[0].numpy(), body2joint)
    start = kin_ops.initial_joint2parent([optimizer], device="cpu")[0].numpy()
    assert np.allclose(start, joint2parent, atol=1e-6)
    assert kin_ops.kkt_rows(kin) == st["kkt_rows"] == 48
    free = int(kin.free.sum())
    rows = int(kin.c_dirs.sum())
    assert free + rows == st["kkt_rows_compacted"] == 22
    assert len(bodies) == 7


def test_neighbouring_links_overlap_in_the_image():
    """Each parent-child pair's discs overlap by 5-15 mm at its depth, no other pair's."""
    config = spec.config(CONFIG)
    body2joint, joint2parent = _driver_module().joint_poses(config)
    parent = np.asarray(config["structure"]["parent"])
    centres = generator.forward_kinematics(parent, joint2parent[None].astype(np.float64),
                                           body2joint.astype(np.float64))[0, :, :3, 3]
    r, f = config["body_radius"], config["fu"]

    def overlap_mm(a, b):
        disc = f * r / np.sqrt(centres[[a, b], 2] ** 2 - r * r)
        gap = np.linalg.norm(f * centres[a, :2] / centres[a, 2]
                             - f * centres[b, :2] / centres[b, 2])
        return (disc.sum() - gap) * centres[[a, b], 2].mean() / f * 1e3

    pairs = {(int(p), link) for link, p in enumerate(parent) if p >= 0}
    for a in range(7):
        for b in range(a + 1, 7):
            if (a, b) in pairs:
                assert 5.0 <= overlap_mm(a, b) <= 15.0
            else:
                assert overlap_mm(a, b) < 0.0


def test_kinematic_stages_tile_the_cycle_and_count_its_work():
    """On the configuration's structure at S = 2: the marks tile one articulated RGB-D
    cycle (each Newton step in ``kinematic_terms`` and ``kkt_solve``), and the counters
    read S, S * NL, S * 48 and, per correspondence iteration, the S * NL scenes' NL
    meshes' triangles."""
    from m3t_tpu_torch import pipeline
    from m3t_tpu_torch.utils import timing

    from tests.test_bench_rtb_kinematic import small_config, small_traffic

    cell = spec.cell("rtb_kinematic_rgbd.eval_s256")
    module = _driver_module()
    driver = module.Driver(cell, small_config(), small_traffic(), 7, torch.device("cpu"))
    driver.setup()
    timing.reset()
    try:
        with timing.tracing():
            begin = time.perf_counter_ns()
            driver.step(False)
            end = time.perf_counter_ns()
        report = timing.report()
    finally:
        timing.reset()
    (interval,) = report.intervals
    names = [name for name, _, _ in interval.stages]
    assert all(a[2] == b[1] for a, b in zip(interval.stages, interval.stages[1:]))
    assert begin <= interval.start_ns <= interval.end_ns <= end
    steps = driver.config["n_corr_iterations"] * driver.config["n_update_iterations"]
    assert names.count("kinematic_terms") == names.count("kkt_solve") == steps
    for i, name in enumerate(names):
        if name == "kinematic_terms":
            assert names[i - 1] == "newton_step" and names[i + 1] == "kkt_solve"
    assert {"scene_render", "depth_correspondences", "depth_gradient_hessian"} <= set(names)
    assert set(names) - {"graphs.run"} <= set(pipeline.STAGE_PHASES)
    faces = 20 * 4 ** driver.config["body_subdivisions"]
    assert report.counters == {"kinematics.structures": 2, "kinematics.links": 14,
                               "kinematics.kkt_rows": 96,
                               "occlusion.scene_triangles":
                                   driver.config["n_corr_iterations"] * 14 * 7 * faces}


def test_every_scene_query_finds_its_scene_boxes():
    """An eager articulated RGB-D cycle at S = 2 inside roofline_scene.recorded_calls():
    every K4 call is paired with the boxes of the focused scene whose coefficients it
    reads (the same tensor the pipeline hands on), so ``k4_roofline_pct`` has its work."""
    from tests.test_bench_rtb_kinematic import small_config, small_traffic

    cell = spec.cell("rtb_kinematic_rgbd.eval_s256")
    driver = _driver_module().Driver(cell, small_config(), small_traffic(), 7,
                                     torch.device("cpu"))
    driver.setup()
    frame = driver.frame(driver.t + 1)
    with roofline_scene.recorded_calls() as calls:
        driver.side.cycle(driver.seq.colour[frame], driver.seq.depth[frame], driver.state)
    queries = calls["query_eval"]
    # Per correspondence iteration: the region lines' and the depth points' modeled
    # occlusions.
    assert len(queries) == 2 * driver.config["n_corr_iterations"]
    for args, _, bbox in queries:
        assert bbox is not None and bbox.shape == args[0].shape[:2] + (4,)
    n_bytes, n_ops = roofline_scene.cycle_work(calls)["query_eval"]
    assert n_bytes > 0 and n_ops > 0

def test_counts_inside_a_capture_go_to_the_graph():
    """A count made while a graph is captured is the graph's, added by each replay, not
    the tracer's at once."""
    from m3t_tpu_torch.utils import timing

    timing.reset()
    marks, counts = [], []
    try:
        with timing.tracing():
            with timing.capturing(marks, counts):
                timing.count("kinematics.structures", 3)
            assert counts == [("kinematics.structures", 3)]
            assert timing.report().counters == {}
            timing.count("kinematics.structures", 3)
            assert timing.report().counters == {"kinematics.structures": 3}
    finally:
        timing.reset()


def test_window_work_matches_a_hand_count():
    """Two bodies of one frame shared as an expanded view, 5x6 pixels, one window each
    of k = 2 samples a side and stride 2 in a 4-pixel crop: body 0 from (0, 0) reads
    (0, 0), (0, 2), (2, 0), (2, 2); body 1 from (1, 1) with the crop at (1, 1) reads
    (1, 1), (1, 3), (3, 1), (3, 3); and a third window clamped by its crop."""
    image = torch.zeros((1, 5, 6), dtype=torch.uint16).expand(2, 5, 6)
    u_min = torch.tensor([[0], [1]], dtype=torch.int32)
    v_min = torch.tensor([[0], [1]], dtype=torch.int32)
    stride = torch.full((2, 1), 2, dtype=torch.int32)
    corner_u = torch.tensor([0, 1], dtype=torch.int32)
    corner_v = torch.tensor([0, 1], dtype=torch.int32)
    args = (image, u_min, v_min, stride, corner_u, corner_v, 4, 2)
    assert roofline_scene.touched_pixels(*args) == 8
    n_bytes, n_ops = roofline_scene.sample_windows_work(*args)
    assert n_bytes == 2 * 4 * 4 + 3 * 2 * 4 + 2 * 2 * 4 + 2 * 8
    assert n_ops == 5 * 2 * 4
    # Stride 3 from (0, 0) in a 4-pixel crop: samples 0 and 3, then 6 clamped to 3.
    stride3 = torch.full((2, 1), 3, dtype=torch.int32)
    args3 = (image[:1], u_min[:1], v_min[:1], stride3[:1], corner_u[:1], corner_v[:1], 4, 3)
    assert roofline_scene.touched_pixels(*args3) == 4
    # Distinct frames count apart.
    own = torch.zeros((2, 5, 6), dtype=torch.uint16)
    u_same = torch.zeros((2, 1), dtype=torch.int32)
    assert roofline_scene.touched_pixels(own, u_same, u_same, stride, u_same[:, 0],
                                         u_same[:, 0], 4, 2) == 8
    assert roofline_scene.touched_pixels(image, u_same, u_same, stride, u_same[:, 0],
                                         u_same[:, 0], 4, 2) == 4


def test_scene_query_work_matches_a_hand_count():
    """One scene of three triangles (the last invalid), four integer queries: triangle 0
    boxes u, v in [0.5, 2.0] (queries (1, 1) and (2, 2)), triangle 1 [-1, 5] x [2, 2.5]
    ((2, 2) and (4, 2)); the loop bound is 2.  Queries that are not pixels are refused."""
    bbox = torch.tensor([[[0.5, 2.0, 0.5, 2.0], [-1.0, 5.0, 2.0, 2.5],
                          [0.0, 9.0, 0.0, 9.0]]])
    valid = torch.tensor([[True, True, False]])
    u = torch.tensor([[1, 2, 4, 0]], dtype=torch.int32)
    v = torch.tensor([[1, 2, 2, 3]], dtype=torch.int32)
    assert roofline_scene.in_box_pairs(u, v, bbox, valid) == 4
    with pytest.raises(ValueError):
        roofline_scene.in_box_pairs(u.float(), v.float(), bbox, valid)
    coeffs = torch.zeros((1, 3, 12))
    ids = torch.zeros((1, 3), dtype=torch.int32)
    n_bytes, n_ops = roofline_scene.query_eval_work(coeffs, valid, ids, u, v, bbox)
    assert n_bytes == 16 * 4 + 3 + 52 * 2
    assert n_ops == 27 * 4


def test_the_slab_cast_finds_the_nearest_triangle():
    """The reference's scene depth (each convex mesh entered where the ray crosses the
    last of its faces' planes) against a plain cast of every triangle, on rays through
    two icospheres, one in front of the other, and past them."""
    from benchmark.reference import kinematic

    config = spec.config(CONFIG)
    config.update(width=64, height=48, fu=60.0, fv=60.0, ppu=32.0, ppv=24.0)
    s = kinematic.Settings.from_config(config)
    vertices, faces = models.icosphere(1, 0.035)
    tri = torch.as_tensor(vertices[faces])
    meshes = kinematic.Models(None, None, tri)
    poses = torch.eye(4).repeat(1, 2, 1, 1)
    poses[0, 0, :3, 3] = torch.tensor([0.0, 0.0, 0.8])
    poses[0, 1, :3, 3] = torch.tensor([0.03, 0.01, 0.7])
    foc = kinematic.Focus(torch.tensor([0.0]), torch.tensor([0.0]), torch.tensor([1.0]),
                          torch.tensor([True]))
    gu, gv = torch.meshgrid(torch.arange(24.0, 40.0, 0.5), torch.arange(16.0, 32.0, 0.5),
                            indexing="ij")
    depth = kinematic.scene_depth(s, meshes, poses, foc, gu.reshape(1, -1),
                                  gv.reshape(1, -1))[0]
    rays = torch.stack([(gu.reshape(-1) - 32.0) / 60.0, (gv.reshape(-1) - 24.0) / 60.0,
                        torch.ones(gu.numel())], -1).double()
    want = torch.full((rays.shape[0],), float("inf"), dtype=torch.float64)
    for k in range(2):
        world = (tri.double() + poses[0, k, :3, 3].double())            # (T, 3, 3)
        a, b, c = world[:, 0], world[:, 1], world[:, 2]
        e1, e2 = b - a, c - a
        p = torch.linalg.cross(rays[:, None], e2[None], dim=-1)
        det = (p * e1[None]).sum(-1)
        inv = 1.0 / det
        bu = -(a[None] * p).sum(-1) * inv
        q = torch.linalg.cross(-a[None].expand_as(p), e1[None].expand_as(p), dim=-1)
        bv = (rays[:, None] * q).sum(-1) * inv
        t = (e2[None] * q).sum(-1) * inv
        hit = (bu >= 0) & (bv >= 0) & (bu + bv <= 1) & (t > 0)
        t = torch.where(hit, t, torch.full_like(t, float("inf"))).amin(-1)
        want = torch.minimum(want, t)
    found = torch.isfinite(want)
    assert found.sum() > 100 and (~found).sum() > 100
    assert torch.equal(torch.isfinite(depth), found)
    assert torch.allclose(depth[found].double(), want[found], atol=1e-6)


def test_metric_readers_leave_out_what_the_program_lacks(monkeypatch):
    """The new per-layer metrics read the tracer's report; a program that marks no KKT
    stages and counts no structures (the parent commit's) gives nothing for them."""
    from types import SimpleNamespace

    from benchmark.harness import stages

    graph = "tracking_cycle_kinematic"
    found = SimpleNamespace(stages={graph: {"scene_render": (0.5, 10)}}, calls={graph: 10},
                            counters={}, spans=[])
    monkeypatch.setattr(stages, "report", lambda: found)

    def read(name):
        return spec.load_module("metrics", name).read(None)

    assert read("kin_stage_ms.scene_render") == pytest.approx(50.0)
    assert read("kin_stage_ms.kkt_solve") is None
    assert read("kkt_rows") is None
    found.stages[graph]["kkt_solve"] = (0.2, 10)
    found.counters.update({"kinematics.structures": 20, "kinematics.kkt_rows": 960})
    assert read("kin_stage_ms.kkt_solve") == pytest.approx(20.0)
    assert read("kkt_rows") == 48.0


def test_the_reference_loads_neither_jax_nor_the_program():
    out = subprocess.run(
        [sys.executable, "-c", "import sys\nimport benchmark.reference.kinematic\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=REPO, capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "m3t_tpu", "m3t_tpu_torch"}


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(4)
