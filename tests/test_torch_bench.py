"""The benchmark runner ``python -m m3t_tpu_torch.bench`` against bench.py on the CPU.

bench.py is neither imported nor run: its main() imports JAX and runs everything at once.
The JAX side of these tests builds each mode's workload with m3t_tpu exactly as
bench.py:100-363 builds it (one np.random.default_rng(0), drawn in bench.py's order), at
B=2, with the JAX RegionModel and DepthModel reading a copy of the committed npz (both
packages write and read the same files).  Labels and JSON keys are taken from bench.py's
own source.  Body ids are counted from 1 in both packages, as in a fresh process.

Tolerances: each mode's PipelineConfig field by field, frames, initial poses, model
arrays, texture points and the integer fields of the scenes exactly; the scenes' float fields, the kinematic model, joint poses and
the kinematic state within 1e-6; one region cycle's poses and histograms within atol
1e-4, as the other cycle parity tests hold them.
"""

import ast
import copy
import itertools
import json
import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import m3t_tpu.body
import m3t_tpu_torch.body
from m3t_tpu import pipeline as jpipe
from m3t_tpu.common import Intrinsics as JIntrinsics
from m3t_tpu.constraint import Constraint
from m3t_tpu.depth_model import DepthModel
from m3t_tpu.link import Link
from m3t_tpu.ops import kinematics as jkin
from m3t_tpu.ops import occlusion as jocc
from m3t_tpu.ops.raster import decimate_mesh
from m3t_tpu.ops.region_fn import RegionConfig
from m3t_tpu.ops.texture_fn import TexturePoints
from m3t_tpu.optimizer import Optimizer
from m3t_tpu.region_model import RegionModel
from m3t_tpu.utils import procedural as jproc
from m3t_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "m3t_tpu_torch" / "data"
MODES = ("region",) + bench.MODES
B = 2


def _bench_source():
    return ast.parse((REPO / "bench.py").read_text())


def _bench_labels(n_bodies: int, n_tri: int, s_structs: int) -> dict:
    """bench.py's label f-strings evaluated, by mode (their order in bench.py:228-370)."""
    values = [node.value for node in sorted(
        (node for node in ast.walk(_bench_source()) if isinstance(node, ast.Assign)
         and any(isinstance(t, ast.Name) and t.id == "label" for t in node.targets)),
        key=lambda node: node.lineno)]
    names = dict(n_bodies=n_bodies, n_tri=n_tri, s_structs=s_structs)
    labels = [eval(compile(ast.Expression(v), "bench.py", "eval"), {}, names)
              for v in values]
    return dict(zip(("ycb", "rgbd", "occlusion", "kinematic_rgbd", "kinematic", "region"),
                    labels, strict=True))


def _bench_keys() -> list:
    """The key sets of bench.py's two printed JSON objects (latency first)."""
    calls = sorted((node for node in ast.walk(_bench_source()) if isinstance(node, ast.Call)
                    and getattr(node.func, "attr", None) == "dumps"),
                   key=lambda node: node.lineno)
    return [{k.value for k in node.args[0].keys} for node in calls]


@pytest.fixture(autouse=True)
def fresh_ids(monkeypatch):
    """Body ids counted from 1 in both packages, the port's model caches in a temporary
    directory of its own, and one PyTorch thread (the test workers share the cores)."""
    for module in (m3t_tpu.body, m3t_tpu_torch.body):
        monkeypatch.setattr(module, "_next_body_id", itertools.count(1))
    directory = tempfile.mkdtemp(prefix="m3t_bench_test_")
    monkeypatch.setattr(tempfile, "tempdir", directory)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    shutil.rmtree(directory, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_base(tmp_path_factory):
    """bench.py's models (m3t_tpu, from copies of the committed npz), its intrinsics,
    its colour and depth frames, and its generator after the frame's noise."""
    tmp = tmp_path_factory.mktemp("bench_models")
    body = jproc.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    models = {}
    for cls, name, file in ((RegionModel, "bench_model", "region"),
                            (DepthModel, "bench_depth_model", "depth")):
        path = tmp / f"m3t_bench_{file}_model.npz"
        shutil.copyfile(DATA / f"bench_sphere_{file}_model.npz", path)
        model = cls(name, body, str(path), n_divides=2, n_points=200, image_size=800)
        assert model.SetUp()
        models[file] = model
    intr_t = JIntrinsics(fu=520.0, fv=520.0, ppu=640 / 2 - 0.5, ppv=512 / 2 - 0.5,
                         width=640, height=512)
    rng = np.random.default_rng(0)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.6
    frame = jproc.render_synthetic_color_frame(body, intr_t, pose0, noise_rng=rng)
    return dict(
        model_1=jpipe.RegionModelArrays.from_models([models["region"]], 200),
        dm_1=jpipe.DepthModelArrays.from_models([models["depth"]], 200),
        intr_t=intr_t, pose0=pose0, rng=rng,
        planar=np.ascontiguousarray(np.moveaxis(frame, -1, 0)),
        depth_frame=jproc.render_synthetic_depth_frame(body, intr_t, pose0))


def _jax_pcfg(mode: str):
    """bench.py's PipelineConfig of mode (bench.py:104-116, 208, 246-247, 319-320,
    333-334)."""
    pcfg = jpipe.PipelineConfig(
        cfg=RegionConfig(n_lines_max=200),
        scales=(6, 4, 2, 1), standard_deviations=(15.0, 5.0, 3.5, 1.5),
        n_corr_iterations=5, n_update_iterations=2,
        use_depth=(mode in ("rgbd", "kinematic_rgbd", "ycb")))
    if mode == "ycb":
        pcfg = pcfg._replace(
            scales=(7, 4, 2), standard_deviations=(25.0, 15.0, 10.0),
            n_corr_iterations=4, region_measure_occlusions=True,
            depth_measure_occlusions=True, use_texture=True)
    if mode in ("occlusion", "kinematic", "kinematic_rgbd"):
        pcfg = pcfg._replace(region_model_occlusions=True, region_checking=True,
                             focused_image_size=128)
    if mode in ("rgbd", "ycb", "kinematic_rgbd"):
        pcfg = pcfg._replace(depth_cfg=pcfg.depth_cfg._replace(n_points_max=200))
    return pcfg


def _equal_configs(got, want, name):
    """Two configs (NamedTuples of numbers, tuples and NamedTuples) field by field."""
    assert type(got).__name__ == type(want).__name__, name
    assert got._fields == want._fields, name
    for field in want._fields:
        g, w = getattr(got, field), getattr(want, field)
        if hasattr(w, "_fields"):
            _equal_configs(g, w, f"{name}.{field}")
        else:
            assert type(g) is type(w) and g == w, (f"{name}.{field}", g, w)


def _jax_workload(base, mode: str, n_bodies: int) -> dict:
    """bench.py's inputs of mode at n_bodies, as numpy (bench.py:100-363)."""
    rng = copy.deepcopy(base["rng"])
    pose0, planar = base["pose0"], base["planar"]
    body = jproc.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    out = dict(images=planar, model=base["model_1"], pcfg=_jax_pcfg(mode))
    poses = np.tile(pose0, (n_bodies, 1, 1))
    poses[:, 0, 3] += rng.uniform(-0.004, 0.004, n_bodies).astype(np.float32)
    poses[:, 1, 3] += rng.uniform(-0.004, 0.004, n_bodies).astype(np.float32)
    out["poses"] = poses
    if mode == "latency":
        out["latency_poses"] = []
        for b_lat in (1, 8, 64):
            poses_l = np.tile(pose0, (b_lat, 1, 1))
            poses_l[:, 0, 3] += rng.uniform(-0.004, 0.004, b_lat).astype(np.float32)
            out["latency_poses"].append(poses_l)
        return out
    if mode in ("rgbd", "ycb", "kinematic_rgbd"):
        out.update(depth_images=base["depth_frame"], depth_model=base["dm_1"])
    if mode == "ycb":
        k_tex = 128
        out["texture_points"] = TexturePoints(
            jnp.asarray(rng.normal(scale=0.04, size=(n_bodies, k_tex, 3)), jnp.float32),
            jnp.asarray(rng.uniform(0, 640, size=(n_bodies, k_tex, 2)), jnp.float32),
            jnp.asarray(rng.random((n_bodies, k_tex)) > 0.3))
    if mode == "occlusion":
        v, t = decimate_mesh(body.vertices, body.triangles, 256)
        tv = v[t]
        n_tri = len(tv)
        out["n_tri"] = n_tri
        out["scene_geom"] = jocc.SceneGeometry(
            triangles=jnp.broadcast_to(jnp.asarray(tv), (n_bodies,) + tv.shape),
            owner=jnp.zeros((n_bodies, n_tri), jnp.int32),
            sil_id=jnp.full((n_bodies, n_tri),
                            (int(body.body_id) << 8) | int(body.region_id), jnp.int32),
            tri_valid=jnp.ones((n_bodies, n_tri), bool),
            cull=jnp.ones((n_bodies, n_tri), bool),
            ref_owner=jnp.zeros((n_bodies, 1), jnp.int32),
            ref_radius=jnp.full((n_bodies, 1), 0.5 * body.maximum_body_diameter,
                                jnp.float32),
            ref_valid=jnp.ones((n_bodies, 1), bool),
            body_id=jnp.full((n_bodies,), int(body.body_id), jnp.int32),
            region_id=jnp.full((n_bodies,), int(body.region_id), jnp.int32))
    if mode in ("kinematic", "kinematic_rgbd"):
        s_structs = max(n_bodies // 2, 1)
        b2j = np.eye(4, dtype=np.float32)
        b2j[0, 3] = 0.13
        link_p = Link("bench_lp", body)
        link_c = Link("bench_lc", body, body2joint_pose=b2j,
                      free_directions=[False, False, True, False, False, False])
        link_p.AddChildLink(link_c)
        assert link_c.SetUp() and link_p.SetUp()
        link_p.set_link2world_pose(pose0)
        constraint = Constraint(
            "bench_constraint", link_p, link_c, body22joint2_pose=b2j,
            constraint_directions=[True, True, False, True, True, True])
        assert constraint.SetUp()
        opt = Optimizer("bench_opt", link_p)
        opt.AddConstraint(constraint)
        assert opt.SetUp()
        kin_1 = jkin.build_kinematic_model([opt])
        out["kin"] = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (s_structs,) + a.shape[1:]), kin_1)
        jp = jnp.broadcast_to(jnp.asarray(jkin.initial_joint2parent([opt])),
                              (s_structs, 2, 4, 4))
        n_hist = RegionConfig().n_histogram_bins ** 3
        out["state"] = jpipe.KinematicTrackingState(
            jp, jnp.full((s_structs, 2, n_hist), 1.0 / n_hist, jnp.float32),
            jnp.full((s_structs, 2, n_hist), 1.0 / n_hist, jnp.float32))
        scene_1 = jocc.build_kinematic_scene_geometry([[body, body]], decimate_to=128)
        out["scene_geom"] = jax.tree_util.tree_map(
            lambda a: jnp.tile(a, (s_structs,) + (1,) * (a.ndim - 1)), scene_1)
        out["s_structs"] = s_structs
    return out


def _equal(got, want, err_msg, atol=0.0):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (err_msg, got.shape, want.shape)
    if atol or want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=err_msg)
    else:
        np.testing.assert_array_equal(got, want, err_msg=err_msg)


def _equal_records(got, want, name, float_atol=0.0, n=None):
    for field in type(want)._fields:
        w = np.asarray(getattr(want, field))
        g = getattr(got, field)
        if n is not None:
            w = np.broadcast_to(w, (n,) + w.shape[1:])
        _equal(g, w, f"{name}.{field}", float_atol if w.dtype.kind == "f" else 0.0)


@pytest.mark.parametrize("mode", MODES)
def test_workload_matches_bench_py(mode, jax_base):
    """The runner's inputs of every mode equal bench.py's at B=2."""
    want = _jax_workload(jax_base, mode, B)
    works = bench.build_workload(mode, B, "cpu")
    assert len(works) == (3 if mode == "latency" else 1)
    for work in works:
        _equal_configs(work.pcfg, want["pcfg"], "pcfg")
    if mode == "latency":
        for work, poses, n in zip(works, want["latency_poses"], bench.LATENCY_BATCHES):
            assert work.body_frames == n
            _equal(work.inputs["poses"], poses, f"poses at B={n}")
            _equal(work.state.body2camera_pose, poses, f"state poses at B={n}")
            _equal(work.inputs["images"], np.broadcast_to(want["images"], (n, 3, 512, 640)),
                   "images")
            _equal_records(work.inputs["model"], want["model"], "model", n=n)
        return
    work = works[0]
    inp = work.inputs
    kinematic = mode.startswith("kinematic")
    n_frames = want["s_structs"] if kinematic else B
    _equal(inp["images"], np.broadcast_to(want["images"], (n_frames, 3, 512, 640)),
           "images")
    _equal(inp["poses"], want["poses"], "poses")
    _equal_records(inp["model"], want["model"], "model", n=B)
    if "depth_images" in want:
        _equal(inp["depth_images"],
               np.broadcast_to(want["depth_images"], (n_frames, 512, 640)), "depth images")
        _equal_records(inp["depth_model"], want["depth_model"], "depth model", n=B)
    else:
        assert "depth_images" not in inp
    if mode == "ycb":
        _equal_records(inp["texture_points"], want["texture_points"], "texture points")
    if "scene_geom" in want:
        _equal_records(inp["scene_geom"], want["scene_geom"], "scene", float_atol=1e-6)
    if kinematic:
        _equal_records(inp["kin"], want["kin"], "kinematic model", float_atol=1e-6)
        _equal_records(work.state, want["state"], "kinematic state", float_atol=1e-6)
    else:
        _equal(work.state.body2camera_pose, want["poses"], "state poses")
    assert work.body_frames == B
    assert work.label == _bench_labels(B, want.get("n_tri", 0), want.get("s_structs", 0))[mode]


def test_bench_region_cycle_matches_jax(jax_base):
    """One cycle of the region workload at B=2 from equal inputs: the port's
    initialize_histograms and tracking_cycle against JAX's jitted ones."""
    work = bench.build_workload("region", B, "cpu")[0]
    want = _jax_workload(jax_base, "region", B)
    pcfg = want["pcfg"]
    intr = tuple(np.float32(getattr(jax_base["intr_t"], k)) for k in ("fu", "fv", "ppu", "ppv"))
    images = jnp.asarray(np.broadcast_to(want["images"], (B, 3, 512, 640)))
    model = jax.tree_util.tree_map(lambda a: jnp.broadcast_to(a, (B,) + a.shape[1:]),
                                   want["model"])
    state = jpipe.initialize_histograms(pcfg, intr, images, model, jnp.asarray(want["poses"]))
    for field in ("histogram_f", "histogram_b"):
        _equal(getattr(work.state, field), getattr(state, field), field, atol=1e-4)
    jstate = jpipe.tracking_cycle(pcfg, intr, images, model, state)
    tstate = work.cycle(work.state)
    for field in jpipe.TrackingState._fields:
        _equal(getattr(tstate, field), getattr(jstate, field), field, atol=1e-4)
    assert np.abs(np.asarray(jstate.body2camera_pose) - want["poses"]).max() > 1e-6


@pytest.mark.parametrize("extra", [(), ("--latency",)], ids=["region", "latency"])
def test_cli_prints_one_json_line(extra, capsys):
    assert bench.main(["--device", "cpu", "--bodies", "2", "--iters", "3", "--windows",
                       "1", *extra]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[-1])
    latency_keys, keys = _bench_keys()
    assert set(result) == (latency_keys if extra else keys) | {"device"}
    assert result["device"] == {"name": "cpu"}
    assert np.isfinite(result["value"]) and result["value"] > 0
    if extra:
        assert set(result["latency_ms_per_cycle"]) == {"1", "8", "64"}
    else:
        assert result["windows"] == 1
        assert result["metric"] == _bench_labels(2, 0, 0)["region"]


def test_bench_needs_a_card(monkeypatch):
    """Without a card and without --device cpu, main() raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr(bench, "build_workload", lambda *a: built.append(a))
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main([])
    assert not built


def test_model_cache_that_differs_is_replaced():
    """A model cache file that differs from the committed npz (bench.py's own, or stale)
    is replaced by the committed one before the model loads; an equal one is kept."""
    from m3t_tpu_torch.region_model import RegionModel
    from m3t_tpu_torch.utils import procedural

    body = procedural.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    path = Path(tempfile.gettempdir()) / "m3t_bench_region_model.npz"
    committed = DATA / "bench_sphere_region_model.npz"
    path.write_bytes(committed.read_bytes()[:-1] + b"\0")
    model = bench._cached_model(RegionModel, "bench_model", body, "region")
    assert path.read_bytes() == committed.read_bytes()
    assert model.orientations.shape[0] == 162
    before = path.stat().st_mtime_ns
    bench._cached_model(RegionModel, "bench_model", body, "region")
    assert path.stat().st_mtime_ns == before
