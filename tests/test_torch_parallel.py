"""Parity tests: m3t_tpu_torch's scale-out and multi-camera fusion against the JAX
package on the CPU.

make_sharded_cycle (two cameras, with depth, the focused scene with every check, measured
occlusions on both modalities and texture terms) and initialize_multicamera_histograms
against the JAX ones on a (1, 1) mesh; one camera at cam2ref = I against the port's own
tracking_cycle_rgbd (and tracking_cycle_kinematic), bit for bit; make_sharded_kinematic_
cycle (two cameras, depth, per-link scenes, texture) against JAX; the sequence scans
against JAX without a mesh; the (data 2 x camera 2) dry run over four gloo processes
against one process; and the mesh and shard helpers.

Inputs: tests/test_pipeline.py::_build_batch (three 160x120 frames, 64 lines, scales (2,
1), 3x2 iterations), seen by a second camera 20 degrees to the side; the two-link structures
of tests/test_parallel.py::test_sharded_kinematic_scene_texture_equivalence (200x150).
Tolerances: poses and histograms atol 1e-4, as tests/test_torch_pipeline.py holds them;
the dry run 1e-6 (m3t_tpu_torch.parallel.dryrun.TOLERANCE).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from m3t_tpu import parallel as jparallel
from m3t_tpu import pipeline as jpipe
from m3t_tpu.common import np_pose
from m3t_tpu.depth_model import DepthModel
from m3t_tpu.link import Link, np_pose_variation
from m3t_tpu.ops import kinematics as jkin
from m3t_tpu.ops import occlusion as jocc
from m3t_tpu.ops.depth_fn import DepthConfig as JDepthConfig
from m3t_tpu.ops.raster import rasterize_np
from m3t_tpu.ops.region_fn import RegionConfig as JRegionConfig
from m3t_tpu.ops.texture_fn import TexturePoints as JTexturePoints
from m3t_tpu.optimizer import Optimizer
from m3t_tpu.region_model import RegionModel
from m3t_tpu_torch import parallel as tparallel
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.ops import kinematics as tkin
from m3t_tpu_torch.ops import occlusion as tocc
from m3t_tpu_torch.ops.depth_fn import DepthConfig as TDepthConfig
from m3t_tpu_torch.ops.region_fn import RegionConfig as TRegionConfig
from m3t_tpu_torch.ops.texture_fn import TexturePoints as TTexturePoints
from m3t_tpu_torch.parallel import dryrun
from m3t_tpu_torch.utils.procedural import orbit_camera
from tests import fixtures
from tests.test_pipeline import _build_batch

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-4
DEPTH_SCALE = 0.001
N_POINTS = 64


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_torch(record):
    """A JAX NamedTuple of arrays as the port's record of the same name (CPU)."""
    return {k: np.asarray(v) for k, v in record._asdict().items()}


def _jmesh():
    return JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "camera"))


def _assert_close(got, want, what):
    for name in want._fields:
        np.testing.assert_allclose(_n(getattr(got, name)), np.asarray(getattr(want, name)),
                                   rtol=0, atol=ATOL, err_msg=f"{what}: {name}")


def _pcfgs(**kw):
    common = dict(scales=(2, 1), standard_deviations=(5.0, 1.5), n_corr_iterations=3,
                  n_update_iterations=2, considered_distances=(0.03, 0.02),
                  depth_standard_deviations=(0.05, 0.03), **kw)
    return (jpipe.PipelineConfig(cfg=JRegionConfig(n_lines_max=64),
                                 depth_cfg=JDepthConfig(n_points_max=N_POINTS), **common),
            tpipe.PipelineConfig(cfg=TRegionConfig(n_lines_max=64),
                                 depth_cfg=TDepthConfig(n_points_max=N_POINTS), **common))


FULL_FLAGS = dict(use_depth=True, region_model_occlusions=True, region_checking=True,
                  region_measure_occlusions=True, depth_model_occlusions=True,
                  depth_silhouette_check=True, depth_measure_occlusions=True,
                  focused_image_size=128, use_texture=True)


@pytest.fixture(scope="module")
def rigid(tmp_path_factory):
    """_build_batch's two spheres over three frames, seen by the reference camera and by
    a camera 20 degrees to the side (frames rendered per (body, camera), colour and
    depth), their region and depth models, a cube occluder in the reference frame and
    texture matches per (body, camera)."""
    tmp = tmp_path_factory.mktemp("tpar")
    intr_t, bodies, models, gt_poses, frames = _build_batch(tmp, n_bodies=2, n_frames=3)
    b, c = len(bodies), 2
    cam2ref = np.stack([np.eye(4, dtype=np.float32), orbit_camera((0.0, 0.0, 0.575), 20.0, 3.0)])
    ref2cam = np.linalg.inv(cam2ref)
    rng = np.random.default_rng(12)
    images, depths = [], []
    for t in range(len(frames)):
        images.append(np.stack([np.stack(
            [frames[t][i]] + [fixtures.render_synthetic_color_frame(
                body, intr_t, ref2cam[1] @ gt_poses[t][i], noise_rng=rng)])
            for i, body in enumerate(bodies)]))
        depths.append(np.stack([np.stack([fixtures.render_synthetic_depth_frame(
            body, intr_t, ref2cam[k] @ gt_poses[t][i]) for k in range(c)])
            for i, body in enumerate(bodies)]))
    depth_models = [DepthModel(f"tpd{i}", body, str(tmp / f"tpd{i}.npz"), n_divides=1,
                               n_points=N_POINTS, image_size=200)
                    for i, body in enumerate(bodies)]
    assert all(m.SetUp() for m in depth_models)
    jmodel = jpipe.RegionModelArrays.from_models(models, 64)
    jdmodel = jpipe.DepthModelArrays.from_models(depth_models, N_POINTS)
    occluder = fixtures.cube_body("tpar_occluder", half=0.02)
    jscene = jocc.build_scene_geometry([[body, occluder] for body in bodies])
    occ_pose = np_pose(translation=[-0.03, 0.0, 0.4])
    k_tex = 16
    tex = (rng.normal(scale=0.03, size=(b, c, k_tex, 3)).astype(np.float32),
           rng.uniform(20, 140, size=(b, c, k_tex, 2)).astype(np.float32),
           rng.random((b, c, k_tex)) > 0.4)
    intr = tuple(np.float32(x) for x in (intr_t.fu, intr_t.fv, intr_t.ppu, intr_t.ppv))
    return dict(intr=intr, gt=gt_poses, cam2ref=cam2ref, images=np.stack(images),
                depths=np.stack(depths), jmodel=jmodel, jdmodel=jdmodel, jscene=jscene,
                occluders=np.stack([occ_pose[None]] * b), tex=tex,
                tmodel=tpipe.RegionModelArrays.from_numpy(_to_torch(jmodel), "cpu"),
                tdmodel=tpipe.DepthModelArrays.from_numpy(_to_torch(jdmodel), "cpu"),
                tscene=tocc.SceneGeometry.from_numpy(_to_torch(jscene), "cpu"))


def _rigid_extra(r, t, torch_side: bool, cameras=slice(None)):
    """The cycle's extra inputs at frame t: depth, scene, texture (cameras sliced)."""
    if torch_side:
        return (_t(r["depths"][t][:, cameras]), DEPTH_SCALE, r["tdmodel"], r["tscene"],
                _t(r["occluders"]), TTexturePoints(*(_t(a[:, cameras]) for a in r["tex"])))
    return (jnp.asarray(r["depths"][t]), jnp.float32(DEPTH_SCALE), r["jdmodel"], r["jscene"],
            jnp.asarray(r["occluders"]), JTexturePoints(*(jnp.asarray(a) for a in r["tex"])))


def test_initialize_multicamera_histograms_matches_jax(rigid):
    r = rigid
    jpcfg, tpcfg = _pcfgs(**FULL_FLAGS)
    want = jpipe.initialize_multicamera_histograms(
        jpcfg, r["intr"], jnp.asarray(r["images"][0]), jnp.asarray(r["cam2ref"]),
        r["jmodel"], jnp.asarray(r["gt"][0]))
    got = tpipe.initialize_multicamera_histograms(
        tpcfg, r["intr"], _t(r["images"][0]), _t(r["cam2ref"]), r["tmodel"], _t(r["gt"][0]))
    assert got.histogram_f.shape == (2, 2, 4096)
    _assert_close(got, want, "StartModality")
    # The second camera sees the bodies from the side: its histograms are its own.
    assert not torch.equal(got.histogram_f[:, 0], got.histogram_f[:, 1])


def test_sharded_cycle_matches_jax_and_tracks(rigid):
    """Two cameras, depth fusion, the focused scene with all four checks, measured
    occlusions on both modalities and texture terms: two cycles against the JAX
    cycle on a (1, 1) mesh, poses and histograms after each."""
    r = rigid
    jpcfg, tpcfg = _pcfgs(**FULL_FLAGS)
    cam2ref = r["cam2ref"]
    j_state = jpipe.initialize_multicamera_histograms(
        jpcfg, r["intr"], jnp.asarray(r["images"][0]), jnp.asarray(cam2ref), r["jmodel"],
        jnp.asarray(r["gt"][0]))
    t_state = tpipe.MultiCameraState(*(_t(a) for a in j_state))
    jcycle = jpipe.make_sharded_cycle(jpcfg, _jmesh(), r["intr"], depth_intr=r["intr"],
                                      with_depth=True, with_scene=True, with_texture=True)
    tcycle = tpipe.make_sharded_cycle(tpcfg, None, r["intr"], depth_intr=r["intr"],
                                      with_depth=True, with_scene=True, with_texture=True)
    for t in range(1, len(r["images"])):
        j_state = jcycle(jnp.asarray(r["images"][t]), jnp.asarray(cam2ref), r["jmodel"],
                         j_state, *_rigid_extra(r, t, False))
        t_state = tcycle(_t(r["images"][t]), _t(cam2ref), r["tmodel"], t_state,
                         *_rigid_extra(r, t, True))
        _assert_close(t_state, j_state, f"cycle {t}")
    est = t_state.body2reference_pose.numpy()
    err = np.linalg.norm(est[:, :3, 3] - r["gt"][-1][:, :3, 3], axis=1)
    assert np.all(np.isfinite(est)) and np.all(err < 0.005), f"translation errors {err}"


@pytest.mark.parametrize("handle_occlusions", [None, [False, True]])
def test_one_camera_equals_tracking_cycle_rgbd(rigid, handle_occlusions):
    """C == 1 at cam2ref = I: the multi-camera cycle is tracking_cycle_rgbd, bit for
    bit, with the same scene, measured occlusions, texture and occlusion handling."""
    r = rigid
    _, tpcfg = _pcfgs(**FULL_FLAGS)
    images0 = _t(r["images"][0][:, :1])
    start = tpipe.initialize_multicamera_histograms(tpcfg, r["intr"], images0,
                                                    torch.eye(4)[None], r["tmodel"],
                                                    _t(r["gt"][0]))
    single = tpipe.initialize_histograms(tpcfg, r["intr"], images0[:, 0], r["tmodel"],
                                         _t(r["gt"][0]))
    for got, want in zip(start, single):
        assert torch.equal(got.reshape(want.shape), want)
    handle = None if handle_occlusions is None else _t(handle_occlusions)
    depth, scale, dmodel, scene, occ, tex = _rigid_extra(r, 1, True, slice(0, 1))
    got = tpipe.make_sharded_cycle(tpcfg, None, r["intr"], r["intr"], with_depth=True,
                                   with_scene=True, with_texture=True)(
        _t(r["images"][1][:, :1]), torch.eye(4)[None], r["tmodel"], start, depth, scale,
        dmodel, scene, occ, tex, handle_occlusions=handle)
    want = tpipe.tracking_cycle_rgbd(
        tpcfg, r["intr"], r["intr"], scale, _t(r["images"][1][:, 0]), depth[:, 0],
        r["tmodel"], dmodel, single, scene_geom=scene, occluder_poses=occ,
        handle_occlusions=handle, texture_points=TTexturePoints(*(a[:, 0] for a in tex)))
    for got_field, want_field in zip(got, want):
        assert torch.equal(got_field.reshape(want_field.shape), want_field)


# ---------------------------------------------------------------------------------------
# Articulated structures
# ---------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def articulated(tmp_path_factory):
    """The two-link structures of tests/test_parallel.py (a child sphere in front of and
    beside its parent, revolute about z) in two poses, seen by the reference camera and
    a second camera 15 degrees to the side, with region and depth models of both links,
    per-link scenes and texture matches per (structure, link, camera)."""
    tmp = tmp_path_factory.mktemp("tpark")
    parent = fixtures.sphere_body("tpk_parent", radius=0.05, n_subdiv=2)
    child = fixtures.sphere_body("tpk_child", radius=0.04, n_subdiv=2)
    intr_t = fixtures.test_intrinsics(200, 150)
    body2joint_child = np_pose(translation=[0.05, 0.0, -0.045])
    s, c, nl = 2, 2, 2
    roots = [np_pose(translation=[-0.04, 0.0, 0.7]), np_pose(translation=[-0.02, 0.01, 0.75])]
    cam2ref = np.stack([np.eye(4, dtype=np.float32), orbit_camera((-0.03, 0.0, 0.72), 15.0,
                                                                  2.0)])
    ref2cam = np.linalg.inv(cam2ref)

    def child_pose(root, angle):
        return root @ np_pose_variation(np.array([0, 0, angle, 0, 0, 0], np.float32)) @ \
            body2joint_child

    def render(poses, rng):
        verts, ids = [], []
        for i, (body, pose) in enumerate(zip([parent, child], poses)):
            tri = body.triangle_vertices_f_body()
            verts.append(tri @ pose[:3, :3].T + pose[:3, 3])
            ids.append(np.full(len(tri), i + 1))
        depth, id_img = rasterize_np(np.concatenate(verts), np.concatenate(ids), intr_t.fu,
                                     intr_t.fv, intr_t.ppu, intr_t.ppv, intr_t.width,
                                     intr_t.height, cull_backfaces=True)
        colors = [(40, 120, 190), (170, 60, 40), (60, 170, 60)]
        image = np.empty((intr_t.height, intr_t.width, 3), np.uint8)
        image[:] = colors[0]
        for i in range(2):
            image[id_img == i + 1] = colors[i + 1]
        image = np.clip(image.astype(np.int16) + rng.integers(-6, 7, image.shape), 0, 255
                        ).astype(np.uint8)
        d = np.where(np.isfinite(depth), depth / DEPTH_SCALE, 0.0)
        return image, np.clip(d, 0, 65535).astype(np.uint16)

    rng = np.random.default_rng(31)
    images, depths = [], []
    for angle in (0.0, 0.05):
        per = [[render([cam @ root, cam @ child_pose(root, angle)], rng) for cam in ref2cam]
               for root in roots]
        images.append(np.stack([[f[0] for f in p] for p in per]))
        depths.append(np.stack([[f[1] for f in p] for p in per]))

    models = [RegionModel(f"tpk_rm{i}", body, str(tmp / f"r{i}.npz"), n_divides=1,
                          n_points=64, image_size=200) for i, body in enumerate((parent, child))]
    dmodels = [DepthModel(f"tpk_dm{i}", body, str(tmp / f"d{i}.npz"), n_divides=1,
                          n_points=N_POINTS, image_size=200)
               for i, body in enumerate((parent, child))]
    assert all(m.SetUp() for m in models + dmodels)
    optimizers = []
    for k, root in enumerate(roots):
        lp = Link(f"tpk_lp{k}", parent)
        lc = Link(f"tpk_lc{k}", child, body2joint_pose=body2joint_child,
                  free_directions=[False, False, True, False, False, False])
        lp.AddChildLink(lc)
        assert lc.SetUp() and lp.SetUp()
        lp.set_link2world_pose(root)
        opt = Optimizer(f"tpk_o{k}", lp)
        assert opt.SetUp()
        optimizers.append(opt)
    jmodel = jpipe.RegionModelArrays.from_models(models * s, 64)
    jdmodel = jpipe.DepthModelArrays.from_models(dmodels * s, N_POINTS)
    jscene = jocc.build_kinematic_scene_geometry([[parent, child]] * s)
    k_tex = 16
    tex = (rng.normal(scale=0.02, size=(s, nl, c, k_tex, 3)).astype(np.float32),
           rng.uniform(30, 140, size=(s, nl, c, k_tex, 2)).astype(np.float32),
           rng.random((s, nl, c, k_tex)) > 0.4)
    return dict(intr=tuple(np.float32(x) for x in (intr_t.fu, intr_t.fv, intr_t.ppu,
                                                   intr_t.ppv)),
                cam2ref=cam2ref, images=images, depths=depths, tex=tex,
                jkin=jkin.build_kinematic_model(optimizers),
                tkin=tkin.build_kinematic_model(optimizers, device="cpu"),
                jp0=jkin.initial_joint2parent(optimizers), jmodel=jmodel, jdmodel=jdmodel,
                jscene=jscene, tmodel=tpipe.RegionModelArrays.from_numpy(_to_torch(jmodel),
                                                                         "cpu"),
                tdmodel=tpipe.DepthModelArrays.from_numpy(_to_torch(jdmodel), "cpu"),
                tscene=tocc.SceneGeometry.from_numpy(_to_torch(jscene), "cpu"))


def _kin_pcfgs():
    return _pcfgs(use_depth=True, region_model_occlusions=True, region_checking=True,
                  depth_model_occlusions=True, depth_silhouette_check=True,
                  depth_measure_occlusions=True, focused_image_size=128, use_texture=True)


def _kin_start(a, pcfgs, cameras):
    """The JAX test's start: single-camera StartModality on the first camera's frames,
    the histograms repeated for every camera."""
    jpcfg, _ = pcfgs
    start = jpipe.initialize_kinematic_histograms(
        jpcfg, a["intr"], jnp.asarray(a["images"][0][:, 0]), a["jmodel"], a["jkin"],
        jnp.asarray(a["jp0"]))
    s, nl, n = start.histogram_f.shape
    hist = [np.broadcast_to(np.asarray(h)[:, :, None], (s, nl, cameras, n)).copy()
            for h in start[1:]]
    return start, jpipe.KinematicMultiCameraState(jnp.asarray(a["jp0"]), *map(jnp.asarray,
                                                                            hist))


def test_sharded_kinematic_cycle_matches_jax(articulated):
    """Two cameras, depth fusion with measured depth occlusions, per-link scenes with
    every check and texture terms: one cycle against the JAX cycle on a (1, 1) mesh,
    joint poses and histograms."""
    a = articulated
    jpcfg, tpcfg = pcfgs = _kin_pcfgs()
    _, j_state = _kin_start(a, pcfgs, 2)
    no_extra = np.zeros((2, 0, 4, 4), np.float32)
    want = jpipe.make_sharded_kinematic_cycle(
        jpcfg, _jmesh(), a["intr"], depth_intr=a["intr"], with_depth=True, with_scene=True,
        with_texture=True)(
        jnp.asarray(a["images"][1]), jnp.asarray(a["cam2ref"]), a["jmodel"], a["jkin"],
        j_state, jnp.asarray(a["depths"][1]), jnp.float32(DEPTH_SCALE), a["jdmodel"],
        a["jscene"], jnp.asarray(no_extra), JTexturePoints(*map(jnp.asarray, a["tex"])))
    got = tpipe.make_sharded_kinematic_cycle(
        tpcfg, None, a["intr"], depth_intr=a["intr"], with_depth=True, with_scene=True,
        with_texture=True)(
        _t(a["images"][1]), _t(a["cam2ref"]), a["tmodel"], a["tkin"],
        tpipe.KinematicMultiCameraState(*(_t(x) for x in j_state)), _t(a["depths"][1]),
        DEPTH_SCALE, a["tdmodel"], a["tscene"], _t(no_extra),
        TTexturePoints(*map(_t, a["tex"])))
    assert got.histogram_f.shape == (2, 2, 2, 4096)
    _assert_close(got, want, "kinematic cycle")
    assert not np.allclose(got.joint2parent.numpy(), a["jp0"], atol=1e-6)


def test_one_camera_equals_tracking_cycle_kinematic(articulated):
    """C == 1 at cam2ref = I: the multi-camera articulated cycle is
    tracking_cycle_kinematic, bit for bit."""
    a = articulated
    _, tpcfg = _kin_pcfgs()
    jp0 = _t(a["jp0"])
    start = tpipe.initialize_kinematic_histograms(tpcfg, a["intr"], _t(a["images"][0][:, 0]),
                                                  a["tmodel"], a["tkin"], jp0)
    state = tpipe.KinematicMultiCameraState(jp0, start.histogram_f[:, :, None],
                                            start.histogram_b[:, :, None])
    tex = TTexturePoints(*(_t(x[:, :, :1]) for x in a["tex"]))
    got = tpipe.make_sharded_kinematic_cycle(
        tpcfg, None, a["intr"], depth_intr=a["intr"], with_depth=True, with_scene=True,
        with_texture=True)(
        _t(a["images"][1][:, :1]), torch.eye(4)[None], a["tmodel"], a["tkin"], state,
        _t(a["depths"][1][:, :1]), DEPTH_SCALE, a["tdmodel"], a["tscene"], None, tex)
    want = tpipe.tracking_cycle_kinematic(
        tpcfg, a["intr"], _t(a["images"][1][:, 0]), a["tmodel"], a["tkin"], start,
        scene_geom=a["tscene"], depth_intr=a["intr"], depth_scale=DEPTH_SCALE,
        depth_images=_t(a["depths"][1][:, 0]), depth_model=a["tdmodel"],
        texture_points=TTexturePoints(*(x.reshape((4,) + x.shape[3:]) for x in tex)))
    for got_field, want_field in zip(got, want):
        assert torch.equal(got_field.reshape(want_field.shape), want_field)


# ---------------------------------------------------------------------------------------
# Sequence scans, meshes and the dry run
# ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("rgbd", [False, True])
def test_track_sequences_scan_matches_jax(rigid, rgbd):
    """Both sequences over the two tracked frames (the reference camera's), without a
    mesh: poses (T, B, 4, 4) and the final state against the JAX scan."""
    r = rigid
    jpcfg, tpcfg = _pcfgs(use_depth=rgbd)
    frames = r["images"][:, :, 0]
    depths = r["depths"][:, :, 0]
    j_start = jpipe.initialize_histograms(jpcfg, r["intr"], jnp.asarray(frames[0]),
                                          r["jmodel"], jnp.asarray(r["gt"][0]))
    t_start = tpipe.TrackingState(*(_t(x) for x in j_start))
    if rgbd:
        j_final, j_poses = jparallel.sharding.track_sequences_scan_rgbd(
            jpcfg, r["intr"], r["intr"], jnp.float32(DEPTH_SCALE), jnp.asarray(frames[1:]),
            jnp.asarray(depths[1:]), r["jmodel"], r["jdmodel"], j_start)
        t_final, t_poses = tparallel.track_sequences_scan_rgbd(
            tpcfg, r["intr"], r["intr"], DEPTH_SCALE, _t(frames[1:]), _t(depths[1:]),
            r["tmodel"], r["tdmodel"], t_start)
    else:
        j_final, j_poses = jparallel.track_sequences_scan(
            jpcfg, r["intr"], jnp.asarray(frames[1:]), r["jmodel"], j_start)
        t_final, t_poses = tparallel.track_sequences_scan(tpcfg, r["intr"], _t(frames[1:]),
                                                          r["tmodel"], t_start)
    assert t_poses.shape == (2, 2, 4, 4)
    np.testing.assert_allclose(t_poses.numpy(), np.asarray(j_poses), rtol=0, atol=ATOL)
    _assert_close(t_final, j_final, "final state")
    assert torch.equal(t_poses[-1], t_final.body2camera_pose)


def test_make_mesh_and_shard_over_in_one_process():
    mesh = tparallel.make_mesh()
    assert mesh == tparallel.Mesh(1, 1, 0, 0, None, None)
    with pytest.raises(ValueError):
        tparallel.make_mesh(n_data=2)
    x = torch.arange(2 * 4 * 6).reshape(2, 4, 6)
    assert tparallel.shard_over(x, None) is x
    # Rank 5 of a (3, 2) mesh: data index 2, camera index 1.
    mesh = tparallel.Mesh(3, 2, 2, 1, None, None)
    state = tpipe.TrackingState(torch.arange(6)[:, None].float(), torch.arange(12).reshape(6, 2),
                                None)
    got = tparallel.shard_over(state, mesh, "data")
    assert got.body2camera_pose.flatten().tolist() == [4.0, 5.0] and got.histogram_b is None
    assert got.histogram_f.tolist() == [[8, 9], [10, 11]]
    assert torch.equal(tparallel.shard_over(x, mesh, "camera", dim=1), x[:, 2:])
    assert tparallel.shard_over((x, None), mesh, "camera")[0].data_ptr() == x[1].data_ptr()
    with pytest.raises(TypeError):
        tparallel.shard_over([x], mesh)
    with pytest.raises(ValueError):
        tparallel.shard_over(x, mesh, "data", dim=1)
    with pytest.raises(ValueError):
        tparallel.shard_over(x, mesh, "time")


def _dryrun(*args, timeout=300):
    return subprocess.run([sys.executable, "-m", "m3t_tpu_torch.parallel.dryrun", *args],
                          cwd=REPO, capture_output=True, text=True, timeout=timeout)


def test_dryrun_four_processes_equal_one():
    """A (data 2 x camera 2) mesh of four gloo processes on the CPU: the rigid cycle with
    depth and scene checks, the articulated cycle and both scans equal one process
    within 1e-6."""
    proc = _dryrun("--processes", "4", "--device", "cpu", "--backend", "gloo")
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith('{"dryrun"'))
    import json

    result = json.loads(line)["dryrun"]
    assert result["ok"] and result["mesh"] == [2, 2] and result["processes"] == 4
    assert max(result["max_abs_diff"].values()) <= dryrun.TOLERANCE
    assert result["shapes"]["rigid_histogram_f"] == [4, 2, 4096]
    assert "exit codes [0, 0, 0, 0]" in proc.stdout


def test_dryrun_fails_when_a_rank_fails():
    """A backend that cannot start (NCCL on the CPU) fails every rank: the run exits
    non-zero and switches to no other backend."""
    proc = _dryrun("--processes", "2", "--device", "cpu", "--backend", "nccl")
    assert proc.returncode != 0
    assert '{"dryrun"' not in proc.stdout


def test_dryrun_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    assert dryrun.main(["--processes", "1", "--device", "cuda"]) == 1
