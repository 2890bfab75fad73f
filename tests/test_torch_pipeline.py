"""Parity tests: m3t_tpu_torch's pose math, histogram blend, LDLT solve and the fused
tracking cycles (initialize_histograms + tracking_cycle, and tracking_cycle_rgbd, on the
CPU) against the JAX package, plus the models carried across as data and the package's
import boundary.

Cycle inputs are tests/test_pipeline.py::_build_batch (160x120 frames, 64 lines,
scales (2, 1), 3x2 iterations); the RGB-D cycle adds depth models and depth frames as
tests/test_parallel.py::test_rgbd_fused_cycle builds them.  Tolerances: poses atol 1e-4
(float32 reductions summed in another order); histograms atol 1e-4, because one walk
pixel that lands on the other side of an integer boundary moves a bin by about lr/total.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu import common as jcommon
from m3t_tpu import pipeline as jpipe
from m3t_tpu.ops import histogram as jhist
from m3t_tpu.ops.depth_fn import DepthConfig as JDepthConfig
from m3t_tpu.ops.region_fn import RegionConfig as JRegionConfig
from m3t_tpu_torch import common as tcommon
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.ops import histogram as thist
from m3t_tpu_torch.ops import newton as tnewton
from m3t_tpu_torch.ops.depth_fn import DepthConfig as TDepthConfig
from m3t_tpu_torch.ops.region_fn import RegionConfig as TRegionConfig
from tests import fixtures
from tests.test_pipeline import _build_batch

REPO = Path(__file__).resolve().parent.parent
BENCH_NPZ = REPO / "m3t_tpu_torch" / "data" / "bench_sphere_region_model.npz"
BENCH_DEPTH_NPZ = REPO / "m3t_tpu_torch" / "data" / "bench_sphere_depth_model.npz"


def _t(a):
    return torch.as_tensor(np.array(a))


def _pcfgs(**kw):
    common = dict(scales=(2, 1), standard_deviations=(5.0, 1.5),
                  n_corr_iterations=3, n_update_iterations=2, **kw)
    return (jpipe.PipelineConfig(cfg=JRegionConfig(n_lines_max=64), **common),
            tpipe.PipelineConfig(cfg=TRegionConfig(n_lines_max=64), **common))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return _build_batch(tmp_path_factory.mktemp("tp"))


@pytest.fixture(scope="module")
def batch(built):
    intr_t, _, models, gt_poses, frames = built
    intr = (np.float32(intr_t.fu), np.float32(intr_t.fv),
            np.float32(intr_t.ppu), np.float32(intr_t.ppv))
    jmodel = jpipe.RegionModelArrays.from_models(models, 64)
    tmodel = tpipe.RegionModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in jmodel._asdict().items()}, device="cpu")
    return intr, models, jmodel, tmodel, gt_poses, frames


def _assert_states_close(t_state, j_state):
    np.testing.assert_allclose(t_state.body2camera_pose.numpy(),
                               np.asarray(j_state.body2camera_pose), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_state.histogram_f.numpy(),
                               np.asarray(j_state.histogram_f), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_state.histogram_b.numpy(),
                               np.asarray(j_state.histogram_b), rtol=0, atol=1e-4)


def test_so3_exp_and_pose_variation_match(rng):
    theta = rng.normal(scale=0.3, size=(64, 6)).astype(np.float32)
    theta[:4, :3] = [[0, 0, 0], [1e-7, 0, 0], [0, -3e-6, 1e-6], [2.0, -1.0, 0.5]]
    np.testing.assert_allclose(tcommon.so3_exp(_t(theta[:, :3])).numpy(),
                               np.asarray(jcommon.so3_exp(theta[:, :3])), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcommon.pose_variation(_t(theta)).numpy(),
                               np.asarray(jcommon.pose_variation(theta)), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tcommon.skew(_t(theta[:, :3])).numpy(),
                                  np.asarray(jcommon.skew(theta[:, :3])))


def test_ldlt_solve_matches_jax(rng):
    h = rng.normal(size=(64, 6, 6)).astype(np.float32)
    a = np.einsum("bij,bkj->bik", h, h) + np.eye(6, dtype=np.float32) * 1000.0
    b = rng.normal(size=(64, 6)).astype(np.float32)
    want = np.asarray(jpipe._ldlt_solve_6x6(jnp.asarray(a), jnp.asarray(b)))
    got = tnewton._ldlt_solve_6x6(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("learning_rate", [1.0, 0.2])
def test_calculate_histogram_matches(rng, learning_rate):
    n = 4096
    hist = rng.random((3, n)).astype(np.float32)
    hist /= hist.sum(axis=1, keepdims=True)
    memory = rng.integers(0, 5, size=(3, n)).astype(np.float32)
    memory[1] = 0.0  # zero-sum memory: reset to uniform at lr 1, else unchanged
    want = np.stack([np.asarray(jhist.calculate_histogram(
        jnp.asarray(hist[i]), jnp.asarray(memory[i]), learning_rate)) for i in range(3)])
    got = thist.calculate_histogram(_t(hist), _t(memory), learning_rate).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("adaptive", [False, True])
def test_cycle_matches_jax_and_tracks(batch, adaptive):
    """adaptive=True traces a per-body line count (a tensor, not a Python int)."""
    intr, _, jmodel, tmodel, gt_poses, frames = batch
    ref_len = float(np.asarray(jmodel.max_contour_length).max()) * 1.5
    jpcfg, tpcfg = _pcfgs(use_adaptive_coverage=adaptive,
                          reference_contour_length=ref_len if adaptive else 0.0)
    j_state = jpipe.initialize_histograms(jpcfg, intr, jnp.asarray(frames[0]), jmodel,
                                          jnp.asarray(gt_poses[0]))
    t_state = tpipe.initialize_histograms(tpcfg, intr, _t(frames[0]), tmodel,
                                          _t(gt_poses[0]))
    _assert_states_close(t_state, j_state)
    for t in range(1, len(frames)):
        j_state = jpipe.tracking_cycle(jpcfg, intr, jnp.asarray(frames[t]), jmodel, j_state)
        t_state = tpipe.tracking_cycle(tpcfg, intr, _t(frames[t]), tmodel, t_state)
        _assert_states_close(t_state, j_state)
    est = t_state.body2camera_pose.numpy()
    err = np.linalg.norm(est[:, :3, 3] - gt_poses[-1][:, :3, 3], axis=1)
    assert np.all(np.isfinite(est)) and np.all(err < 0.005), f"translation errors {err}"


def test_pose_group_cycle_matches_jax(batch):
    """Two slots of one body tied to one pose: identical Newton steps, as in JAX."""
    intr, models, _, _, gt_poses, frames = batch
    jpcfg, tpcfg = _pcfgs()
    jmodel = jpipe.RegionModelArrays.from_models([models[0], models[0]], 64)
    tmodel = tpipe.RegionModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in jmodel._asdict().items()}, device="cpu")
    poses0 = np.stack([gt_poses[0][0]] * 2)
    images0 = np.stack([frames[0][0]] * 2)
    images1 = np.stack([frames[1][0]] * 2)
    group = np.zeros(2, np.int32)
    j_state = jpipe.initialize_histograms(jpcfg, intr, jnp.asarray(images0), jmodel,
                                          jnp.asarray(poses0))
    j_state = jpipe.tracking_cycle(jpcfg, intr, jnp.asarray(images1), jmodel, j_state,
                                   pose_group=jnp.asarray(group))
    t_state = tpipe.initialize_histograms(tpcfg, intr, _t(images0), tmodel, _t(poses0))
    t_state = tpipe.tracking_cycle(tpcfg, intr, _t(images1), tmodel, t_state,
                                   pose_group=_t(group))
    _assert_states_close(t_state, j_state)
    pose = t_state.body2camera_pose
    assert torch.equal(pose[0], pose[1])


@pytest.mark.parametrize("ref_scale", [0.0, 1.5])
def test_adaptive_n_lines_matches_jax(batch, ref_scale):
    intr, _, jmodel, tmodel, gt_poses, _ = batch
    ref_len = float(np.asarray(jmodel.max_contour_length).max()) * ref_scale
    jpcfg, tpcfg = _pcfgs(use_adaptive_coverage=True, reference_contour_length=ref_len)
    poses = gt_poses[:, 0]  # body 0's poses over the frames, one per model slot
    want = np.asarray(jpipe._adaptive_n_lines(jpcfg, jmodel, jnp.asarray(poses[:2])))
    got = tpipe._adaptive_n_lines(tpcfg, tmodel, _t(poses[:2]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tpipe._adaptive_n_lines(_pcfgs()[1], tmodel, _t(poses[:2])) == 64


def test_bench_model_npz_round_trips(tmp_path):
    """The committed model is exactly the cache file m3t_tpu's RegionModel writes for
    bench.py's model: it loads without regenerating, and from_npz equals from_models."""
    from m3t_tpu.region_model import RegionModel
    from m3t_tpu.utils import procedural

    path = tmp_path / "bench_sphere_region_model.npz"
    shutil.copyfile(BENCH_NPZ, path)
    before = path.read_bytes()
    body = procedural.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    model = RegionModel("bench_model", body, str(path), n_divides=2, n_points=200,
                        image_size=800)
    checksum = model._checksum(extra="|mt19937")
    with np.load(path) as data:
        assert str(data["checksum"]) == checksum, "committed model is stale"
    assert model.SetUp()
    assert path.read_bytes() == before, "RegionModel regenerated the committed model"
    want = jpipe.RegionModelArrays.from_models([model], 200)
    got = tpipe.RegionModelArrays.from_npz(str(path), 200, device="cpu")
    for name in jpipe.RegionModelArrays._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


@pytest.fixture(scope="module")
def rgbd_batch(built, batch, tmp_path_factory):
    """Depth models of the batch's bodies (built by the JAX DepthModel, carried across
    with from_numpy) and the depth frames at the rendered poses."""
    from m3t_tpu.depth_model import DepthModel

    tmp = tmp_path_factory.mktemp("tpd")
    intr_t, bodies, _, gt_poses, _ = built
    depth_models = []
    for i, body in enumerate(bodies):
        m = DepthModel(f"dm{i}", body, str(tmp / f"dm{i}.npz"), n_divides=1, n_points=64,
                       image_size=200)
        assert m.SetUp()
        depth_models.append(m)
    jdmodel = jpipe.DepthModelArrays.from_models(depth_models, 64)
    tdmodel = tpipe.DepthModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in jdmodel._asdict().items()}, device="cpu")
    depth_frames = np.stack([
        np.stack([fixtures.render_synthetic_depth_frame(body, intr_t, gt_poses[t][i])
                  for i, body in enumerate(bodies)])
        for t in range(len(gt_poses))])
    return jdmodel, tdmodel, depth_frames


def _rgbd_pcfgs(measure_occlusions):
    kw = dict(use_depth=True, considered_distances=(0.03, 0.02),
              depth_standard_deviations=(0.05, 0.03),
              region_measure_occlusions=measure_occlusions,
              depth_measure_occlusions=measure_occlusions)
    jpcfg, tpcfg = _pcfgs(**kw)
    return (jpcfg._replace(depth_cfg=JDepthConfig(n_points_max=64)),
            tpcfg._replace(depth_cfg=TDepthConfig(n_points_max=64)))


@pytest.mark.parametrize("measure_occlusions,handle_occlusions",
                         [(False, None), (True, None), (True, [True, False])])
def test_rgbd_cycle_matches_jax_and_tracks(batch, rgbd_batch, measure_occlusions,
                                           handle_occlusions):
    """tracking_cycle_rgbd against the JAX tracking_cycle_rgbd over the batch's frames.
    With measured occlusions on, a near wall (0.3 m) covers the depth frames left of
    column 70, over the left edge of both silhouettes, so that both modalities drop
    occluded lines and points; handle_occlusions switches that off for one body."""
    intr, _, jmodel, tmodel, gt_poses, frames = batch
    jdmodel, tdmodel, depth_frames = rgbd_batch
    if measure_occlusions:
        depth_frames = depth_frames.copy()
        depth_frames[..., :70] = 300
    jpcfg, tpcfg = _rgbd_pcfgs(measure_occlusions)
    j_state = jpipe.initialize_histograms(jpcfg, intr, jnp.asarray(frames[0]), jmodel,
                                          jnp.asarray(gt_poses[0]))
    t_state = tpipe.initialize_histograms(tpcfg, intr, _t(frames[0]), tmodel,
                                          _t(gt_poses[0]))
    handle = None if handle_occlusions is None else np.array(handle_occlusions)
    for t in range(1, len(frames)):
        j_state = jpipe.tracking_cycle_rgbd(
            jpcfg, intr, intr, jnp.float32(0.001), jnp.asarray(frames[t]),
            jnp.asarray(depth_frames[t]), jmodel, jdmodel, j_state,
            handle_occlusions=None if handle is None else jnp.asarray(handle))
        t_state = tpipe.tracking_cycle_rgbd(
            tpcfg, intr, intr, 0.001, _t(frames[t]), _t(depth_frames[t]), tmodel, tdmodel,
            t_state, handle_occlusions=None if handle is None else _t(handle))
        _assert_states_close(t_state, j_state)
    est = t_state.body2camera_pose.numpy()
    err = np.linalg.norm(est[:, :3, 3] - gt_poses[-1][:, :3, 3], axis=1)
    assert np.all(np.isfinite(est)) and np.all(err < 0.004), f"rgbd errors {err}"


def test_rgbd_pose_group_cycle_matches_jax(batch, rgbd_batch):
    """Two slots of one body tied to one pose in the RGB-D cycle, as in JAX."""
    intr, models, _, _, gt_poses, frames = batch
    jpcfg, tpcfg = _rgbd_pcfgs(False)
    jmodel = jpipe.RegionModelArrays.from_models([models[0]] * 2, 64)
    tmodel = tpipe.RegionModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in jmodel._asdict().items()}, device="cpu")
    jdmodel_all, _, depth_frames = rgbd_batch
    jdmodel = type(jdmodel_all)(*(jnp.stack([a[0]] * 2) for a in jdmodel_all))
    tdmodel = tpipe.DepthModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in jdmodel._asdict().items()}, device="cpu")
    poses0, images0, images1, depth1 = (np.stack([a[0]] * 2) for a in (
        gt_poses[0], frames[0], frames[1], depth_frames[1]))
    group = np.zeros(2, np.int32)
    j_state = jpipe.initialize_histograms(jpcfg, intr, jnp.asarray(images0), jmodel,
                                          jnp.asarray(poses0))
    j_state = jpipe.tracking_cycle_rgbd(
        jpcfg, intr, intr, jnp.float32(0.001), jnp.asarray(images1), jnp.asarray(depth1),
        jmodel, jdmodel, j_state, pose_group=jnp.asarray(group))
    t_state = tpipe.initialize_histograms(tpcfg, intr, _t(images0), tmodel, _t(poses0))
    t_state = tpipe.tracking_cycle_rgbd(tpcfg, intr, intr, 0.001, _t(images1), _t(depth1),
                                        tmodel, tdmodel, t_state, pose_group=_t(group))
    _assert_states_close(t_state, j_state)
    assert torch.equal(t_state.body2camera_pose[0], t_state.body2camera_pose[1])


def test_bench_depth_model_npz_round_trips(tmp_path):
    """The committed depth model is exactly the cache file m3t_tpu's DepthModel writes
    for bench.py's depth model: it loads without regenerating, and from_npz equals
    from_models."""
    from m3t_tpu.depth_model import DepthModel
    from m3t_tpu.utils import procedural

    path = tmp_path / "bench_sphere_depth_model.npz"
    shutil.copyfile(BENCH_DEPTH_NPZ, path)
    before = path.read_bytes()
    body = procedural.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    model = DepthModel("bench_depth_model", body, str(path), n_divides=2, n_points=200,
                       image_size=800)
    checksum = model._checksum(extra="|mt19937")
    with np.load(path) as data:
        assert str(data["checksum"]) == checksum, "committed depth model is stale"
    assert model.SetUp()
    assert path.read_bytes() == before, "DepthModel regenerated the committed model"
    want = jpipe.DepthModelArrays.from_models([model], 200)
    got = tpipe.DepthModelArrays.from_npz(str(path), 200, device="cpu")
    for name in jpipe.DepthModelArrays._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.expand(3).centers.shape == (3,) + got.centers.shape[1:]


def test_procedural_depth_frame_matches_jax_package():
    from m3t_tpu.common import Intrinsics as JIntrinsics
    from m3t_tpu.utils import procedural as jproc
    from m3t_tpu_torch.utils import procedural as tproc

    intr = JIntrinsics(150.0, 150.0, 79.5, 59.5, 160, 120)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.004, -0.003, 0.5]
    body = jproc.sphere_body("depth_frame_sphere", radius=0.06, n_subdiv=2)
    want = jproc.render_synthetic_depth_frame(body, intr, pose)
    got = tproc.render_synthetic_depth_frame(tproc.sphere_triangles(0.06, 2),
                                             tcommon.Intrinsics(*intr), pose)
    assert got.dtype == np.uint16 and (got < 2000).sum() > 100
    np.testing.assert_array_equal(got, want)


def test_procedural_frame_matches_jax_package():
    from m3t_tpu.common import Intrinsics as JIntrinsics
    from m3t_tpu.utils import procedural as jproc
    from m3t_tpu_torch.utils import procedural as tproc

    intr = JIntrinsics(150.0, 150.0, 79.5, 59.5, 160, 120)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.004, -0.003, 0.5]
    body = jproc.sphere_body("frame_sphere", radius=0.06, n_subdiv=2)
    want = jproc.render_synthetic_color_frame(body, intr, pose,
                                              noise_rng=np.random.default_rng(0))
    got = tproc.render_synthetic_color_frame(
        tproc.sphere_triangles(0.06, 2), tcommon.Intrinsics(*intr), pose,
        noise_rng=np.random.default_rng(0))
    np.testing.assert_array_equal(got, want)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import sys\n"
        "import m3t_tpu_torch, m3t_tpu_torch.common, m3t_tpu_torch.pipeline\n"
        "import m3t_tpu_torch.ops.region_fast, m3t_tpu_torch.ops.region_fn\n"
        "import m3t_tpu_torch.ops.histogram, m3t_tpu_torch.ops.raster\n"
        "import m3t_tpu_torch.ops.depth_fn, m3t_tpu_torch.ops.depth_fast\n"
        "import m3t_tpu_torch.ops.occlusion, m3t_tpu_torch.ops.kinematics\n"
        "import m3t_tpu_torch.ops.texture_fn\n"
        "import m3t_tpu_torch.ops._cuda, m3t_tpu_torch.utils.procedural\n"
        "import m3t_tpu_torch.body, m3t_tpu_torch.model_base, m3t_tpu_torch.native\n"
        "import m3t_tpu_torch.region_model, m3t_tpu_torch.depth_model\n"
        "import m3t_tpu_torch.utils.contours, m3t_tpu_torch.utils.yaml_io\n"
        "import m3t_tpu_torch.parallel, m3t_tpu_torch.parallel.sharding\n"
        "import m3t_tpu_torch.parallel.dryrun\n"
        "import m3t_tpu_torch.color_histograms, m3t_tpu_torch.camera\n"
        "import m3t_tpu_torch.modality, m3t_tpu_torch.region_modality\n"
        "import m3t_tpu_torch.depth_modality, m3t_tpu_torch.link\n"
        "import m3t_tpu_torch.optimizer, m3t_tpu_torch.detector, m3t_tpu_torch.refiner\n"
        "import m3t_tpu_torch.publisher, m3t_tpu_torch.subscriber\n"
        "import m3t_tpu_torch.tracker, m3t_tpu_torch.fused_serve\n"
        "import m3t_tpu_torch.utils.visualization, m3t_tpu_torch.utils.png\n"
        "import m3t_tpu_torch.eval, m3t_tpu_torch.examples.evaluate_rbot_dataset\n"
        "for name in m3t_tpu_torch._LAZY: getattr(m3t_tpu_torch, name)\n"
        "for name in ('adjoint', 'pose_inverse', 'pose_variation', 'project', 'skew',\n"
        "             'so3_exp', 'so3_log', 'transform_points', 'xcotx'):\n"
        "    assert getattr(m3t_tpu_torch, name) is getattr(m3t_tpu_torch.common, name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'm3t_tpu'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_the_card(batch):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    _, _, jmodel, _, gt_poses, _ = batch
    arrays = {k: np.asarray(v) for k, v in jmodel._asdict().items()}
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.RegionModelArrays.from_numpy(arrays)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.RegionModelArrays.from_npz(str(BENCH_NPZ), 200)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.TrackingState.from_numpy(gt_poses[0], np.ones((2, 8)), np.ones((2, 8)))
    depth_arrays = {name: np.zeros((1, 2, 3), np.float32)
                    for name in tpipe.DepthModelArrays._fields}
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.DepthModelArrays.from_numpy(depth_arrays)
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.DepthModelArrays.from_npz(str(BENCH_DEPTH_NPZ), 200)
    from m3t_tpu_torch.ops import occlusion as tocc
    from m3t_tpu_torch.utils import procedural as tproc

    body = tocc.SceneBody(*tproc.cube(0.05), body_id=1, region_id=1)
    with pytest.raises(RuntimeError, match="cuda"):
        tocc.build_scene_geometry([[body]])
    with pytest.raises(RuntimeError, match="cuda"):
        tocc.build_kinematic_scene_geometry([[body, body]])
