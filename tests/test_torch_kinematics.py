"""Parity tests: m3t_tpu_torch's articulated path against the JAX package on the CPU.

The pose math that kinematics needs (so3_log, pose_inverse, adjoint, xcotx), the batched
kinematics of ops/kinematics.py against m3t_tpu.ops.kinematics under ``vmap`` (the
two-link constraint and soft-constraint structures of tests/test_kinematics_device.py
and a three-link tree padded to four links and two constraints), the builders on
m3t_tpu's Optimizer objects, the committed bench structure, and tracking_cycle_kinematic
against the JAX one in three configurations.

Sizes: 200x150 frames (room for the 0.13 m arm), 64 lines, 3x2 iterations, S=2
structures.  Tolerances: the common functions 1e-6 (so3_log near pi excepted, where
a one-ulp difference of arccos is magnified by 1/sin), the kinematics 1e-5, the cycles'
joint poses and histograms atol 1e-4 as tests/test_torch_pipeline.py holds them (the
joint poses agree to about 4e-7; a histogram-walk pixel that lies within that of an
integer boundary would move a bin by about lr/total, and the frames' noise seed is one
whose walks have none).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu import common as jcommon
from m3t_tpu import pipeline as jpipe
from m3t_tpu.common import np_pose
from m3t_tpu.constraint import Constraint
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
from m3t_tpu.soft_constraint import SoftConstraint
from m3t_tpu.utils import procedural as jproc
from m3t_tpu_torch import common as tcommon
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.ops import kinematics as tkin
from m3t_tpu_torch.ops import occlusion as tocc
from m3t_tpu_torch.ops.depth_fn import DepthConfig as TDepthConfig
from m3t_tpu_torch.ops.region_fn import RegionConfig as TRegionConfig
from m3t_tpu_torch.ops.texture_fn import TexturePoints as TTexturePoints
from tests import fixtures
from tests.test_kinematics_device import _constraint_setup, _soft_setup

REPO = Path(__file__).resolve().parent.parent
BENCH_KIN_NPZ = REPO / "m3t_tpu_torch" / "data" / "bench_kinematic_model.npz"
W, H = 200, 150
N_LINES, N_POINTS, ARM = 64, 64, 0.13
DEPTH_SCALE = 0.001


def _t(a):
    return torch.as_tensor(np.array(a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------------------
# Pose math
# ---------------------------------------------------------------------------------------


def _rotations(rng, angles):
    axes = rng.normal(size=(len(angles), 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return np.asarray(jcommon.so3_exp((axes * np.asarray(angles)[:, None]).astype(np.float32)))


def test_so3_log_matches(rng):
    """Both sides of the 1e-6 small-angle branch, identity, random angles and near pi."""
    small = [0.0, 1e-8, 5e-7, 2e-6, 1e-4]
    regular = list(rng.uniform(0.01, 3.0, 32))
    near_pi = [np.pi - 0.05, np.pi - 0.01]
    rot = _rotations(rng, small + regular + near_pi)
    want = np.asarray(jcommon.so3_log(rot))
    got = tcommon.so3_log(_t(rot)).numpy()
    n = len(small) + len(regular)
    np.testing.assert_allclose(got[:n], want[:n], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[n:], want[n:], rtol=1e-3, atol=1e-5)


def test_pose_inverse_and_adjoint_match(rng):
    theta = rng.normal(scale=0.5, size=(64, 6)).astype(np.float32)
    pose = np.asarray(jcommon.pose_variation(theta))
    np.testing.assert_allclose(tcommon.pose_inverse(_t(pose)).numpy(),
                               np.asarray(jcommon.pose_inverse(pose)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tcommon.adjoint(_t(pose)).numpy(),
                               np.asarray(jcommon.adjoint(pose)), rtol=0, atol=1e-6)


def test_xcotx_matches(rng):
    """Both sides of the 1e-4 series branch."""
    x = np.concatenate([[0.0, 1e-6, -5e-5, 9.9e-5, 1.01e-4, -2e-4, 1e-3],
                        rng.uniform(-1.5, 1.5, 32)]).astype(np.float32)
    np.testing.assert_allclose(tcommon.xcotx(_t(x)).numpy(), np.asarray(jcommon.xcotx(x)),
                               rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------------------
# Kinematics
# ---------------------------------------------------------------------------------------


def _tree_setup():
    """A root with two children (one revolute, one free), a hard constraint between
    the children over three directions and a soft constraint from the root."""
    rng = np.random.default_rng(5)

    def pert(scale):
        return np_pose_variation(rng.normal(0, scale, 6).astype(np.float32))

    root = Link("kt_root", joint2parent_pose=np_pose(translation=[0, 0, 0.6]) @ pert(0.1))
    arm = Link("kt_arm", body2joint_pose=np_pose(translation=[0.1, 0, 0]) @ pert(0.05),
               joint2parent_pose=pert(0.1),
               free_directions=[False, False, True, False, False, False])
    leg = Link("kt_leg", body2joint_pose=np_pose(translation=[0, -0.1, 0]) @ pert(0.05),
               joint2parent_pose=pert(0.1))
    assert arm.SetUp() and leg.SetUp()
    root.AddChildLink(arm)
    root.AddChildLink(leg)
    assert root.SetUp()
    constraint = Constraint("kt_c", arm, leg, body12joint1_pose=pert(0.05),
                            constraint_directions=[True, False, False, True, True, False])
    soft = SoftConstraint("kt_s", root, leg, max_distance_rotation=0.02,
                          max_distance_translation=0.01,
                          standard_deviation_rotation=0.05,
                          standard_deviation_translation=0.02,
                          constraint_directions=[True, True, False, False, True, True])
    assert constraint.SetUp() and soft.SetUp()
    optimizer = Optimizer("kt_o", root, tikhonov_parameter_rotation=10.0,
                          tikhonov_parameter_translation=100.0)
    optimizer.AddConstraint(constraint)
    optimizer.AddSoftConstraint(soft)
    assert optimizer.SetUp()
    return optimizer


SETUPS = {"constraint": (_constraint_setup, {}), "soft": (_soft_setup, {}),
          "tree": (_tree_setup, dict(n_links=4, n_constraints=2))}


def _models(name):
    """Two copies of a setup's structure: (JAX model, port model, jp0 numpy)."""
    setup, sizes = SETUPS[name]
    opts = [setup(), setup()]
    jmodel = jkin.build_kinematic_model(opts, **sizes)
    tmodel = tkin.build_kinematic_model(opts, **sizes, device="cpu")
    jp0 = jkin.initial_joint2parent(opts, n_links=sizes.get("n_links"))
    return jmodel, tmodel, jp0


def _perturbed(jp0, rng, scale=0.05):
    jp = np.array(jp0)
    for s in range(jp.shape[0]):
        for l in range(jp.shape[1]):
            jp[s, l] = jp[s, l] @ np_pose_variation(
                rng.normal(scale=scale, size=6).astype(np.float32))
    return jp


def _vmapped(fn):
    return jax.jit(jax.vmap(fn))


@pytest.mark.parametrize("name", list(SETUPS))
def test_builders_match_jax(name):
    jmodel, tmodel, jp0 = _models(name)
    for field in jkin.KinematicModel._fields:
        np.testing.assert_array_equal(getattr(tmodel, field).numpy(),
                                      np.asarray(getattr(jmodel, field)), err_msg=field)
    setup, sizes = SETUPS[name]
    opts = [setup()]
    w2c = np_pose(translation=[0.01, -0.02, 0.03]) @ np_pose_variation(
        np.array([0.1, 0, 0.2, 0, 0, 0], np.float32))
    got = tkin.initial_joint2parent(opts, w2c, n_links=sizes.get("n_links"), device="cpu")
    want = jkin.initial_joint2parent(opts, w2c, n_links=sizes.get("n_links"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert jp0.shape == (2, tmodel.n_links, 4, 4)
    carried = tkin.KinematicModel.from_numpy(tmodel.to_numpy(), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(carried, tmodel))


@pytest.mark.parametrize("name", list(SETUPS))
def test_kinematics_match_jax(name, rng):
    """forward_kinematics, link_jacobians, constraint_terms and soft_constraint_terms at
    perturbed joint poses, against the JAX functions under vmap."""
    jmodel, tmodel, jp0 = _models(name)
    jp = _perturbed(jp0, rng)
    b2c = np.asarray(_vmapped(jkin.forward_kinematics)(jmodel, jnp.asarray(jp)))
    jac = np.asarray(_vmapped(jkin.link_jacobians)(jmodel, jnp.asarray(jp)))
    np.testing.assert_allclose(tkin.forward_kinematics(tmodel, _t(jp)).numpy(), b2c,
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tkin.link_jacobians(tmodel, _t(jp)).numpy(), jac,
                               rtol=0, atol=1e-5)
    want_r, want_j = _vmapped(jkin.constraint_terms)(jmodel, jnp.asarray(b2c),
                                                     jnp.asarray(jac))
    got_r, got_j = tkin.constraint_terms(tmodel, _t(b2c), _t(jac))
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=0, atol=1e-5)
    want_g, want_h = _vmapped(jkin.soft_constraint_terms)(jmodel, jnp.asarray(b2c))
    got_g, got_h = tkin.soft_constraint_terms(tmodel, _t(b2c))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(SETUPS))
def test_update_structures_match_jax(name, rng):
    """Five batched Newton steps with random per-link terms (negative semi-definite
    Hessians), on structures with and without soft constraints."""
    jmodel, tmodel, jp0 = _models(name)
    s, nl = jp0.shape[:2]
    jp_j = jnp.asarray(_perturbed(jp0, rng, 0.02))
    jp_t = _t(np.asarray(jp_j))
    step = jax.jit(lambda jp, g, h: jkin.update_structures(jmodel, jp, g, h, 10.0, 100.0))
    for _ in range(5):
        g = rng.normal(scale=0.5, size=(s, nl, 6)).astype(np.float32)
        m = rng.normal(size=(s, nl, 6, 6)).astype(np.float32)
        h = -np.einsum("slij,slkj->slik", m, m) * 10.0
        jp_j = step(jp_j, jnp.asarray(g), jnp.asarray(h))
        jp_t = tkin.update_structures(tmodel, jp_t, _t(g), _t(h), 10.0, 100.0)
        np.testing.assert_allclose(jp_t.numpy(), np.asarray(jp_j), rtol=0, atol=1e-5)


def test_constraint_steps_converge_like_jax():
    """Constraint-only Newton steps of tests/test_kinematics_device.py: the constraint
    closes in the port as in JAX."""
    jmodel, tmodel, jp0 = _models("constraint")
    zeros_g = np.zeros((2, jp0.shape[1], 6), np.float32)
    zeros_h = np.zeros((2, jp0.shape[1], 6, 6), np.float32)
    jp_j, jp_t = jnp.asarray(jp0), _t(jp0)
    step = jax.jit(lambda jp: jkin.update_structures(
        jmodel, jp, jnp.asarray(zeros_g), jnp.asarray(zeros_h), 10.0, 100.0))
    for _ in range(20):
        jp_j = step(jp_j)
        jp_t = tkin.update_structures(tmodel, jp_t, _t(zeros_g), _t(zeros_h), 10.0, 100.0)
    np.testing.assert_allclose(jp_t.numpy(), np.asarray(jp_j), rtol=0, atol=1e-5)
    b2c = tkin.forward_kinematics(tmodel, jp_t).numpy().astype(np.float64)
    rel = np.linalg.inv(b2c[:, 1]) @ b2c[:, 2]
    assert np.abs(rel[:, :3, 3]).max() < 1e-4


def test_angle_axis_and_soft_guards_match_jax(rng):
    """_angle_axis on both sides of its 1e-12 threshold, and the soft constraint at a
    distance of exactly 0, inside its maximum and beyond it."""
    rot = _rotations(rng, [0.0, 1e-9, 1e-3, 0.5])
    for r in rot:
        want = jkin._angle_axis(jnp.asarray(r))
        got = tkin._angle_axis(_t(r))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-7)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    assert tkin._angle_axis(_t(rot[0]))[1].tolist() == [1.0, 0.0, 0.0]
    jmodel, tmodel, jp0 = _models("soft")
    jp = np.array(jp0)
    jp[0, 2] = jp[0, 1]                                   # links coincide: distance 0
    jp[1, 2, :3, 3] = jp[1, 1, :3, 3] + [0.004, 0.0, 0.0]  # inside the 0.01 maximum
    for state in (jp, jp0):
        b2c = np.asarray(_vmapped(jkin.forward_kinematics)(jmodel, jnp.asarray(state)))
        want_g, want_h = _vmapped(jkin.soft_constraint_terms)(jmodel, jnp.asarray(b2c))
        got_g, got_h = tkin.soft_constraint_terms(tmodel, _t(b2c))
        np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-5)
        assert np.isfinite(got_g.numpy()).all()
    b2c = tkin.forward_kinematics(tmodel, _t(jp))
    assert not tkin.soft_constraint_terms(tmodel, b2c)[0].any()
    assert tkin.soft_constraint_terms(tmodel, tkin.forward_kinematics(tmodel, _t(jp0)))[0].any()


def test_builder_rejects_free_body2joint_links():
    root = Link("kr_root")
    child = Link("kr_child", fixed_body2joint_pose=False)
    root.AddChildLink(child)
    assert child.SetUp() and root.SetUp()
    opt = Optimizer("kr_o", root)
    assert opt.SetUp()
    with pytest.raises(ValueError, match="fixed_body2joint_pose"):
        tkin.build_kinematic_model([opt], device="cpu")


def _bench_structure():
    """bench.py's --kinematic structure (bench.py:285-306), built as bench.py builds it."""
    body = jproc.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.6
    b2j = np.eye(4, dtype=np.float32)
    b2j[0, 3] = 0.13
    link_p = Link("bench_lp", body)
    link_c = Link("bench_lc", body, body2joint_pose=b2j,
                  free_directions=[False, False, True, False, False, False])
    link_p.AddChildLink(link_c)
    assert link_c.SetUp() and link_p.SetUp()
    link_p.set_link2world_pose(pose0)
    constraint = Constraint("bench_constraint", link_p, link_c, body22joint2_pose=b2j,
                            constraint_directions=[True, True, False, True, True, True])
    assert constraint.SetUp()
    opt = Optimizer("bench_opt", link_p)
    opt.AddConstraint(constraint)
    assert opt.SetUp()
    return opt


def test_bench_kinematic_npz_round_trips():
    """The committed structure is what bench.py's construction builds today, through the
    JAX builders and through the port's."""
    opt = _bench_structure()
    want = jkin.build_kinematic_model([opt])
    with np.load(BENCH_KIN_NPZ) as data:
        arrays = {k: data[k] for k in data.files}
    assert set(arrays) == set(jkin.KinematicModel._fields) | {"joint2parent"}
    for field in jkin.KinematicModel._fields:
        np.testing.assert_array_equal(arrays[field], np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(arrays["joint2parent"], jkin.initial_joint2parent([opt]))
    got = tkin.build_kinematic_model([opt], device="cpu")
    for field in jkin.KinematicModel._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), arrays[field],
                                      err_msg=field)
    np.testing.assert_array_equal(tkin.initial_joint2parent([opt], device="cpu").numpy(),
                                  arrays["joint2parent"])


def test_bench_structure_step_is_singular_in_both_packages(rng):
    """bench.py's constraint restates its child's revolute parameterization, so its
    constraint rows are zero and the KKT system is singular at the initial state: both
    packages zero the non-finite step, and the structure does not move."""
    with np.load(BENCH_KIN_NPZ) as data:
        arrays = {k: data[k] for k in data.files}
    jmodel = jkin.KinematicModel(*(jnp.asarray(arrays[f]) for f in jkin.KinematicModel._fields))
    tmodel = tkin.KinematicModel.from_numpy(arrays, device="cpu")
    jp = arrays["joint2parent"]
    g = rng.normal(size=(1, 2, 6)).astype(np.float32)
    h = np.broadcast_to(-100.0 * np.eye(6, dtype=np.float32), (1, 2, 6, 6)).copy()
    want = np.asarray(jax.jit(jkin.update_structures, static_argnums=(4, 5))(
        jmodel, jnp.asarray(jp), jnp.asarray(g), jnp.asarray(h), 1000.0, 30000.0))
    got = tkin.update_structures(tmodel, _t(jp), _t(g), _t(h), 1000.0, 30000.0).numpy()
    np.testing.assert_array_equal(want, jp)
    np.testing.assert_array_equal(got, jp)
    # With the child free in all six directions the constraint is what makes the joint
    # revolute (tests/test_pipeline_kinematics.py::test_closed_chain_constraint_fused):
    # the system is regular and the step moves the structure.
    widened = tmodel._replace(free=torch.ones_like(tmodel.free))
    moved = tkin.update_structures(widened, _t(jp), _t(g), _t(h), 1000.0, 30000.0).numpy()
    assert np.isfinite(moved).all() and np.abs(moved - jp).max() > 1e-6


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with np.load(BENCH_KIN_NPZ) as data:
        arrays = {k: data[k] for k in data.files}
    with pytest.raises(RuntimeError, match="cuda"):
        tkin.KinematicModel.from_numpy(arrays)
    opt = _bench_structure()
    with pytest.raises(RuntimeError, match="cuda"):
        tkin.build_kinematic_model([opt])
    with pytest.raises(RuntimeError, match="cuda"):
        tkin.initial_joint2parent([opt])
    with pytest.raises(RuntimeError, match="cuda"):
        tpipe.texture_points_from_modalities([], 4)
    assert tkin.KinematicModel.from_numpy(arrays, device="cpu").expand(3).parent.shape == (3, 2)


# ---------------------------------------------------------------------------------------
# The articulated cycle
# ---------------------------------------------------------------------------------------


def _child_pose(root, angle):
    return root @ np_pose_variation(np.array([0, 0, angle, 0, 0, 0], np.float32)) @ \
        np_pose(translation=[ARM, 0.0, 0.0])


def _render(bodies, poses, intr, rng):
    """Colour frame (bodies in distinct colours, with noise) and uint16 depth frame."""
    verts, ids = [], []
    for i, (body, pose) in enumerate(zip(bodies, poses)):
        tri = body.triangle_vertices_f_body()
        verts.append(tri @ pose[:3, :3].T + pose[:3, 3])
        ids.append(np.full(len(tri), i + 1))
    depth, id_img = rasterize_np(np.concatenate(verts), np.concatenate(ids), intr.fu,
                                 intr.fv, intr.ppu, intr.ppv, W, H, cull_backfaces=True)
    colors = [(40, 120, 190), (170, 60, 40), (60, 170, 60), (200, 200, 60)]
    image = np.empty((H, W, 3), np.uint8)
    image[:] = colors[0]
    for i in range(len(bodies)):
        image[id_img == i + 1] = colors[i + 1]
    image = np.clip(image.astype(np.int16) + rng.integers(-6, 7, image.shape), 0, 255
                    ).astype(np.uint8)
    depth_u16 = np.where(np.isfinite(depth), depth / DEPTH_SCALE, 0.0).astype(np.uint16)
    return image, depth_u16


def _scene_body(body) -> tocc.SceneBody:
    g2b = body.geometry2body_pose
    return tocc.SceneBody(body.vertices @ g2b[:3, :3].T + g2b[:3, 3], body.triangles,
                          body.body_id, body.region_id, body.geometry_enable_culling)


@pytest.fixture(scope="module")
def articulated(tmp_path_factory):
    """Two structures (parent sphere, child sphere on a revolute joint at 0.13 m, a
    cube beside the first parent) over four frames, with region and depth models of
    both links and texture matches of both links at the rendered poses."""
    tmp = tmp_path_factory.mktemp("tkin")
    parent = fixtures.sphere_body("tk_parent", radius=0.05, n_subdiv=2)
    child = fixtures.sphere_body("tk_child", radius=0.04, n_subdiv=2)
    cube = fixtures.cube_body("tk_cube", half=0.02)
    intr = fixtures.test_intrinsics(W, H)
    roots = [np_pose(translation=[-0.05, 0.0, 0.7]), np_pose(translation=[-0.03, 0.01, 0.75])]
    rates = [0.04, -0.03]
    cube_pose = np_pose(translation=[-0.09, 0.03, 0.6])
    rng = np.random.default_rng(4)
    gt, images, depths = [], [], []
    for k in range(4):
        poses = [[root, _child_pose(root, rate * k)] for root, rate in zip(roots, rates)]
        frames = [_render([parent, child, cube], p + [cube_pose], intr, rng) for p in poses]
        gt.append(np.stack(poses))
        images.append(np.stack([f[0] for f in frames]))
        depths.append(np.stack([f[1] for f in frames]))

    links = (parent, child)
    models = [RegionModel(f"tk_rm{i}", b, str(tmp / f"r{i}.npz"), n_divides=1,
                          n_points=N_LINES, image_size=200) for i, b in enumerate(links)]
    dmodels = [DepthModel(f"tk_dm{i}", b, str(tmp / f"d{i}.npz"), n_divides=1,
                          n_points=N_POINTS, image_size=200) for i, b in enumerate(links)]
    assert all(m.SetUp() for m in models + dmodels)
    jmodel = jpipe.RegionModelArrays.from_models(models * 2, N_LINES)
    jdmodel = jpipe.DepthModelArrays.from_models(dmodels * 2, N_POINTS)

    # Texture matches: points on each link's surface facing the camera, at their
    # projections in the last frame plus 1 px noise, a third invalid.
    k_tex = 24
    p3 = np.zeros((4, k_tex, 3), np.float32)
    p2 = np.zeros((4, k_tex, 2), np.float32)
    for b, (radius, pose) in enumerate(zip((0.05, 0.04) * 2, gt[-1].reshape(4, 4, 4))):
        d = rng.normal(size=(k_tex, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d[:, 2] = -np.abs(d[:, 2])
        p3[b] = radius * d
        cam = p3[b] @ pose[:3, :3].T + pose[:3, 3]
        p2[b] = (np.stack([cam[:, 0] * intr.fu / cam[:, 2] + intr.ppu,
                           cam[:, 1] * intr.fv / cam[:, 2] + intr.ppv], 1)
                 + rng.normal(scale=1.0, size=(k_tex, 2)))
    valid = rng.random((4, k_tex)) > 0.3

    def structure(prefix, closed_chain):
        # Links without bodies: the structures share the link meshes, and a link with a
        # body reads its pose from it (m3t_tpu/link.py:227-230).
        link_p = Link(f"{prefix}_p")
        if closed_chain:
            # A 6-DoF child; the hard constraint leaves only the z rotation free.
            link_c = Link(f"{prefix}_c", joint2parent_pose=np_pose(
                translation=[ARM, 0.0, 0.0]))
        else:
            link_c = Link(f"{prefix}_c", body2joint_pose=np_pose(
                translation=[ARM, 0.0, 0.0]),
                free_directions=[False, False, True, False, False, False])
        link_p.AddChildLink(link_c)
        assert link_c.SetUp() and link_p.SetUp()
        opt = Optimizer(f"{prefix}_o", link_p)
        if closed_chain:
            c = Constraint(f"{prefix}_k", link_p, link_c,
                           body22joint2_pose=np_pose(translation=[ARM, 0.0, 0.0]),
                           constraint_directions=[True, True, False, True, True, True])
            assert c.SetUp()
            opt.AddConstraint(c)
        assert opt.SetUp()
        return opt

    return dict(intr4=tuple(np.float32(x) for x in (intr.fu, intr.fv, intr.ppu, intr.ppv)),
                roots=roots, gt=gt, images=images, depths=depths, jmodel=jmodel,
                jdmodel=jdmodel, parent=parent, child=child, cube=cube,
                cube_poses=np.stack([cube_pose] * 2)[:, None], structure=structure,
                texture=(p3, p2, valid),
                tmodel=tpipe.RegionModelArrays.from_numpy(
                    {k: np.asarray(v) for k, v in jmodel._asdict().items()}, device="cpu"),
                tdmodel=tpipe.DepthModelArrays.from_numpy(
                    {k: np.asarray(v) for k, v in jdmodel._asdict().items()}, device="cpu"))


def _kin_pcfgs(**kw):
    common = dict(scales=(2, 1), standard_deviations=(5.0, 1.5), n_corr_iterations=3,
                  n_update_iterations=2, considered_distances=(0.03, 0.02),
                  depth_standard_deviations=(0.05, 0.03), **kw)
    return (jpipe.PipelineConfig(cfg=JRegionConfig(n_lines_max=N_LINES),
                                 depth_cfg=JDepthConfig(n_points_max=N_POINTS), **common),
            tpipe.PipelineConfig(cfg=TRegionConfig(n_lines_max=N_LINES),
                                 depth_cfg=TDepthConfig(n_points_max=N_POINTS), **common))


CYCLES = {
    # The Mb-ICG open chain: a revolute child, region terms only.
    "region": dict(closed_chain=False, scene=False, rgbd=False),
    # A closed chain (constraint rows in every KKT solve) with per-link scenes: the links
    # and a cube occlude one another, region checks and modeled occlusions on.
    "scene": dict(closed_chain=True, scene=True, rgbd=False),
    # The RTB configuration: region + depth + texture terms per link.
    "rgbd": dict(closed_chain=False, scene=False, rgbd=True),
}


@pytest.mark.parametrize("config", list(CYCLES))
def test_kinematic_cycle_matches_jax_and_tracks(articulated, config):
    """initialize_kinematic_histograms and three tracking_cycle_kinematic calls against
    the JAX ones: joint poses and histograms atol 1e-4 after every cycle, and both
    links of both structures within the errors of
    tests/test_pipeline_kinematics.py::test_articulated_batch_of_structures."""
    a = articulated
    opt = CYCLES[config]
    structures = [a["structure"](f"tk{config}{s}", opt["closed_chain"]) for s in range(2)]
    for s, o in enumerate(structures):
        o.root_link_ptr.set_link2world_pose(a["roots"][s])
    jkin_model = jkin.build_kinematic_model(structures)
    tkin_model = tkin.build_kinematic_model(structures, device="cpu")
    jp0 = tkin.initial_joint2parent(structures, device="cpu")
    np.testing.assert_array_equal(jp0.numpy(), jkin.initial_joint2parent(structures))
    scene_flags = dict(region_model_occlusions=True, region_checking=True) \
        if opt["scene"] else {}
    jpcfg, tpcfg = _kin_pcfgs(use_depth=opt["rgbd"], use_texture=opt["rgbd"], **scene_flags)
    intr = a["intr4"]
    jkw, tkw = {}, {}
    if opt["scene"]:
        jkw = dict(scene_geom=jocc.build_kinematic_scene_geometry(
            [[a["parent"], a["child"]]] * 2, extras=[a["cube"]]),
            extra_occluder_poses=jnp.asarray(a["cube_poses"]))
        tkw = dict(scene_geom=tocc.build_kinematic_scene_geometry(
            [[_scene_body(a["parent"]), _scene_body(a["child"])]] * 2,
            extras=[_scene_body(a["cube"])], device="cpu"),
            extra_occluder_poses=_t(a["cube_poses"]))
    if opt["rgbd"]:
        jkw.update(depth_intr=intr, depth_scale=jnp.float32(DEPTH_SCALE),
                   depth_model=a["jdmodel"],
                   texture_points=JTexturePoints(*(jnp.asarray(x) for x in a["texture"])))
        tkw.update(depth_intr=intr, depth_scale=DEPTH_SCALE, depth_model=a["tdmodel"],
                   texture_points=TTexturePoints(*(_t(x) for x in a["texture"])))

    j_state = jpipe.initialize_kinematic_histograms(
        jpcfg, intr, jnp.asarray(a["images"][0]), a["jmodel"], jkin_model,
        jnp.asarray(jp0.numpy()))
    t_state = tpipe.initialize_kinematic_histograms(tpcfg, intr, _t(a["images"][0]),
                                                    a["tmodel"], tkin_model, jp0)
    for t in range(1, len(a["images"])):
        if opt["rgbd"]:
            jkw["depth_images"] = jnp.asarray(a["depths"][t])
            tkw["depth_images"] = _t(a["depths"][t])
        j_state = jpipe.tracking_cycle_kinematic(jpcfg, intr, jnp.asarray(a["images"][t]),
                                                 a["jmodel"], jkin_model, j_state, **jkw)
        t_state = tpipe.tracking_cycle_kinematic(tpcfg, intr, _t(a["images"][t]),
                                                 a["tmodel"], tkin_model, t_state, **tkw)
        for name in ("joint2parent", "histogram_f", "histogram_b"):
            np.testing.assert_allclose(_n(getattr(t_state, name)),
                                       np.asarray(getattr(j_state, name)), rtol=0,
                                       atol=1e-4, err_msg=f"{name}, cycle {t}")
    b2c = tpipe.kinematic_body_poses(tkin_model, t_state).numpy()
    np.testing.assert_allclose(
        b2c, np.asarray(jpipe.kinematic_body_poses(jkin_model, j_state)), rtol=0, atol=1e-4)
    err = np.linalg.norm(b2c[..., :3, 3] - a["gt"][-1][..., :3, 3], axis=-1)
    assert np.all(np.isfinite(b2c)) and np.all(err[:, 0] < 0.012) and \
        np.all(err[:, 1] < 0.015), f"link errors {err}"
