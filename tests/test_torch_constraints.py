"""Parity tests: the port's Constraint and SoftConstraint (constraint.py,
soft_constraint.py) and the host Optimizer's KKT steps over them against the JAX
package's, on the CPU.

The structures are tests/test_kinematics.py's: two links under a pinned root, pulled
together by a hard constraint from a perturbed start (constraint_convergence), or held
within 1 cm by a soft constraint.  Both packages do the same float64 numpy arithmetic:
residuals, Jacobians and soft-constraint terms within 1e-12, and the poses after 20 (30)
Newton steps within 1e-5.
"""

import numpy as np
import pytest

from m3t_tpu import constraint as jconstraint
from m3t_tpu import link as jlink
from m3t_tpu import optimizer as joptimizer
from m3t_tpu import soft_constraint as jsoft_constraint
from m3t_tpu_torch import constraint as tconstraint
from m3t_tpu_torch import link as tlink
from m3t_tpu_torch import optimizer as toptimizer
from m3t_tpu_torch import soft_constraint as tsoft_constraint
from m3t_tpu_torch.common import np_pose

PACKAGES = {"jax": (jlink, joptimizer, jconstraint, jsoft_constraint),
            "torch": (tlink, toptimizer, tconstraint, tsoft_constraint)}
PERTURBATION = np.array([0.1, -0.15, 0.08, 0.02, -0.01, 0.03], np.float32)
ALL = [True] * 6
TRANSLATION = [False, False, False, True, True, True]
MIXED = [True, False, True, False, True, True]


def structure(pkg, kind, directions):
    """(root, link1, link2, optimizer, constraint) of tests/test_kinematics.py's hard
    or soft constraint structure on the package's classes."""
    link_mod, opt_mod, c_mod, sc_mod = PACKAGES[pkg]
    if kind == "hard":
        second = np_pose(translation=[0, 0, 0.5]) @ link_mod.np_pose_variation(PERTURBATION)
    else:
        second = np_pose(translation=[0.05, 0, 0.5])
    link1 = link_mod.Link("l1", joint2parent_pose=np_pose(translation=[0, 0, 0.5]))
    link2 = link_mod.Link("l2", joint2parent_pose=second)
    assert link1.SetUp() and link2.SetUp()
    root = link_mod.Link("root", free_directions=[False] * 6)
    root.AddChildLink(link1)
    root.AddChildLink(link2)
    assert root.SetUp()
    offset = link_mod.np_pose_variation(np.array([0.02, 0.01, -0.03, 0.01, 0.0, -0.02],
                                                 np.float32))
    if kind == "hard":
        constraint = c_mod.Constraint("c", link1, link2, body12joint1_pose=offset,
                                      constraint_directions=directions)
        optimizer = opt_mod.Optimizer("o", root, tikhonov_parameter_rotation=10.0,
                                      tikhonov_parameter_translation=100.0)
        optimizer.AddConstraint(constraint)
    else:
        constraint = sc_mod.SoftConstraint(
            "sc", link1, link2, body12joint1_pose=offset, constraint_directions=directions,
            max_distance_rotation=0.01, max_distance_translation=0.01,
            standard_deviation_rotation=0.05, standard_deviation_translation=0.01)
        optimizer = opt_mod.Optimizer("o", root, tikhonov_parameter_rotation=10.0,
                                      tikhonov_parameter_translation=1e4)
        optimizer.AddSoftConstraint(constraint)
    assert constraint.SetUp() and optimizer.SetUp()
    return root, link1, link2, optimizer, constraint


def _terms(kind, constraint, link1, link2):
    """The constraint's own outputs, after the optimizer's Jacobians are current."""
    if kind == "hard":
        assert constraint.CalculateResidualAndConstraintJacobian()
        return [constraint.residual, constraint.constraint_jacobian]
    for link in (link1, link2):
        link.gradient = np.zeros(6, np.float32)
        link.hessian = np.zeros((6, 6), np.float32)
    assert constraint.AddGradientsAndHessiansToLinks()
    return [link1.gradient, link1.hessian, link2.gradient, link2.hessian]


@pytest.mark.parametrize("kind", ["hard", "soft"])
@pytest.mark.parametrize("directions", [ALL, TRANSLATION, MIXED],
                         ids=["all", "translation", "mixed"])
def test_constraint_terms_match_jax(kind, directions):
    """Residuals and Jacobians (hard) or the soft terms added to both links, at the
    start and after two Newton steps, and the helpers' float64 rows."""
    outs = {}
    for pkg in PACKAGES:
        root, link1, link2, optimizer, constraint = structure(pkg, kind, directions)
        out = []
        for step in range(3):
            for link, parent in ((root, None), (link1, root), (link2, root)):
                assert link.CalculateJacobian(parent)
            out += _terms(kind, constraint, link1, link2)
            joint22joint1 = (constraint.body12joint1_pose.astype(np.float64)
                             @ np.linalg.inv(link1.link2world_pose.astype(np.float64))
                             @ link2.link2world_pose.astype(np.float64))
            if kind == "hard":
                out.append(constraint._residual(joint22joint1))
                out.append(constraint._unprojected_jacobian(joint22joint1, joint22joint1))
            else:
                for rotation in (True, False):
                    if any(directions[:3] if rotation else directions[3:]):
                        out.append(constraint._unprojected_rows(
                            joint22joint1, joint22joint1, rotation=rotation))
            assert optimizer.CalculateOptimization(0, 0, step)
        outs[pkg] = out
    assert len(outs["torch"]) == len(outs["jax"])
    for got, want in zip(outs["torch"], outs["jax"]):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    if kind == "soft":
        assert np.abs(outs["torch"][0]).max() > 0  # the soft constraint is active


@pytest.mark.parametrize("kind,steps", [("hard", 20), ("soft", 30)])
def test_optimization_steps_match_jax(kind, steps):
    """tests/test_kinematics.py's convergence runs: the link poses after every step."""
    poses = {}
    for pkg in PACKAGES:
        _, link1, link2, optimizer, constraint = structure(
            pkg, kind, ALL if kind == "hard" else TRANSLATION)
        out = []
        for step in range(steps):
            assert optimizer.CalculateOptimization(0, 0, step)
            out.append(np.stack([link1.link2world_pose, link2.link2world_pose]))
        poses[pkg] = np.stack(out)
    np.testing.assert_allclose(poses["torch"], poses["jax"], rtol=0, atol=1e-5)
    # The constraint did its work: the joints met (hard), or came within about the
    # 1 cm limit (soft).
    final = poses["torch"][-1].astype(np.float64)
    joint22joint1 = (constraint.body12joint1_pose @ np.linalg.inv(final[0]) @ final[1]
                     @ np.linalg.inv(constraint.body22joint2_pose))
    distance = np.linalg.norm(joint22joint1[:3, 3])
    assert distance < 1e-4 if kind == "hard" else 0.005 < distance < 0.012


@pytest.mark.parametrize("kind", ["hard", "soft"])
def test_constraint_metafiles_match_jax(kind, tmp_path):
    """SetUp from a metafile (body12joint1 pose as an opencv matrix, a flow list of
    directions, the soft constraint's distances) in both packages."""
    metafile = tmp_path / f"{kind}.yaml"
    metafile.write_text(
        "%YAML:1.2\n---\n"
        "body12joint1_pose: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n"
        "  data: [1, 0, 0, 0.1,  0, 1, 0, 0,  0, 0, 1, -0.02,  0, 0, 0, 1]\n"
        "constraint_directions: [1, 1, 0, 1, 1, 1]\n"
        "max_distance_translation: 0.02\nstandard_deviation_rotation: 0.2\n")
    read = {}
    for pkg in PACKAGES:
        link_mod, _, c_mod, sc_mod = PACKAGES[pkg]
        link1, link2 = link_mod.Link("a"), link_mod.Link("b")
        assert link1.SetUp() and link2.SetUp()
        cls = c_mod.Constraint if kind == "hard" else sc_mod.SoftConstraint
        constraint = cls("m", link1, link2, metafile_path=str(metafile))
        assert constraint.SetUp()
        read[pkg] = {k: v for k, v in vars(constraint).items()
                     if not k.startswith("link") and k != "metafile_path"}
    assert read["torch"].keys() == read["jax"].keys()
    for key, want in read["jax"].items():
        np.testing.assert_array_equal(read["torch"][key], want, err_msg=key)
    assert read["torch"]["constraint_directions"] == [True, True, False, True, True, True]
    assert read["torch"]["body12joint1_pose"][0, 3] == np.float32(0.1)
