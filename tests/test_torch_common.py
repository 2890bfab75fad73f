"""Parity tests: the port's pose and projection functions (m3t_tpu_torch/common.py) and
its top-level exports against m3t_tpu.common, on the CPU."""

import numpy as np
import pytest
import torch

import m3t_tpu
import m3t_tpu_torch
from m3t_tpu import common as jcommon
from m3t_tpu_torch import common as tcommon

INTR = dict(fu=650.048, fv=647.183, ppu=323.828, ppv=256.823, width=640, height=512)
EXPORTS = ("adjoint", "pose_inverse", "pose_variation", "project", "skew", "so3_exp",
           "so3_log", "transform_points", "xcotx")


def _poses(rng, n):
    theta = (rng.normal(size=(n, 6)) * [0.5, 0.5, 0.5, 0.1, 0.1, 0.1]).astype(np.float32)
    poses = np.array(jcommon.pose_variation(theta))
    poses[:, 2, 3] += 0.6
    return poses


@pytest.mark.parametrize("seed", range(3))
def test_point_functions_match_jax(seed):
    rng = np.random.default_rng(seed)
    poses = _poses(rng, 4)
    points = rng.normal(size=(4, 50, 3)).astype(np.float32) * 0.1
    for name in ("transform_points", "rotate_vectors"):
        got = getattr(tcommon, name)(torch.as_tensor(poses), torch.as_tensor(points))
        want = np.asarray(getattr(jcommon, name)(poses, points))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6, err_msg=name)
    cam = points + np.float32([0.0, 0.0, 0.6])
    got = tcommon.project(tcommon.Intrinsics(**INTR), torch.as_tensor(cam))
    want = np.asarray(jcommon.project(jcommon.Intrinsics(**INTR), cam))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)
    depth = rng.uniform(0.3, 1.0, size=(4, 50)).astype(np.float32)
    got = tcommon.unproject(tcommon.Intrinsics(**INTR), torch.tensor(want),
                            torch.as_tensor(depth))
    want_points = np.asarray(jcommon.unproject(jcommon.Intrinsics(**INTR), want, depth))
    np.testing.assert_allclose(got.numpy(), want_points, rtol=0, atol=1e-6)


def test_top_level_exports_match_jax():
    """The nine pose-math names of m3t_tpu/__init__.py resolve on m3t_tpu_torch and
    compute what JAX's do on the same inputs."""
    rng = np.random.default_rng(5)
    poses = _poses(rng, 3)
    twists = rng.normal(size=(3, 6)).astype(np.float32) * 0.3
    points = (rng.normal(size=(3, 20, 3)) * 0.1 + [0.0, 0.0, 0.6]).astype(np.float32)
    args = {"adjoint": (poses,), "pose_inverse": (poses,), "pose_variation": (twists,),
            "skew": (twists[:, :3],), "so3_exp": (twists[:, :3],),
            "so3_log": (poses[:, :3, :3],), "xcotx": (twists[:, 0],),
            "transform_points": (poses, points)}
    for name in EXPORTS:
        fn = getattr(m3t_tpu_torch, name)
        assert fn is getattr(tcommon, name)
        if name == "project":
            got = fn(tcommon.Intrinsics(**INTR), torch.as_tensor(points))
            want = m3t_tpu.project(jcommon.Intrinsics(**INTR), points)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)
            continue
        got = fn(*(torch.as_tensor(a) for a in args[name]))
        want = getattr(m3t_tpu, name)(*args[name])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-6,
                                   err_msg=name)


def test_component_lifecycle_matches_jax():
    for module in (jcommon, tcommon):
        component = module.Component("c", "meta.yaml")
        assert (component.name, component.metafile_path, component.set_up) == (
            "c", "meta.yaml", False)
        with pytest.raises(NotImplementedError):
            component.SetUp()
