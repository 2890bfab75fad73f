"""Parity tests: the port's evaluation metrics (m3t_tpu_torch/eval/metrics.py, a copy of
m3t_tpu/eval/metrics.py with timers that synchronise the card) against the JAX
package's, exactly, on seeded inputs."""

import numpy as np
import pytest
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation

from m3t_tpu.eval import metrics as jmetrics
from m3t_tpu_torch.eval import metrics as tmetrics

SEEDS = range(4)


def _pose(rng, rotation_scale=0.3, translation_scale=0.1):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * rotation_scale).as_matrix()
    pose[:3, 3] = rng.normal(size=3) * translation_scale + [0.0, 0.0, 0.6]
    return pose


def _pair(seed):
    rng = np.random.default_rng(seed)
    gt = _pose(rng)
    est = gt @ _pose(rng, 0.05 * seed, 0.01 * seed) if seed else gt.copy()
    est[2, 3] -= 0.6 * bool(seed)
    return rng, est, gt


@pytest.mark.parametrize("seed", SEEDS)
def test_pose_errors_match_jax(seed):
    _, est, gt = _pair(seed)
    for name in ("translation_error", "rotation_error", "tracking_success", "choi_errors"):
        assert getattr(tmetrics, name)(est, gt) == getattr(jmetrics, name)(est, gt), name
    assert (tmetrics.tracking_success(est, gt, 0.01, 0.02)
            == jmetrics.tracking_success(est, gt, 0.01, 0.02))


@pytest.mark.parametrize("seed", SEEDS)
def test_add_adds_match_jax(seed):
    rng, est, gt = _pair(seed)
    vertices = rng.normal(size=(1500, 3)).astype(np.float32) * 0.05
    reduced = tmetrics.reduce_vertices(vertices)
    np.testing.assert_array_equal(reduced, jmetrics.reduce_vertices(vertices))
    assert len(reduced) == 1000
    assert tmetrics.add_error(reduced, est, gt) == jmetrics.add_error(reduced, est, gt)
    tree = cKDTree(reduced)
    assert (tmetrics.adds_error(reduced, est, gt, tree)
            == jmetrics.adds_error(reduced, est, gt, tree)
            == jmetrics.adds_error(reduced, est, gt))


@pytest.mark.parametrize("seed", SEEDS)
def test_curves_and_rmse_match_jax(seed):
    rng = np.random.default_rng(seed)
    errors = rng.uniform(0.0, 0.25, size=16)
    for error in errors:
        assert tmetrics.auc_from_error(error) == jmetrics.auc_from_error(error)
        assert tmetrics.auc_from_error(error, 0.2) == jmetrics.auc_from_error(error, 0.2)
        np.testing.assert_array_equal(tmetrics.error_curve(error, 0.1, 100),
                                      jmetrics.error_curve(error, 0.1, 100))
        np.testing.assert_array_equal(tmetrics.opt_curve(error, 0.12, 100, 0.2),
                                      jmetrics.opt_curve(error, 0.12, 100, 0.2))
    assert tmetrics.rmse(errors) == jmetrics.rmse(errors)
    assert tmetrics.rmse([]) == jmetrics.rmse([]) == 0.0


class _Tracker:
    """The tracker methods that the step timers call, recording the calls; fails at
    ``fail`` (a method name) when given."""

    def __init__(self, fail=None, fused=False):
        self.n_corr_iterations, self.n_update_iterations = 2, 3
        self.use_fused_cycle = fused
        self.modality_ptrs = []
        self.calls = []
        self.fail = fail

    def _fused_serve_backend(self):
        return object()

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return name != self.fail
        return call


@pytest.mark.parametrize("fail,fused", [(None, False), ("CalculateOptimization", False),
                                        ("CalculateResults", False), (None, True)])
def test_step_timers_call_as_jax(fail, fused):
    """execute_tracking_step_maybe_fused calls the tracker's phases in the JAX package's
    order, stops where a phase fails, and reports the same keys."""
    got, want = _Tracker(fail, fused), _Tracker(fail, fused)
    times = tmetrics.execute_tracking_step_maybe_fused(got, 7)
    jtimes = jmetrics.execute_tracking_step_maybe_fused(want, 7)
    assert got.calls == want.calls
    assert times.keys() == jtimes.keys()
    assert all(t >= 0.0 for t in times.values())
    if fail is None and not fused:
        assert len(got.calls) == 2 * (1 + 2 * 3) + 1
