"""Parity tests: the port's host utilities (utils/timing.py, utils/ref_model_io.py,
utils/benchtime.py) against the JAX package's, on the CPU; and the package's imports
without OpenCV, the camera SDKs, JAX or the JAX package.
"""

import inspect
import struct
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from m3t_tpu.utils import ref_model_io as jref_model_io
from m3t_tpu.utils import timing as jtiming
from m3t_tpu_torch.utils import benchtime as tbenchtime
from m3t_tpu_torch.utils import ref_model_io as tref_model_io
from m3t_tpu_torch.utils import timing as ttiming
from tests import test_benchtime

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------------------
# benchtime: tests/test_benchtime.py's cases on the port's copy
# ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", [n for n, f in inspect.getmembers(test_benchtime)
                                  if n.startswith("test_") and inspect.isfunction(f)])
def test_benchtime_twin(name, monkeypatch):
    """Each case of tests/test_benchtime.py, with its module's ``benchtime`` bound to
    the port's copy."""
    monkeypatch.setattr(test_benchtime, "benchtime", tbenchtime)
    getattr(test_benchtime, name)()


# ---------------------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------------------


class _RecordingTracker:
    """The four calls timed_tracking_cycle makes, recorded; fails the call whose
    number is fail_at."""

    def __init__(self, fail_at=None):
        self.n_corr_iterations, self.n_update_iterations = 3, 2
        self.calls, self.fail_at = [], fail_at

    def _record(self, *args):
        self.calls.append(args)
        return len(self.calls) != self.fail_at

    def CalculateCorrespondences(self, *args):  # noqa: N802
        return self._record("corr", *args)

    def CalculateGradientAndHessian(self, *args):  # noqa: N802
        return self._record("grad", *args)

    def CalculateOptimization(self, *args):  # noqa: N802
        return self._record("opt", *args)

    def CalculateResults(self, *args):  # noqa: N802
        return self._record("results", *args)


@pytest.mark.parametrize("fail_at", [None, 4, 16])
def test_timed_tracking_cycle_matches_jax(fail_at):
    out = {}
    for name, module in (("jax", jtiming), ("torch", ttiming)):
        tracker = _RecordingTracker(fail_at)
        timer = module.ExecutionTimer()
        ok = module.timed_tracking_cycle(tracker, 7, timer)
        out[name] = (ok, tracker.calls, {k: v["count"] for k, v in timer.summary().items()})
    assert out["torch"] == out["jax"]
    ok, calls, counts = out["torch"]
    assert ok == (fail_at is None)
    if fail_at is None:
        assert len(calls) == 3 * (1 + 2 * 2) + 1
        assert counts == {"complete_cycle": 1, "calculate_correspondences": 3,
                          "calculate_gradient_and_hessian": 6,
                          "calculate_optimization": 6, "calculate_results": 1}


def test_execution_timer_spans_and_profiler_ranges():
    """Spans accumulate time and counts; with use_profiler_ranges each span is a
    torch.profiler range of its name (the JAX timer's TraceAnnotation)."""
    timer = ttiming.ExecutionTimer(use_profiler_ranges=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with timer.span("calculate_correspondences"):
                torch.ones(4).sum()
    names = [e.key for e in prof.key_averages()]
    assert "calculate_correspondences" in names
    assert timer.counts["calculate_correspondences"] == 3
    assert timer.mean("calculate_correspondences") > 0.0
    assert timer.mean("never") == 0.0
    summary = timer.summary()["calculate_correspondences"]
    assert summary["count"] == 3 and summary["total_s"] == pytest.approx(
        3 * summary["mean_s"])
    timer.reset()
    assert timer.summary() == {}
    assert not ttiming.ExecutionTimer().use_profiler_ranges


# ---------------------------------------------------------------------------------------
# ref_model_io: reference-format model files read by both packages
# ---------------------------------------------------------------------------------------


def _body_data(path: str, pose: np.ndarray) -> bytes:
    raw = path.encode()
    return (struct.pack("<Q", len(raw)) + raw + struct.pack("<f??f", 0.001, True, False, 0.18)
            + pose.T.astype("<f4").tobytes())


def _write_ref_model(path, kind: str, rng, n_views: int = 3, n_points: int = 5,
                     version=None, trailing: bytes = b"") -> dict:
    """A model file in the reference's binary layout (model.cpp:286-330 and the
    region/depth SaveModel), with random contents; returns what it holds."""
    pose = rng.normal(size=(4, 4)).astype(np.float32)
    n_floats = 38 if kind == "r" else 36
    data = rng.normal(size=(n_views, n_points, n_floats)).astype(np.float32)
    orientations = rng.normal(size=(n_views, 3)).astype(np.float32)
    extra = rng.random(n_views).astype(np.float32)
    out = kind.encode() + struct.pack(
        "<ifiiff?i", version or (10 if kind == "r" else 9), 0.8, 2, n_points, 0.05, 0.002,
        True, 2000)
    out += _body_data("body.obj", pose)
    if kind == "r":
        out += struct.pack("<Q", 1) + struct.pack("<Q", 0) + struct.pack("<Q", 1)
        out += _body_data("fixed.obj", pose) + struct.pack("<QQ", 0, 0)
    else:
        out += struct.pack("<Q", 1) + _body_data("occluder.obj", pose)
    out += struct.pack("<Q", n_views)
    for v in range(n_views):
        out += data[v].astype("<f4").tobytes() + orientations[v].astype("<f4").tobytes()
        out += struct.pack("<f", extra[v])
    Path(path).write_bytes(out + trailing)
    return dict(pose=pose, data=data, orientations=orientations, extra=extra)


def _assert_same(got, want):
    if isinstance(want, (tuple, list)):
        assert type(got).__name__ == type(want).__name__ and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("kind", ["r", "d"])
def test_ref_model_round_trip_matches_jax(kind, tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / f"model_{kind}.bin"
    written = _write_ref_model(path, kind, rng)
    got = tref_model_io.load_ref_model(str(path))
    _assert_same(got, jref_model_io.load_ref_model(str(path)))
    np.testing.assert_array_equal(got.body.geometry2body_pose, written["pose"])
    np.testing.assert_array_equal(got.centers, written["data"][..., 0:3])
    np.testing.assert_array_equal(got.normals, written["data"][..., 3:6])
    np.testing.assert_array_equal(got.depth_offsets, written["data"][..., -30:])
    np.testing.assert_array_equal(got.orientations, written["orientations"])
    if kind == "r":
        np.testing.assert_array_equal(got.foreground_distances, written["data"][..., 6])
        np.testing.assert_array_equal(got.contour_lengths, written["extra"])
        assert [len(a) for a in got.associated_bodies] == [0, 1, 0, 0]
        assert got.associated_bodies[1][0].geometry_path == "fixed.obj"
    else:
        np.testing.assert_array_equal(got.surface_areas, written["extra"])
        assert got.associated_bodies[0][0].geometry_path == "occluder.obj"


@pytest.mark.parametrize("fault", ["type", "version", "trailing"])
def test_ref_model_rejects_bad_files_as_jax(fault, tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "bad.bin"
    _write_ref_model(path, "r", rng, version=7 if fault == "version" else None,
                     trailing=b"\0\0" if fault == "trailing" else b"")
    if fault == "type":
        raw = bytearray(path.read_bytes())
        raw[0] = ord("x")
        path.write_bytes(bytes(raw))
    messages = []
    for module in (jref_model_io, tref_model_io):
        with pytest.raises(ValueError) as error:
            module.load_ref_model(str(path))
        messages.append(str(error.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------------------
# Imports: no OpenCV, camera SDK, JAX or JAX package needed
# ---------------------------------------------------------------------------------------


def test_package_imports_without_cv2_sdks_or_jax():
    """A fresh interpreter in which cv2, pyk4a, pyrealsense2, jax and m3t_tpu cannot be
    imported imports m3t_tpu_torch, every one of its modules and every lazy name, and
    loads none of them; the generator's YAML reader parses a config there."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for name in ('cv2', 'pyk4a', 'pyrealsense2', 'jax', 'm3t_tpu', 'yaml'):\n"
        "    sys.modules[name] = None\n"
        "import m3t_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(m3t_tpu_torch.__path__,\n"
        "                                              'm3t_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for name in m3t_tpu_torch._LAZY:\n"
        "    getattr(m3t_tpu_torch, name)\n"
        "from m3t_tpu_torch import generator, hardware_camera, texture_modality, viewer\n"
        "need = {'m3t_tpu_torch.' + m for m in ('constraint', 'soft_constraint',\n"
        "        'renderer_geometry', 'renderer', 'texture_modality', 'utils.features',\n"
        "        'viewer', 'hardware_camera', 'generator', 'utils.ref_model_io',\n"
        "        'utils.timing', 'utils.benchtime', 'bench')}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('cv2', 'pyk4a', 'pyrealsense2', 'jax',\n"
        "                                     'm3t_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) > 40


def test_missing_sdks_fail_where_they_are_needed(monkeypatch):
    """Without cv2 the texture modality's SetUp and the OpenCV camera raise
    ImportError; without pyk4a a Kinect camera's SetUp returns False."""
    from m3t_tpu_torch import hardware_camera
    from m3t_tpu_torch.texture_modality import TextureModality

    for name in ("cv2", "pyk4a"):
        monkeypatch.setitem(sys.modules, name, None)
    ready = SimpleNamespace(set_up=True)
    modality = TextureModality("nt", ready, ready, ready)
    with pytest.raises(ImportError):
        modality.SetUp()
    with pytest.raises(ImportError):
        hardware_camera.OpenCVColorCamera("nt_cam").SetUp()
    hardware_camera.AzureKinect.reset_instance()
    try:
        camera = hardware_camera.AzureKinectColorCamera("nt_kinect")
        assert camera.SetUp() is False and not camera.set_up
    finally:
        hardware_camera.AzureKinect.reset_instance()
