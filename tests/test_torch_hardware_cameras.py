"""The port's live cameras (hardware_camera.py) against the fake SDKs of
tests/test_hardware_cameras.py, on the CPU.

Every case of that file (the Azure Kinect's shared synchronized capture, intrinsics,
image scale, world frames, shutdown on the last user and missing SDK; the RealSense's
capture sharing, depth scale and column-major extrinsics; the OpenCV camera; the
metafile) runs as it is written there, with the names it imports from the JAX package
bound to the port's classes, so that both packages meet the same assertions.  The
generator's hardware nodes are held with the port's generator.
"""

import inspect

import pytest

from m3t_tpu_torch import common as tcommon
from m3t_tpu_torch import generator as tgenerator
from m3t_tpu_torch import hardware_camera as thardware_camera
from tests import test_hardware_cameras as jtests
from tests.test_hardware_cameras import fake_pyk4a, fake_rs  # noqa: F401 (fixtures)

PORTED = ("AzureKinect", "AzureKinectColorCamera", "AzureKinectDepthCamera",
          "OpenCVColorCamera", "RealSense", "RealSenseColorCamera", "RealSenseDepthCamera")
CASES = [name for name, fn in inspect.getmembers(jtests, inspect.isfunction)
         if name.startswith("test_") and name != "test_generator_recognizes_hardware_camera_nodes"]


@pytest.fixture(autouse=True)
def port_classes(monkeypatch):
    """The JAX test module's camera names (and its fixtures' AzureKinect and RealSense)
    bound to the port's classes for the test."""
    for name in PORTED:
        monkeypatch.setattr(jtests, name, getattr(thardware_camera, name))
    monkeypatch.setattr(jtests, "Intrinsics", tcommon.Intrinsics)
    yield
    thardware_camera.AzureKinect.reset_instance()
    thardware_camera.RealSense.reset_instance()


@pytest.mark.parametrize("case", CASES)
def test_hardware_camera_case_on_port(case, request):
    fn = getattr(jtests, case)
    assert fn.__globals__ is vars(jtests)
    args = [request.getfixturevalue(p) for p in inspect.signature(fn).parameters]
    fn(*args)


def test_cases_cover_every_class():
    assert len(CASES) >= 9
    source = inspect.getsource(jtests)
    for name in PORTED:
        assert name in source


@pytest.mark.parametrize("class_name,metafile", [
    ("AzureKinectColorCamera", False), ("AzureKinectDepthCamera", True),
    ("RealSenseColorCamera", False), ("RealSenseDepthCamera", True)])
def test_generator_recognizes_hardware_camera_nodes(fake_pyk4a, fake_rs,  # noqa: F811
                                                    monkeypatch, tmp_path, class_name,
                                                    metafile):
    """Twin of tests/test_hardware_cameras.py::test_generator_recognizes_hardware_
    camera_nodes on the port's generator, for each live camera class, with and without
    its optional metafile."""
    created = []
    real = getattr(thardware_camera, class_name)

    class Recording(real):
        def __init__(self, name, metafile_path=None):
            created.append((name, metafile_path))
            super().__init__(name, metafile_path=metafile_path)

    monkeypatch.setattr(thardware_camera, class_name, Recording)
    node = f"  - name: live\n" + ("    metafile_path: live.yaml\n" if metafile else "")
    (tmp_path / "live.yaml").write_text("%YAML:1.2\n---\nsave_images: 0\n")
    config = tmp_path / "config.yaml"
    config.write_text(f"%YAML:1.2\n---\n{class_name}:\n{node}"
                      "Tracker:\n  - name: tracker\n    optimizers: []\n")
    tracker = tgenerator.GenerateConfiguredTracker(str(config), device="cpu")
    assert tracker.name == "tracker"
    assert created == [("live", str(tmp_path / "live.yaml") if metafile else None)]
