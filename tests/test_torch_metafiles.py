"""The port's metafile reader (``m3t_tpu_torch.utils.yaml_io``, no OpenCV) against the
JAX package's, which reads through ``cv2.FileStorage``, and the port's ``Body`` and
model metadata set up from metafiles against the JAX package's."""

import cv2
import numpy as np
import pytest

from m3t_tpu.body import Body as JBody
from m3t_tpu.region_model import RegionModel as JRegionModel
from m3t_tpu.utils import obj_loader
from m3t_tpu.utils import yaml_io as jyaml
from m3t_tpu_torch.body import Body as TBody
from m3t_tpu_torch.depth_model import DepthModel as TDepthModel
from m3t_tpu_torch.region_model import RegionModel as TRegionModel
from m3t_tpu_torch.utils import procedural
from m3t_tpu_torch.utils import yaml_io as tyaml

POSE = np.array([[0.0, -1.0, 0.0, 0.01], [1.0, 0.0, 0.0, -0.02], [0.0, 0.0, 1.0, 0.3],
                 [0.0, 0.0, 0.0, 1.0]])


def _written_by_opencv(path, entries):
    """A metafile as cv2.FileStorage writes it; dict values become nested maps."""
    fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_WRITE)
    for key, value in entries.items():
        if isinstance(value, dict):
            fs.startWriteStruct(key, cv2.FileNode_MAP)
            for k, v in value.items():
                fs.write(k, v)
            fs.endWriteStruct()
        elif isinstance(value, list):
            fs.startWriteStruct(key, cv2.FileNode_SEQ)
            for v in value:
                fs.write("", v)
            fs.endWriteStruct()
        else:
            fs.write(key, value)
    fs.release()
    return str(path)


def _written_by_hand(path, text):
    path.write_text("%YAML:1.0\n---\n" + text)
    return str(path)


def _read_both(path, names):
    fs = jyaml.open_yaml_file_storage(path)
    try:
        want = {name: jyaml.read_optional(fs, name, "absent") for name in names}
    finally:
        fs.release()
    got_fs = tyaml.open_yaml_file_storage(path)
    return {name: tyaml.read_optional(got_fs, name, "absent") for name in names}, want


def _assert_same_values(got, want):
    for name in want:
        g, w = got[name], want[name]
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            assert type(g) is type(w) and g == w, (name, g, w)


@pytest.mark.parametrize("writer", ["opencv", "hand"])
def test_yaml_values_match_opencv_reader(tmp_path, writer):
    """Scalars (ints, floats of every spelling, true/false, strings with spaces,
    colons and quotes), flow and block sequences (also of maps), a pose matrix in float
    and double, and a nested intrinsics map read to the values that cv2.FileStorage
    gives the JAX package."""
    if writer == "opencv":
        path = _written_by_opencv(tmp_path / "meta.yaml", dict(
            geometry_path="dir with space/cube.obj", unit=0.001, count=-3, big=1e-12,
            whole=3.0, label="a b: c", quoted='say "hi"', seq=[1, 2.5, "x"],
            pose_f=POSE.astype(np.float32), pose_d=POSE, mat=np.arange(6.0).reshape(2, 3),
            intrinsics=dict(f_u=612.5, f_v=611.0, pp_x=320.25, pp_y=240.0, width=640,
                            height=480)))
    else:
        path = _written_by_hand(tmp_path / "meta.yaml", (
            "geometry_path: \"dir with space/cube.obj\"  # a comment\n"
            "unit: 1e-3\ncount: -3\nbig: .5\nwhole: 3.\nflag: true\noff: false\n"
            "hex: 0x1F\nlabel: plain words here\nquoted: 'it''s'\n"
            "seq: [1, 2.5, x]\nlong: [ 1, 2,\n   3, 4 ]\n"
            "block:\n  - 1\n  - two words\n  - [3, 4]\n"
            "maps:\n  - name: a\n    val: 1\n  - name: b\n    val: [1, 2]\n  -\n    x: 3\n"
            "pose_d: !!opencv-matrix\n   rows: 4\n   cols: 4\n   dt: d\n   data: [ "
            + ", ".join(map(repr, POSE.ravel().tolist()[:9])) + ",\n       "
            + ", ".join(map(repr, POSE.ravel().tolist()[9:])) + " ]\n"
            "intrinsics:\n   f_u: 612.5\n   f_v: 611.\n   pp_x: 320.25\n   pp_y: 240.\n"
            "   width: 640\n   height: 480\n"
            "nothing: null\n"))
    names = ["geometry_path", "unit", "count", "big", "whole", "flag", "off", "hex",
             "label", "quoted", "seq", "long", "block", "maps", "pose_f", "pose_d", "mat",
             "nothing", "missing"]
    got, want = _read_both(path, names)
    _assert_same_values(got, want)
    assert sum(v != "absent" for v in want.values() if not isinstance(v, np.ndarray)) > 5
    jfs, tfs = jyaml.open_yaml_file_storage(path), tyaml.open_yaml_file_storage(path)
    assert tuple(tyaml.read_intrinsics(tfs)) == tuple(jyaml.read_intrinsics(jfs))
    np.testing.assert_array_equal(tyaml.read_pose(tfs, "pose_d"), jyaml.read_pose(jfs, "pose_d"))
    np.testing.assert_array_equal(tyaml.read_pose(tfs, "missing"), np.eye(4, dtype=np.float32))
    jfs.release()
    with pytest.raises(tyaml.MetafileError):
        tyaml.read_required(tfs, "missing")


def test_yaml_refuses_missing_and_malformed_files(tmp_path):
    with pytest.raises(tyaml.MetafileError):
        tyaml.open_yaml_file_storage(str(tmp_path / "absent.yaml"))
    bad = tmp_path / "bad.yaml"
    bad.write_text("%YAML:1.0\n---\nkey: [1, 2\n")
    with pytest.raises(tyaml.MetafileError):
        tyaml.open_yaml_file_storage(str(bad))


@pytest.mark.parametrize("counterclockwise", [1, 0])
def test_body_from_metafile_matches_jax(tmp_path, counterclockwise):
    """A Body set up from a metafile (written by cv2.FileStorage) and an .obj in
    millimetres equals the JAX package's: mesh, winding, pose, ids and diameter."""
    verts, tris = procedural.icosphere(1, 50.0)
    obj_loader.save_obj(str(tmp_path / "ball.obj"), verts, tris)
    meta = _written_by_opencv(tmp_path / "ball.yaml", dict(
        geometry_path="INFER_FROM_NAME", geometry_unit_in_meter=0.001,
        geometry_counterclockwise=counterclockwise, geometry_enable_culling=1,
        geometry2body_pose=POSE.astype(np.float32), body_id=7, region_id=9))
    jbody, tbody = JBody("ball", metafile_path=meta), TBody("ball", metafile_path=meta)
    assert jbody.SetUp() and tbody.SetUp()
    for name in ("vertices", "triangles", "geometry2body_pose"):
        want = getattr(jbody, name)
        assert getattr(tbody, name).dtype == want.dtype, name
        np.testing.assert_array_equal(getattr(tbody, name), want, err_msg=name)
    np.testing.assert_array_equal(tbody.triangle_vertices_f_body(),
                                  jbody.triangle_vertices_f_body())
    for name in ("geometry_path", "geometry_unit_in_meter", "geometry_counterclockwise",
                 "geometry_enable_culling", "body_id", "region_id",
                 "maximum_body_diameter"):
        assert getattr(tbody, name) == getattr(jbody, name), name
    assert tbody.body_id == 7 and tbody.maximum_body_diameter > 0.09


def test_model_metadata_matches_jax(tmp_path):
    """Model parameters and the model path from a metafile, as the JAX package reads
    them (INFER_FROM_NAME, the model type's suffix)."""
    meta = _written_by_opencv(tmp_path / "m.yaml", dict(
        model_path="INFER_FROM_NAME", sphere_radius=0.6, n_divides=2, n_points=150,
        max_radius_depth_offset=0.04, stride_depth_offset=0.003, use_random_seed=0,
        image_size=900))
    names = ("model_path", "sphere_radius", "n_divides", "n_points",
             "max_radius_depth_offset", "stride_depth_offset", "use_random_seed",
             "image_size")
    jmodel = JRegionModel("obj", None, "", metafile_path=meta)
    tmodel = TRegionModel("obj", None, "", metafile_path=meta)
    assert jmodel._load_metadata() and tmodel._load_metadata()
    for name in names:
        assert getattr(tmodel, name) == getattr(jmodel, name), name
    assert tmodel.model_path.endswith("obj_rmodel.npz")
    depth = TDepthModel("obj", None, "", metafile_path=meta)
    assert depth._load_metadata() and depth.model_path.endswith("obj_dmodel.npz")
