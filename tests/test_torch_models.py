"""Host model generation of the port (``m3t_tpu_torch.region_model``, ``depth_model``,
``model_base``, ``body`` and the native host library) against the JAX package's.

Models are compared bit for bit: every array with ``np.array_equal`` and the dtype, and
the cache file's checksum string.  Both packages reseed the sampler for every view, so
a ``view_subset`` model's rows equal the same rows of the full model: that keeps the
cases small (a few views, image size 300 or bench.py's 800).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from m3t_tpu import pipeline as jpipe
from m3t_tpu.body import Body as JBody
from m3t_tpu.depth_model import DepthModel as JDepthModel
from m3t_tpu.ops import raster as jraster
from m3t_tpu.region_model import RegionModel as JRegionModel
from m3t_tpu.utils import procedural as jproc
from m3t_tpu_torch import native
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.body import Body as TBody
from m3t_tpu_torch.depth_model import DepthModel as TDepthModel
from m3t_tpu_torch.ops import raster as traster
from m3t_tpu_torch.region_model import RegionModel as TRegionModel
from m3t_tpu_torch.utils import procedural as tproc

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "m3t_tpu_torch" / "data"
REGION_ARRAYS = ("orientations", "centers", "normals", "foreground_distances",
                 "background_distances", "depth_offsets", "contour_lengths")
DEPTH_ARRAYS = ("orientations", "centers", "normals", "depth_offsets", "surface_areas")
KINDS = {"region": (JRegionModel, TRegionModel, REGION_ARRAYS),
         "depth": (JDepthModel, TDepthModel, DEPTH_ARRAYS)}
# A small fixture: the sphere of tests/fixtures.py seen from 6 of the 42 views of
# n_divides 1, at image size 300.
FIXTURE = dict(n_divides=1, n_points=64, image_size=300, sphere_radius=0.5,
               view_subset=[0, 7, 15, 22, 30, 41])
# bench.py's models (bench.py:124-127, 205-206) at four views spread over the 162.
BENCH = dict(n_divides=2, n_points=200, image_size=800)
BENCH_VIEWS = [0, 53, 107, 161]


def _cube(package, name, offset, half=0.03):
    """A cube Body of either package, its geometry moved by offset in the body frame."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = offset
    verts, tris = tproc.cube(half)
    body = (JBody if package == "jax" else TBody)(name, vertices=verts, triangles=tris,
                                                  geometry2body_pose=pose)
    assert body.SetUp()
    return body


def _set_up(model):
    assert model.SetUp()
    return model


def _assert_models_equal(got, want, names):
    for name in names:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _assert_files_equal(got_path, want_path):
    with np.load(got_path) as got, np.load(want_path) as want:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            assert got[name].dtype == want[name].dtype, name
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("kind", list(KINDS))
def test_fixture_sphere_model_matches_jax(kind, tmp_path):
    """The port's model of the fixture sphere equals the JAX package's, and so does the
    cache file it writes, checksum included; both pick the same closest views."""
    jcls, tcls, names = KINDS[kind]
    jmodel = _set_up(jcls("m", jproc.sphere_body("fixture_sphere"), str(tmp_path / "j.npz"),
                          **FIXTURE))
    tmodel = _set_up(tcls("m", tproc.sphere_body("fixture_sphere"), str(tmp_path / "t.npz"),
                          **FIXTURE))
    _assert_models_equal(tmodel, jmodel, names)
    assert (tmodel.contour_lengths > 0).all() if kind == "region" else \
        (tmodel.surface_areas > 0).all()
    _assert_files_equal(tmp_path / "t.npz", tmp_path / "j.npz")
    rng = np.random.default_rng(4)
    for _ in range(8):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        pose[:3, 3] = rng.normal(size=3)
        got, want = tmodel.GetClosestView(pose), jmodel.GetClosestView(pose)
        assert tmodel.GetClosestViewIndex(pose) == jmodel.GetClosestViewIndex(pose)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_associated_and_occlusion_bodies_match_jax(tmp_path):
    """A fixed, a movable and a same-region cube around the sphere run every render of
    the region model (m3t_tpu/region_model.py:200-225), and a cube occlusion body the
    occlusion silhouette of the depth model (m3t_tpu/depth_model.py:131-143)."""
    models = {}
    for package, proc, rcls, dcls in (("jax", jproc, JRegionModel, JDepthModel),
                                      ("torch", tproc, TRegionModel, TDepthModel)):
        sphere = proc.sphere_body("assoc_sphere")
        region = rcls("r", sphere, str(tmp_path / f"{package}_r.npz"), **FIXTURE)
        region.AddAssociatedBody(_cube(package, "fixed", [0.07, 0.0, 0.0]), False, False)
        region.AddAssociatedBody(_cube(package, "movable", [0.0, 0.07, 0.02]), True, False)
        region.AddAssociatedBody(_cube(package, "same", [-0.06, -0.03, 0.0]), False, True)
        region.AddAssociatedBody(_cube(package, "moving same", [0.0, -0.02, 0.07], 0.02),
                                 True, True)
        depth = dcls("d", sphere, str(tmp_path / f"{package}_d.npz"), **FIXTURE)
        depth.AddOcclusionBody(_cube(package, "occluder", [0.04, 0.0, 0.04]))
        models[package] = (_set_up(region), _set_up(depth))
    _assert_models_equal(models["torch"][0], models["jax"][0], REGION_ARRAYS)
    _assert_models_equal(models["torch"][1], models["jax"][1], DEPTH_ARRAYS)
    for suffix in ("r", "d"):
        _assert_files_equal(tmp_path / f"torch_{suffix}.npz", tmp_path / f"jax_{suffix}.npz")
    plain = _set_up(TRegionModel("plain", tproc.sphere_body("plain_sphere"),
                                 str(tmp_path / "plain.npz"), **FIXTURE))
    assert not np.array_equal(plain.contour_lengths, models["torch"][0].contour_lengths)


@pytest.mark.parametrize("kind", list(KINDS))
def test_bench_sphere_views_match_committed_npz(kind, tmp_path):
    """bench.py's sphere at four spread views equals those rows of the committed
    m3t_tpu_torch/data npz that the JAX package generated."""
    _, tcls, names = KINDS[kind]
    body = tproc.sphere_body("bench_sphere", radius=0.06, n_subdiv=2)
    model = _set_up(tcls("bench", body, str(tmp_path / "b.npz"), view_subset=BENCH_VIEWS,
                         **BENCH))
    with np.load(DATA / f"bench_sphere_{kind}_model.npz") as want:
        for name in names:
            got = getattr(model, name)
            assert got.dtype == want[name].dtype, name
            np.testing.assert_array_equal(got, want[name][BENCH_VIEWS], err_msg=name)


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_cache_file_loads_in_the_other_package(kind, writer, tmp_path, monkeypatch):
    """A cache file written by either package loads in the other without regenerating."""
    jcls, tcls, names = KINDS[kind]
    path = str(tmp_path / "cache.npz")
    write_cls, read_cls = (jcls, tcls) if writer == "jax" else (tcls, jcls)
    read_proc = tproc if writer == "jax" else jproc
    written = _set_up(write_cls("m", (jproc if writer == "jax" else tproc).sphere_body(
        "cache_sphere"), path, **FIXTURE))
    before = Path(path).read_bytes()
    reader = read_cls("m", read_proc.sphere_body("cache_sphere"), path, **FIXTURE)

    def regenerate():
        raise AssertionError("the cache file was not taken")

    monkeypatch.setattr(reader, "_generate_model", regenerate)
    _set_up(reader)
    _assert_models_equal(reader, written, names)
    assert Path(path).read_bytes() == before


@pytest.mark.parametrize("kind", list(KINDS))
def test_from_models_equals_from_npz_and_jax(kind, tmp_path):
    """from_models of set-up models equals from_npz of their cache files, and the JAX
    package's from_models; V is padded across bodies of different view counts."""
    jcls, tcls, _ = KINDS[kind]
    views = ([0, 7, 15], FIXTURE["view_subset"])
    models, paths = [], []
    for i, subset in enumerate(views):
        paths.append(str(tmp_path / f"m{i}.npz"))
        models.append(_set_up(tcls(f"m{i}", tproc.sphere_body(f"stack_sphere{i}"), paths[-1],
                                   **dict(FIXTURE, view_subset=subset))))
    arrays = tpipe.RegionModelArrays if kind == "region" else tpipe.DepthModelArrays
    got = arrays.from_models(models, 48, device="cpu")
    from_npz = arrays.from_npz(paths, 48, device="cpu")
    jmodels = [_set_up(jcls(f"m{i}", jproc.sphere_body(f"stack_sphere{i}"), paths[i],
                            **dict(FIXTURE, view_subset=subset)))
               for i, subset in enumerate(views)]
    want = (jpipe.RegionModelArrays if kind == "region" else jpipe.DepthModelArrays
            ).from_models(jmodels, 48)
    for name in arrays._fields:
        assert torch.equal(getattr(got, name), getattr(from_npz, name)), name
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    with pytest.raises(ValueError, match="set-up"):
        arrays.from_models([tcls("n", models[0].body_ptr, paths[0], **FIXTURE)], 48,
                           device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            arrays.from_models(models, 48)


@pytest.mark.parametrize("with_normals", [False, True])
def test_rasterize_np_native_and_numpy_match_jax(with_normals):
    """Both paths of the port's rasterize_np equal the same paths of the JAX package's
    on the same triangles: a sphere, random triangles crossing the image border, some
    behind the near plane, with per-triangle culling."""
    rng = np.random.default_rng(17)
    sphere = tproc.sphere_triangles(0.05, 2) + np.float32([0.01, -0.02, 0.4])
    tri = rng.uniform(-0.2, 0.2, (60, 3, 3)).astype(np.float32)
    tri[..., 2] = rng.uniform(-0.01, 0.8, (60, 3))
    tri = np.concatenate([sphere, tri])
    ids = rng.integers(1, 200, len(tri))
    cull = rng.random(len(tri)) < 0.5
    args = (tri, ids, 210.0, 205.0, 79.5, 61.0, 160, 120)
    for use_native in (True, False):
        got = traster.rasterize_np(*args, cull_backfaces=cull, with_normals=with_normals,
                                   use_native=use_native)
        want = jraster.rasterize_np(*args, cull_backfaces=cull, with_normals=with_normals,
                                    use_native=use_native)
        assert len(got) == len(want) == 2 + with_normals
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert (got[1] > 0).sum() > 1000


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output, and
    rasterize_np does not fall back to numpy when the library cannot be had."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("int f( {\n")
    monkeypatch.setattr(native, "SOURCES", (broken,))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="broken.cpp"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so*"))

    def missing():
        raise RuntimeError("no host library")

    monkeypatch.setattr(native, "library", missing)
    tri = tproc.sphere_triangles(0.05, 1) + np.float32([0.0, 0.0, 0.4])
    with pytest.raises(RuntimeError, match="no host library"):
        traster.rasterize_np(tri, np.ones(len(tri)), 200.0, 200.0, 40.0, 40.0, 80, 80)
    depth, _ = traster.rasterize_np(tri, np.ones(len(tri)), 200.0, 200.0, 40.0, 40.0, 80,
                                    80, use_native=False)
    assert np.isfinite(depth).any()


def test_model_modules_need_neither_cv2_nor_jax(tmp_path):
    """With cv2, jax and m3t_tpu made unimportable, the model modules import and
    generate a one-view region and depth model."""
    code = (
        "import sys\n"
        "for name in ('cv2', 'jax', 'm3t_tpu', 'yaml'):\n"
        "    sys.modules[name] = None\n"
        "import m3t_tpu_torch.region_model as rm, m3t_tpu_torch.depth_model as dm\n"
        "import m3t_tpu_torch.body, m3t_tpu_torch.utils.yaml_io\n"
        "from m3t_tpu_torch.utils import procedural\n"
        "body = procedural.sphere_body('iso', 0.05, 1)\n"
        "kw = dict(n_divides=1, n_points=16, image_size=120, view_subset=[3])\n"
        f"r = rm.RegionModel('r', body, {str(tmp_path / 'r.npz')!r}, **kw)\n"
        f"d = dm.DepthModel('d', body, {str(tmp_path / 'd.npz')!r}, **kw)\n"
        "assert r.SetUp() and d.SetUp()\n"
        "assert r.centers.shape == (1, 16, 3) and r.contour_lengths[0] > 0\n"
        "assert d.centers.shape == (1, 16, 3) and d.surface_areas[0] > 0\n"
        "bad = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "             and m.split('.')[0] in ('cv2', 'jax', 'm3t_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
