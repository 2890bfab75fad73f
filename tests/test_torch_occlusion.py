"""Parity tests: the port's scene-occlusion queries (m3t_tpu_torch.ops.raster,
ops.occlusion, the scene checks of ops.region_fn and ops.depth_fn, and the cycles with a
scene) against the JAX package on the CPU, where its query kernel runs in Pallas
interpret mode.

The scene is tests/test_occlusion_queries.py's, batched over two bodies: a 200x150
frame, the tracked sphere (r 6 cm) at 0.7 m, and a 5 cm cube occluder at (-0.05, 0, 0.5)
for body 0 and at (0.06, 0.02, 0.5) for body 1; 150 lines, scales (2, 1).  Integer
results (validity, ids, masks) must match exactly; coefficients to rtol 1e-5 / atol 1e-6
(one rounding per operation against XLA's fused expressions), inverse depths to rtol
1e-6, and the cycles' poses and histograms to atol 1e-4 as in tests/test_torch_pipeline.py.
The kernel itself is held against its twin on the card by tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu import pipeline as jpipe
from m3t_tpu.depth_model import DepthModel
from m3t_tpu.ops import depth_fn as jdn
from m3t_tpu.ops import occlusion as jocc
from m3t_tpu.ops import raster as jraster
from m3t_tpu.ops import region_fn as jrfn
from m3t_tpu.region_model import RegionModel
from m3t_tpu.utils import procedural as jproc
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.ops import depth_fn as tdn
from m3t_tpu_torch.ops import occlusion as tocc
from m3t_tpu_torch.ops import raster as traster
from m3t_tpu_torch.ops import region_fast as trf
from m3t_tpu_torch.ops import region_fn as trfn
from m3t_tpu_torch.utils import procedural as tproc
from tests import fixtures

W, H, S = 200, 150, 200
N_LINES, N_POINTS = 150, 100
DEPTH_SCALE = 0.001


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def scene_body(body) -> tocc.SceneBody:
    """The port's host record of a JAX Body (mesh in the body frame, ids, culling)."""
    g2b = body.geometry2body_pose
    return tocc.SceneBody(body.vertices @ g2b[:3, :3].T + g2b[:3, 3], body.triangles,
                          body.body_id, body.region_id, body.geometry_enable_culling)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tocc")
    tracked = fixtures.sphere_body("tocc_tracked", radius=0.06, n_subdiv=2)
    occluder = fixtures.cube_body("tocc_occluder", half=0.05)
    intr = fixtures.test_intrinsics(W, H)
    intr4 = (np.float32(intr.fu), np.float32(intr.fv),
             np.float32(intr.ppu), np.float32(intr.ppv))
    pose = np.eye(4, dtype=np.float32)
    pose[2, 3] = 0.7
    poses = np.stack([pose, pose])
    occluder_poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    occluder_poses[:, :3, 3] = [[-0.05, 0.0, 0.5], [0.06, 0.02, 0.5]]

    images, depths = [], []
    for op in occluder_poses:
        verts, ids = [], []
        for i, (body, p) in enumerate([(tracked, pose), (occluder, op)]):
            tri = body.triangle_vertices_f_body()
            verts.append(tri @ p[:3, :3].T + p[:3, 3])
            ids.append(np.full(len(tri), i + 1))
        depth_m, id_img = jraster.rasterize_np(
            np.concatenate(verts), np.concatenate(ids), intr.fu, intr.fv, intr.ppu,
            intr.ppv, W, H, cull_backfaces=True)
        image = np.empty((H, W, 3), np.uint8)
        image[:] = [40, 120, 190]
        image[id_img == 1] = [160, 60, 50]
        image[id_img == 2] = [60, 170, 60]
        images.append(image)
        depths.append(np.where(np.isfinite(depth_m), depth_m / DEPTH_SCALE, 0.0
                               ).astype(np.uint16))

    model = RegionModel("tocc_model", tracked, str(tmp / "m.npz"), n_divides=1,
                        n_points=N_LINES, image_size=200)
    assert model.SetUp()
    dmodel = DepthModel("tocc_dm", tracked, str(tmp / "dm.npz"), n_divides=1,
                        n_points=N_POINTS, image_size=200)
    assert dmodel.SetUp()
    jmodel = jpipe.RegionModelArrays.from_models([model] * 2, N_LINES)
    jdmodel = jpipe.DepthModelArrays.from_models([dmodel] * 2, N_POINTS)
    jgeom = jocc.build_scene_geometry([[tracked, occluder]] * 2)
    tgeom = tocc.build_scene_geometry([[scene_body(tracked), scene_body(occluder)]] * 2,
                                      device="cpu")
    scene_poses = np.concatenate([poses[:, None], occluder_poses[:, None]], axis=1)
    return dict(
        tracked=tracked, occluder=occluder, intr4=intr4, poses=poses,
        occluder_poses=occluder_poses, scene_poses=scene_poses,
        images=np.stack(images), depths=np.stack(depths), jmodel=jmodel,
        jdmodel=jdmodel, jgeom=jgeom, tgeom=tgeom,
        tmodel=tpipe.RegionModelArrays.from_numpy(
            {k: np.asarray(v) for k, v in jmodel._asdict().items()}, device="cpu"),
        tdmodel=tpipe.DepthModelArrays.from_numpy(
            {k: np.asarray(v) for k, v in jdmodel._asdict().items()}, device="cpu"))


@pytest.fixture(scope="module")
def coeffs(scene):
    """The focused scene of both sides: (JAX SceneCoeffs, port SceneCoeffs)."""
    jsc = jocc.focused_scene_coeffs(scene["jgeom"], jnp.asarray(scene["scene_poses"]),
                                    scene["intr4"], W, H, S)
    tsc = tocc.focused_scene_coeffs(scene["tgeom"], _t(scene["scene_poses"]),
                                    scene["intr4"], W, H, S)
    return jsc, tsc


@pytest.fixture(scope="module")
def renders(scene):
    """The focused renders of both sides: (JAX FocusedRender, port FocusedRender)."""
    jr = jocc.focused_render(scene["jgeom"], jnp.asarray(scene["scene_poses"]),
                             scene["intr4"], W, H, S)
    tr = tocc.focused_render(scene["tgeom"], _t(scene["scene_poses"]), scene["intr4"],
                             W, H, S)
    return jr, tr


def _carried(sc):
    """A JAX SceneCoeffs carried across as the port's tensors."""
    return tocc.SceneCoeffs(*(_t(getattr(sc, f)) for f in sc._fields))


# ---------------------------------------------------------------------------------------
# raster: triangle coefficients, decimation, rasterization
# ---------------------------------------------------------------------------------------


def _random_triangles(seed, n=96):
    """Camera-frame triangles: random ones (about half back-facing), a few behind the
    camera or astride z_min, and degenerate ones with repeated vertices."""
    rng = np.random.default_rng(seed)
    tri = np.empty((2, n, 3, 3), np.float32)
    tri[..., :2] = rng.uniform(-0.2, 0.2, (2, n, 3, 2))
    tri[..., 2] = rng.uniform(0.3, 1.0, (2, n, 3))
    tri[:, :4, :, 2] = -0.5                      # behind the camera
    tri[:, 4:8, 0, 2] = 1e-4                     # one vertex in front of z_min
    tri[:, 8:10, 1] = tri[:, 8:10, 0]            # two equal vertices
    tri[:, 10, 1:] = tri[:, 10, :1]              # three equal vertices
    return tri, rng


@pytest.mark.parametrize("cull", ["none", "all", "mixed"])
def test_triangle_coefficients_match_jax(cull):
    tri, rng = _random_triangles(5)
    ids = rng.integers(1, 300, tri.shape[:2]).astype(np.int32)
    culls = {"none": np.zeros(tri.shape[:2], bool), "all": np.ones(tri.shape[:2], bool),
             "mixed": rng.random(tri.shape[:2]) > 0.5}[cull]
    scale = np.array([1.0, 0.6], np.float32)
    fu, fv = np.float32(150.0) * scale, np.float32(140.0) * scale
    ppu, ppv = np.float32(99.5) * scale, np.float32(74.5) * scale
    got = traster.triangle_coefficients(_t(tri), _t(ids), _t(fu), _t(fv), _t(ppu), _t(ppv),
                                        cull_backfaces=_t(culls), z_min=0.02)
    for b in range(2):
        want = jraster.triangle_coefficients(
            jnp.asarray(tri[b]), jnp.asarray(ids[b]), fu[b], fv[b], ppu[b], ppv[b],
            cull_backfaces=jnp.asarray(culls[b]), z_min=0.02)
        np.testing.assert_array_equal(_n(got.valid[b]), np.asarray(want.valid))
        np.testing.assert_array_equal(_n(got.ids[b]), np.asarray(want.ids))
        ok = np.asarray(want.valid)
        assert 20 < ok.sum() < len(ok)
        np.testing.assert_allclose(_n(got.coeffs[b])[ok], np.asarray(want.coeffs)[ok],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_n(got.bbox[b])[ok], np.asarray(want.bbox)[ok],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("target", [256, 60, 400])
def test_decimate_mesh_matches_jax(target):
    verts, tris = tproc.icosphere(2, 0.06)
    got = traster.decimate_mesh(verts, tris, target)
    want = jraster.decimate_mesh(verts, tris, target)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_cube_matches_jax():
    for g, w in zip(tproc.cube(0.05), jproc.cube(0.05)):
        np.testing.assert_array_equal(g, w)


def test_rasterize_and_focused_render_match_jax(renders):
    jr, tr = renders
    for name in ("corner_u", "corner_v", "scale"):
        np.testing.assert_allclose(_n(getattr(tr, name)), np.asarray(getattr(jr, name)),
                                   rtol=1e-6)
    np.testing.assert_array_equal(_n(tr.body_visible), np.asarray(jr.body_visible))
    jd, td = np.asarray(jr.depth), _n(tr.depth)
    same_cover = np.isfinite(jd) == np.isfinite(td)
    assert same_cover.mean() > 0.9995 and np.isfinite(td).mean() > 0.2
    both = np.isfinite(jd) & np.isfinite(td)
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-5)
    for name in ("body_sil", "region_sil"):
        assert (_n(getattr(tr, name)) == np.asarray(getattr(jr, name))).mean() >= 0.999
    # Both bodies of the pair show: the occluder covers part of the crop.
    assert set(np.unique(_n(tr.body_sil))) >= {0, int(jr.body_sil.max())}


# ---------------------------------------------------------------------------------------
# occlusion: scene construction, focused coefficients, the query kernel's twin
# ---------------------------------------------------------------------------------------


def _assert_geometry_equal(got, want):
    for name in want._fields:
        g, w = _n(getattr(got, name)), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("decimate_to", [None, 8])
def test_build_scene_geometry_matches_jax(scene, decimate_to):
    tracked, occluder = scene["tracked"], scene["occluder"]
    scenes = [[tracked, occluder], [occluder]]
    want = jocc.build_scene_geometry(scenes, referenced=[[0], [0]], max_triangles=400,
                                     decimate_to=decimate_to, tracked=[1, 0])
    got = tocc.build_scene_geometry([[scene_body(b) for b in s] for s in scenes],
                                    referenced=[[0], [0]], max_triangles=400,
                                    decimate_to=decimate_to, tracked=[1, 0], device="cpu")
    _assert_geometry_equal(got, want)
    _assert_geometry_equal(scene["tgeom"], scene["jgeom"])


def test_build_kinematic_scene_geometry_matches_jax(scene):
    tracked, occluder = scene["tracked"], scene["occluder"]
    want = jocc.build_kinematic_scene_geometry([[tracked, occluder]] * 2,
                                               extras=[occluder])
    got = tocc.build_kinematic_scene_geometry(
        [[scene_body(tracked), scene_body(occluder)]] * 2, extras=[scene_body(occluder)],
        device="cpu")
    _assert_geometry_equal(got, want)
    assert got.triangles.shape[0] == 4


def test_focused_scene_coeffs_match_jax(coeffs):
    jsc, tsc = coeffs
    for name in ("corner_u", "corner_v", "scale"):
        np.testing.assert_allclose(_n(getattr(tsc, name)), np.asarray(getattr(jsc, name)),
                                   rtol=1e-6)
    for name in ("tri_valid", "sil_id", "body_visible"):
        np.testing.assert_array_equal(_n(getattr(tsc, name)),
                                      np.asarray(getattr(jsc, name)), err_msg=name)
    np.testing.assert_allclose(_n(tsc.coeffs), np.asarray(jsc.coeffs), rtol=1e-5, atol=1e-6)
    valid = _n(tsc.tri_valid)
    n_valid = valid.sum(axis=1)
    assert np.all(valid[:, :n_valid.min()]) and 0 < n_valid.min() < valid.shape[1]
    np.testing.assert_array_equal(_n(tocc.leading_valid_count(tsc.tri_valid)), n_valid)


@pytest.mark.parametrize("points", ["pixels", "continuous"])
def test_query_eval_twin_matches_jax_kernel(coeffs, points):
    """Random (u, v) over and beyond the crop, against JAX _query_eval (Pallas in
    interpret mode) on the JAX coefficients carried across: ids exact, inverse depths
    rtol 1e-6.  At integer pixels, which are all the checks query, that holds as it
    stands.  At continuous points XLA contracts ``c9*u + c10*v`` into one fused
    multiply-add, where the twin (like the kernel) rounds each operation; where the
    plane's terms cancel, that moves inv by an ulp of its largest term (about 40 here),
    so those points get an absolute allowance of 4e-6 beside the rtol."""
    jsc, _ = coeffs
    tsc = _carried(jsc)
    rng = np.random.default_rng(11)
    u = rng.uniform(-10, S + 10, (2, 150, 7)).astype(np.float32)
    v = rng.uniform(-10, S + 10, (2, 150, 7)).astype(np.float32)
    if points == "pixels":
        u, v = np.floor(u), np.floor(v)
    inv, ids = tocc.query_eval_plain(tsc.coeffs, tsc.tri_valid, tsc.sil_id, _t(u), _t(v))
    assert inv.shape == u.shape and ids.dtype == torch.int32
    for b in range(2):
        jinv, jid = jocc._query_eval(jsc.coeffs[b], jsc.tri_valid[b], jsc.sil_id[b],
                                     jnp.asarray(u[b]), jnp.asarray(v[b]))
        np.testing.assert_allclose(_n(inv[b]), np.asarray(jinv), rtol=1e-6,
                                   atol=0 if points == "pixels" else 4e-6)
        np.testing.assert_array_equal(_n(ids[b]), np.asarray(jid))
    assert len(np.unique(_n(ids))) == 3  # background, tracked body, occluder
    assert torch.equal(tocc.query_eval(tsc.coeffs, tsc.tri_valid, tsc.sil_id,
                                       _t(u), _t(v))[1], ids)


def _covering_plane(inv_depth):
    """Coefficients of a triangle that covers every pixel in [-100, 300]^2 at a constant
    inverse depth: edges u + 1000, v + 1000 and 3000 - u - v."""
    return np.array([1, 0, 1000, 0, 1, 1000, -1, -1, 3000, 0, 0, inv_depth], np.float32)


@pytest.mark.parametrize("tie", ["across_chains", "within_chain"])
def test_query_eval_ties_match_jax(tie):
    """Equal planes with different ids: at t = 0 and 1 chain 0 wins the merge; at t = 0
    and 2 (one chain) the earlier triangle wins."""
    coeffs = np.zeros((1, 5, 12), np.float32)
    valid = np.ones((1, 5), bool)
    sil = np.array([[7, 9, 11, 13, 15]], np.int32)
    coeffs[0, 0] = _covering_plane(2.0)
    coeffs[0, 1 if tie == "across_chains" else 2] = _covering_plane(2.0)
    coeffs[0, 3] = _covering_plane(1.0)  # farther: never wins
    valid[0, 4] = False                  # invalid, and a nearer plane: never counts
    coeffs[0, 4] = _covering_plane(5.0)
    rng = np.random.default_rng(2)
    u = rng.uniform(-50, 250, (1, 64)).astype(np.float32)
    v = rng.uniform(-50, 250, (1, 64)).astype(np.float32)
    inv, ids = tocc.query_eval_plain(_t(coeffs), _t(valid), _t(sil), _t(u), _t(v))
    jinv, jid = jocc._query_eval(jnp.asarray(coeffs[0]), jnp.asarray(valid[0]),
                                 jnp.asarray(sil[0]), jnp.asarray(u[0]), jnp.asarray(v[0]))
    np.testing.assert_array_equal(_n(ids[0]), np.asarray(jid))
    np.testing.assert_allclose(_n(inv[0]), np.asarray(jinv), rtol=1e-6)
    assert np.all(_n(ids) == 7) and np.all(_n(inv) == 2.0)


def test_queries_match_port_rasterized_images(coeffs, renders):
    """query_depth_id at every focused pixel == the port's focused_render images, with
    the thresholds of tests/test_occlusion_queries.py::test_queries_match_rasterized_images."""
    _, tsc = coeffs
    _, tr = renders
    iv, iu = torch.meshgrid(torch.arange(S, dtype=torch.float32),
                            torch.arange(S, dtype=torch.float32), indexing="ij")
    depth_q, id_q = tocc.query_depth_id(tsc.coeffs, tsc.tri_valid, tsc.sil_id,
                                        iu.expand(2, S, S), iv.expand(2, S, S))
    depth_q, id_q, depth_img = _n(depth_q), _n(id_q), _n(tr.depth)
    combined = (_n(tr.body_sil) << 8) | _n(tr.region_sil)
    assert np.isfinite(depth_img).mean() > 0.2, "scene must cover the crop"
    assert (np.isfinite(depth_img) == np.isfinite(depth_q)).mean() > 0.9995
    both = np.isfinite(depth_img) & np.isfinite(depth_q)
    np.testing.assert_allclose(depth_q[both], depth_img[both], rtol=1e-5)
    assert (id_q[both] == combined[both]).mean() > 0.999


def test_query_eval_checks_inputs_and_twin_does_not_count():
    coeffs = torch.zeros((2, 4, 12))
    valid = torch.ones((2, 4), dtype=torch.bool)
    sil = torch.zeros((2, 4), dtype=torch.int32)
    u = torch.zeros((2, 10))
    with pytest.raises(ValueError):
        tocc.query_eval(coeffs.double(), valid, sil, u, u)
    with pytest.raises(ValueError):
        tocc.query_eval(coeffs, valid.int(), sil, u, u)
    with pytest.raises(ValueError):
        tocc.query_eval(coeffs, valid, sil.long(), u, u)
    with pytest.raises(ValueError):
        tocc.query_eval(coeffs, valid, sil, u, u[:, :5])
    with pytest.raises(ValueError):
        tocc.query_eval(coeffs, valid, sil, u[:1], u[:1])
    before = tocc.query_eval.launches
    inv, ids = tocc.query_eval(coeffs, valid, sil, u, u)
    assert tocc.query_eval.launches == before, "the CPU twin must not count as a launch"
    assert not inv.any() and not ids.any()


# ---------------------------------------------------------------------------------------
# The scene checks of both modalities
# ---------------------------------------------------------------------------------------


def _line_inputs(scene, scale=2):
    """Projected line centres and normals of the model's closest views (B, L)."""
    poses = _t(scene["poses"])
    points = tpipe._select_view_cl(scene["tmodel"], poses)
    z, cu, cv, nu, nv = trf.project_lines_cl(points, poses, *map(float, scene["intr4"]))
    return dict(z=z, cu=cu, cv=cv, nu=nu, nv=nv, mdo=points.modeled_depth_offset,
                fscale=float(scale))


def _region_inputs(mode, jsc, jr, geom):
    """(JAX, port) region-check and modeled-occlusion inputs from the JAX scene."""
    if mode == "query":
        size = jnp.full((2,), S, jnp.int32)
        j = (jrfn.RegionCheckQueryInputs(jsc.coeffs, jsc.tri_valid, jsc.sil_id & 255,
                                         jsc.corner_u, jsc.corner_v, jsc.scale,
                                         geom.region_id, jsc.body_visible, size),
             jrfn.ModeledOcclusionQueryInputs(jsc.coeffs, jsc.tri_valid, jsc.corner_u,
                                              jsc.corner_v, jsc.scale, jsc.body_visible,
                                              size))
        t = (trfn.RegionCheckQueryInputs(*(_t(x) for x in j[0][:-1]), S),
             trfn.ModeledOcclusionQueryInputs(*(_t(x) for x in j[1][:-1]), S))
    else:
        j = (jrfn.RegionCheckInputs(jr.region_sil, jr.corner_u, jr.corner_v, jr.scale,
                                    geom.region_id, jr.body_visible),
             jrfn.ModeledOcclusionInputs(jr.depth, jr.corner_u, jr.corner_v, jr.scale,
                                         jr.body_visible))
        t = (trfn.RegionCheckInputs(*(_t(x) for x in j[0])),
             trfn.ModeledOcclusionInputs(*(_t(x) for x in j[1])))
    return j, t


@pytest.mark.parametrize("mode", ["query", "image"])
def test_region_scene_checks_match_jax(scene, coeffs, renders, mode):
    """region_check_ok, modeled_occlusion_free and (query mode) combined_scene_checks
    against the JAX functions under vmap, on identical inputs: masks exact."""
    cfg = trfn.RegionConfig(n_lines_max=N_LINES)
    jcfg = jrfn.RegionConfig(n_lines_max=N_LINES)
    li = _line_inputs(scene)
    fu = scene["intr4"][0]
    (jrc, jmo), (trc, tmo) = _region_inputs(mode, coeffs[0], renders[0], scene["jgeom"])
    lines = [jnp.asarray(_n(li[k])) for k in ("cu", "cv", "nu", "nv", "z", "mdo")]

    want_rc = jax.vmap(lambda cu, cv, nu, nv, rc: jrfn.region_check_ok(
        jcfg, li["fscale"], cu, cv, nu, nv, rc, S))(*lines[:4], jrc)
    want_mo = jax.vmap(lambda cu, cv, z, mdo, mo: jrfn.modeled_occlusion_free(
        jcfg, cu, cv, z, mdo, fu, mo, S))(lines[0], lines[1], lines[4], lines[5], jmo)
    got_rc = trfn.region_check_ok(cfg, li["fscale"], li["cu"], li["cv"], li["nu"],
                                  li["nv"], trc, S)
    got_mo = trfn.modeled_occlusion_free(cfg, li["cu"], li["cv"], li["z"], li["mdo"],
                                         float(fu), tmo, S)
    np.testing.assert_array_equal(_n(got_rc), np.asarray(want_rc))
    np.testing.assert_array_equal(_n(got_mo), np.asarray(want_mo))
    for mask in (got_rc, got_mo):
        assert 0 < _n(mask).sum() < mask.numel(), "the scene must drop some lines"
    if mode == "query":
        for use_rc, use_mo in ((True, True), (True, False), (False, True)):
            want = jax.vmap(lambda cu, cv, nu, nv, z, mdo, rc, mo:
                            jrfn.combined_scene_checks(
                                jcfg, li["fscale"], cu, cv, nu, nv, z, mdo, fu, rc, mo)
                            )(*lines, jrc if use_rc else None, jmo if use_mo else None)
            got = trfn.combined_scene_checks(
                cfg, li["fscale"], li["cu"], li["cv"], li["nu"], li["nv"], li["z"],
                li["mdo"], float(fu), trc if use_rc else None, tmo if use_mo else None)
            for g, w in zip(got, want):
                assert (g is None) == (w is None)
                if w is not None:
                    np.testing.assert_array_equal(_n(g), np.asarray(w))


@pytest.mark.parametrize("mode,use_depth_scaling",
                         [("query", False), ("query", True), ("image", False),
                          ("image", True)])
def test_depth_scene_checks_match_jax(scene, coeffs, renders, mode, use_depth_scaling):
    """calculate_correspondences with the silhouette check and the modeled occlusions
    against the JAX one under vmap: valid exact, correspondences atol 1e-6."""
    jsc, jr = coeffs[0], renders[0]
    geom = scene["jgeom"]
    if mode == "query":
        size = jnp.full((2,), S, jnp.int32)
        jmo = jdn.DepthModeledOcclusionQueryInputs(jsc.coeffs, jsc.tri_valid, jsc.corner_u,
                                                   jsc.corner_v, jsc.scale,
                                                   jsc.body_visible, size)
        jsil = jdn.SilhouetteCheckQueryInputs(jsc.coeffs, jsc.tri_valid, jsc.sil_id >> 8,
                                              jsc.corner_u, jsc.corner_v, jsc.scale,
                                              geom.body_id, jsc.body_visible, size)
        tmo = tdn.DepthModeledOcclusionQueryInputs(*(_t(x) for x in jmo[:-1]), S)
        tsil = tdn.SilhouetteCheckQueryInputs(*(_t(x) for x in jsil[:-1]), S)
    else:
        jmo = jdn.DepthModeledOcclusionInputs(jr.depth, jr.corner_u, jr.corner_v,
                                              jr.scale, jr.body_visible)
        jsil = jdn.SilhouetteCheckInputs(jr.body_sil, jr.corner_u, jr.corner_v, jr.scale,
                                         geom.body_id, jr.body_visible)
        tmo = tdn.DepthModeledOcclusionInputs(*(_t(x) for x in jmo))
        tsil = tdn.SilhouetteCheckInputs(*(_t(x) for x in jsil))
    jcfg = jdn.DepthConfig(n_points_max=N_POINTS, use_depth_scaling=use_depth_scaling)
    tcfg = tdn.DepthConfig(n_points_max=N_POINTS, use_depth_scaling=use_depth_scaling)
    cd = 0.4 if use_depth_scaling else 0.03
    fu, fv, ppu, ppv = scene["intr4"]
    poses = _t(scene["poses"])
    view = tpipe._select_depth_view(scene["tdmodel"], poses)
    jview = jdn.DepthViewPoints(*(jnp.asarray(_n(x)) for x in view))
    results = {}
    for name, use_mo, use_sil in (("both", True, True), ("none", False, False)):
        want = jax.vmap(lambda pts, pose, img, mo, sil: jdn.calculate_correspondences(
            jcfg, cd, pts, N_POINTS, pose, img, fu, fv, ppu, ppv, W, H, DEPTH_SCALE, True,
            modeled_occlusion=mo, silhouette_check=sil))(
            jview, jnp.asarray(scene["poses"]), jnp.asarray(scene["depths"]),
            jmo if use_mo else None, jsil if use_sil else None)
        got = tdn.calculate_correspondences(
            tcfg, cd, view, N_POINTS, poses, _t(scene["depths"]), float(fu), float(fv),
            float(ppu), float(ppv), W, H, DEPTH_SCALE, torch.ones(2, dtype=torch.bool),
            modeled_occlusion=tmo if use_mo else None,
            silhouette_check=tsil if use_sil else None)
        np.testing.assert_array_equal(_n(got.valid), np.asarray(want.valid))
        np.testing.assert_allclose(_n(got.correspondence_center_f_camera),
                                   np.asarray(want.correspondence_center_f_camera),
                                   rtol=0, atol=1e-6)
        results[name] = _n(got.valid).sum(axis=1)
    assert np.all(results["both"] < results["none"]), results


# ---------------------------------------------------------------------------------------
# The cycles with a scene
# ---------------------------------------------------------------------------------------


def _pcfgs(rgbd, **kw):
    common = dict(scales=(2, 1), standard_deviations=(5.0, 1.5), n_corr_iterations=2,
                  n_update_iterations=2, region_model_occlusions=True,
                  region_checking=True, use_depth=rgbd, depth_model_occlusions=rgbd,
                  depth_silhouette_check=rgbd, **kw)
    return (jpipe.PipelineConfig(cfg=jrfn.RegionConfig(n_lines_max=N_LINES),
                                 depth_cfg=jdn.DepthConfig(n_points_max=N_POINTS),
                                 **common),
            tpipe.PipelineConfig(cfg=trfn.RegionConfig(n_lines_max=N_LINES),
                                 depth_cfg=tdn.DepthConfig(n_points_max=N_POINTS),
                                 **common))


def _start_poses(scene):
    """The rendered poses, jittered by a few millimetres."""
    poses = scene["poses"].copy()
    poses[:, :2, 3] += np.array([[0.004, -0.003], [-0.003, 0.002]], np.float32)
    return poses


def _run_port(scene, tpcfg, rgbd, n_cycles, handle=None):
    intr = scene["intr4"]
    images = _t(scene["images"])
    state = tpipe.initialize_histograms(tpcfg, intr, images, scene["tmodel"],
                                        _t(scene["poses"]))
    state = state._replace(body2camera_pose=_t(_start_poses(scene)))
    kw = dict(scene_geom=scene["tgeom"], occluder_poses=_t(scene["occluder_poses"][:, None]),
              handle_occlusions=None if handle is None else _t(handle))
    for _ in range(n_cycles):
        if rgbd:
            state = tpipe.tracking_cycle_rgbd(tpcfg, intr, intr, DEPTH_SCALE, images,
                                              _t(scene["depths"]), scene["tmodel"],
                                              scene["tdmodel"], state, **kw)
        else:
            state = tpipe.tracking_cycle(tpcfg, intr, images, scene["tmodel"], state, **kw)
    return state


def _run_jax(scene, jpcfg, rgbd, n_cycles, handle=None):
    intr = scene["intr4"]
    images = jnp.asarray(scene["images"])
    state = jpipe.initialize_histograms(jpcfg, intr, images, scene["jmodel"],
                                        jnp.asarray(scene["poses"]))
    state = state._replace(body2camera_pose=jnp.asarray(_start_poses(scene)))
    kw = dict(scene_geom=scene["jgeom"],
              occluder_poses=jnp.asarray(scene["occluder_poses"][:, None]),
              handle_occlusions=None if handle is None else jnp.asarray(handle))
    for _ in range(n_cycles):
        if rgbd:
            state = jpipe.tracking_cycle_rgbd(jpcfg, intr, intr, jnp.float32(DEPTH_SCALE),
                                              images, jnp.asarray(scene["depths"]),
                                              scene["jmodel"], scene["jdmodel"], state, **kw)
        else:
            state = jpipe.tracking_cycle(jpcfg, intr, images, scene["jmodel"], state, **kw)
    return state


def _assert_states_close(t_state, j_state, atol=1e-4):
    for name in ("body2camera_pose", "histogram_f", "histogram_b"):
        np.testing.assert_allclose(_n(getattr(t_state, name)),
                                   np.asarray(getattr(j_state, name)), rtol=0, atol=atol,
                                   err_msg=name)


def test_region_cycle_with_scene_matches_jax(scene):
    """tracking_cycle with modeled occlusions and region checking, 2 cycles."""
    jpcfg, tpcfg = _pcfgs(False)
    t_state = _run_port(scene, tpcfg, False, 2)
    _assert_states_close(t_state, _run_jax(scene, jpcfg, False, 2))
    err = np.linalg.norm(_n(t_state.body2camera_pose)[:, :3, 3] - scene["poses"][:, :3, 3],
                         axis=1)
    assert np.all(err < 0.005), err


@pytest.mark.parametrize("handle", [(True, True), (False, True)])
def test_rgbd_cycle_with_scene_matches_jax(scene, handle):
    """tracking_cycle_rgbd with all four scene flags; handle_occlusions False switches
    the occlusion masks off for body 0."""
    jpcfg, tpcfg = _pcfgs(True)
    handle = np.array(handle)
    t_state = _run_port(scene, tpcfg, True, 2, handle)
    _assert_states_close(t_state, _run_jax(scene, jpcfg, True, 2, handle))


@pytest.mark.parametrize("rgbd", [False, True])
def test_cycle_query_mode_equals_image_mode(scene, rgbd):
    """The port's cycle with occlusion_queries on and off gives the same state (atol
    1e-6, as tests/test_occlusion_queries.py::test_cycle_query_mode_equals_image_mode)."""
    _, tpcfg = _pcfgs(rgbd)
    st_q = _run_port(scene, tpcfg._replace(occlusion_queries=True), rgbd, 1)
    st_i = _run_port(scene, tpcfg._replace(occlusion_queries=False), rgbd, 1)
    _assert_states_close(st_q, st_i, atol=1e-6)


def test_scene_constructors_default_to_the_card(scene):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    arrays = {k: np.asarray(v) for k, v in scene["jgeom"]._asdict().items()}
    with pytest.raises(RuntimeError, match="cuda"):
        tocc.SceneGeometry.from_numpy(arrays)
    with pytest.raises(RuntimeError, match="cuda"):
        tocc.build_scene_geometry([[scene_body(scene["tracked"])]])
    _assert_geometry_equal(tocc.SceneGeometry.from_numpy(arrays, device="cpu"),
                           scene["jgeom"])
    one = tocc.build_scene_geometry([[scene_body(scene["tracked"])]], device="cpu")
    assert one.expand(5).triangles.shape == (5,) + one.triangles.shape[1:]
