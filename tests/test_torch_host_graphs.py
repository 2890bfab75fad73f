"""The host path's six graphed functions, the port's counterparts of the JAX package's
jits there: m3t_tpu_torch/region_modality.py's ``_correspondences_jit``,
``_gradient_hessian_jit`` and ``_add_colors_jit``, depth_modality.py's
``_correspondences_jit`` and ``_gradient_hessian_jit``, and ops/raster.py's
``rasterize``, each called as its modality calls it (a batch of one body; ``rasterize``
on one scene, as the fused cycles' image mode calls it).

Inputs (no JAX needed to make them): one sphere 0.6 m in front of a 160x120 camera with
the committed bench sphere models' closest view (100 lines and points), a rendered noisy
colour frame, a depth frame with a wall 0.45 m away left of u = 75, histograms of the
frame, and focused 200x200 scene images at scale 2 around the sphere: a region-id
silhouette (region 3 on the sphere's disk, a foreign region 5 over its right side) and
a depth image that puts a patch 0.5 m away over the disk's lower half.  The scene
images serve as the modeled-occlusion and region- or silhouette-check inputs; every
optional input is present.

On the CPU: each function against the JAX package's jitted one on the same inputs, to
the tolerances of tests/test_torch_region_host.py and tests/test_torch_depth.py (masks,
histogram counts and ids exact; line values within 1e-4, depth correspondences within
1e-6; gradients and Hessians within 1e-5 of their largest entry; depths within a
relative 1e-5); two line counts, point counts and ``handle_occlusions`` values give one
static key; and the host-read lint (tests/torch_host_reads.py) passes over each
function.  The JAX side is imported inside the tests that need it, which skip where a
card is present (its machine runs the port alone).

The tests marked ``cuda`` need a card and skip without one: graph = eager bit for bit
for each function over three calls on two inputs, fresh outputs, and the graphed
``rasterize`` equal to the windowed eager one.  The machine with the card has no JAX, so
run them there as

    python -m pytest --noconftest -q tests/test_torch_host_graphs.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from m3t_tpu_torch import depth_modality, graphs, region_modality
from m3t_tpu_torch.ops import depth_fn as tdn
from m3t_tpu_torch.ops import histogram as thist
from m3t_tpu_torch.ops import raster as traster
from m3t_tpu_torch.ops import region_fn as trfn
from m3t_tpu_torch.utils import procedural

import torch_host_reads  # tests/torch_host_reads.py: pytest puts tests/ on sys.path

DATA = Path(region_modality.__file__).parent / "data"
WIDTH, HEIGHT = 160, 120
INTRIN = (160.0, 160.0, 79.5, 59.5)  # fu, fv, ppu, ppv: float32 values
N_LINES, N_POINTS, N_BINS, DEPTH_SCALE = 100, 100, 16, 0.001
FOCUSED, FOCUSED_SCALE, RADIUS = 200, 2.0, 0.06
REGION_CFG = trfn.RegionConfig(n_lines_max=N_LINES, n_histogram_bins=N_BINS,
                               min_n_unoccluded_lines=5)
DEPTH_CFG = tdn.DepthConfig(n_points_max=N_POINTS, min_n_unoccluded_points=5)
SCALE, STD, CONSIDERED, DEPTH_STD = 2, 3.5, 0.02, 0.03
FUNCTIONS = ("region_correspondences", "region_gradient_hessian", "add_colors",
             "depth_correspondences", "depth_gradient_hessian", "rasterize")


def _pose(shift=(0.0, 0.0, 0.0)):
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = np.float32([0.004, -0.003, 0.6]) + np.float32(shift)
    return pose


def _view(orientations, pose) -> int:
    """GetClosestViewIndex (region_model.cpp:105-127)."""
    t = pose[:3, 3]
    return int(np.argmax(orientations @ (pose[:3, :3].T @ (t / np.linalg.norm(t)))))


def scene(shift=(0.0, 0.0, 0.0), seed: int = 4) -> dict:
    """Numpy arrays of the inputs (module docstring) at the sphere moved by shift."""
    pose = _pose(shift)
    sphere = procedural.sphere_triangles(RADIUS, 2)
    tri = (sphere @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    depth, ids = traster.rasterize_np(tri, np.ones(len(tri), np.int32), *INTRIN, WIDTH,
                                      HEIGHT, cull_backfaces=True)
    rng = np.random.default_rng(seed)
    frame = np.empty((HEIGHT, WIDTH, 3), np.float32)
    frame[:] = (40, 120, 190)
    frame[ids == 1] = (200, 60, 50)
    frame = np.clip(np.rint(frame + rng.integers(-8, 9, frame.shape)), 0, 255).astype(np.uint8)
    depth_image = np.round(np.where(np.isfinite(depth), depth, 2.0) / DEPTH_SCALE
                           ).astype(np.uint16)
    depth_image[:, :75] = 450
    out = dict(pose=pose, frame=frame, depth=depth_image)
    with np.load(DATA / "bench_sphere_region_model.npz") as f:
        v = _view(f["orientations"], pose)
        out["region_points"] = [f["centers"][v, :N_LINES], f["normals"][v, :N_LINES],
                                f["foreground_distances"][v, :N_LINES],
                                f["background_distances"][v, :N_LINES],
                                f["depth_offsets"][v, :N_LINES, 5],
                                f["depth_offsets"][v, :N_LINES, 5]]
    with np.load(DATA / "bench_sphere_depth_model.npz") as f:
        v = _view(f["orientations"], pose)
        out["depth_points"] = [f["centers"][v, :N_POINTS], f["normals"][v, :N_POINTS],
                               f["depth_offsets"][v, :N_POINTS, 5],
                               f["depth_offsets"][v, :N_POINTS, 5]]
    # The focused crop: corner 50 px up and left of the projected centre, at scale 2.
    fu, fv, ppu, ppv = INTRIN
    cu = fu * pose[0, 3] / pose[2, 3] + ppu
    cv = fv * pose[1, 3] / pose[2, 3] + ppv
    out["corner"] = (np.float32(cu - 50.0), np.float32(cv - 50.0))
    yy, xx = np.mgrid[:FOCUSED, :FOCUSED]
    u = out["corner"][0] + (xx + 0.5) / FOCUSED_SCALE
    v = out["corner"][1] + (yy + 0.5) / FOCUSED_SCALE
    r2 = ((u - cu) ** 2 + (v - cv) ** 2) / (fu * RADIUS / pose[2, 3]) ** 2
    disk = r2 < 1.0
    sil = np.where(disk, 3, 0).astype(np.int32)
    sil[(u > cu + 8) & (np.abs(v - cv) < 10)] = 5
    surface = pose[2, 3] - RADIUS * np.sqrt(np.clip(1.0 - r2, 0.0, 1.0))
    focused_depth = np.where(disk, surface, np.inf).astype(np.float32)
    focused_depth[disk & (v > cv + 6)] = 0.5
    out.update(sil=sil, focused_depth=focused_depth)
    return out


def _histograms(arrays) -> list:
    """Foreground and background histograms of the frame along the lines at the pose."""
    t = {k: torch.as_tensor(arrays[k]) for k in ("pose", "frame")}
    points = trfn.ViewPoints(*(torch.as_tensor(a)[None] for a in arrays["region_points"]))
    n = N_BINS ** 3
    memories = trfn.add_line_pixel_colors(
        REGION_CFG, points, N_LINES, t["pose"][None], t["frame"][None], torch.zeros(1, n),
        torch.zeros(1, n), *INTRIN, WIDTH, HEIGHT, False)
    uniform = torch.full((n,), 1.0 / n)
    return [thist.calculate_histogram(uniform, m[0], 1.0).numpy() for m in memories]


def calls(arrays, device, n_lines=N_LINES, handle=True, lines=None, points=None) -> dict:
    """name -> (graphed function, args) as the modalities call them (and rasterize on
    one scene), on device, every optional input present.  ``lines`` (region DataLines fields) and
    ``points`` (depth DepthDataPoints fields) feed the gradient functions; by default
    the eager port's own correspondences."""
    def t(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)[None]
        return torch.as_tensor(np.array(a), device=device)[None]

    pose = t(arrays["pose"])
    corner = [t(np.float32(c)) for c in arrays["corner"]]
    scale, visible = t(np.float32(FOCUSED_SCALE)), t(True)
    hist = arrays.get("hist") or _histograms(arrays)
    measured = trfn.MeasuredOcclusionInputs(
        depth_image=t(arrays["depth"]), body2depth_camera_pose=pose, fu=INTRIN[0],
        fv=INTRIN[1], ppu=INTRIN[2], ppv=INTRIN[3], depth_scale=float(np.float32(DEPTH_SCALE)))
    modeled = trfn.ModeledOcclusionInputs(t(arrays["focused_depth"]), *corner, scale, visible)
    region_check = trfn.RegionCheckInputs(t(arrays["sil"]), *corner, scale,
                                          t(np.int32(3)), visible)
    depth_modeled = tdn.DepthModeledOcclusionInputs(t(arrays["focused_depth"]), *corner,
                                                    scale, visible)
    silhouette = tdn.SilhouetteCheckInputs(t(arrays["sil"]), *corner, scale, t(np.int32(3)),
                                           visible)
    region_points = trfn.ViewPoints(*(t(a) for a in arrays["region_points"]))
    depth_points = tdn.DepthViewPoints(*(t(a) for a in arrays["depth_points"]))
    lookup_f, lookup_b = (torch.as_tensor(a, device=device)
                          for a in REGION_CFG.function_lookups())
    n_lines_t = torch.tensor([n_lines], dtype=torch.int32, device=device)
    handle_t = torch.tensor([handle], device=device)
    out = {
        "region_correspondences": (region_modality._correspondences_jit, (
            REGION_CFG, SCALE, WIDTH, HEIGHT, region_points, n_lines_t, pose,
            t(arrays["frame"]), t(hist[0]), t(hist[1]), INTRIN, handle_t, measured,
            modeled, region_check, lookup_f, lookup_b)),
        "add_colors": (region_modality._add_colors_jit, (
            REGION_CFG, WIDTH, HEIGHT, region_points, n_lines_t, pose, t(arrays["frame"]),
            t(arrays["memory"][0]), t(arrays["memory"][1]), INTRIN, handle_t, measured,
            modeled, region_check)),
        "depth_correspondences": (depth_modality._correspondences_jit, (
            DEPTH_CFG, CONSIDERED, WIDTH, HEIGHT, True, depth_points,
            torch.tensor([min(n_lines, N_POINTS)], dtype=torch.int32, device=device), pose,
            t(arrays["depth"]), INTRIN, float(np.float32(DEPTH_SCALE)), handle_t,
            depth_modeled, silhouette)),
    }
    with graphs.disable_graphs():
        if lines is None:
            found = out["region_correspondences"][0](*out["region_correspondences"][1])
            lines = [a[0] for a in found]
        if points is None:
            found = out["depth_correspondences"][0](*out["depth_correspondences"][1])
            points = [a[0] for a in found]
    moved = t(_pose((0.001, -0.0005, 0.002)))
    out["region_gradient_hessian"] = (region_modality._gradient_hessian_jit, (
        REGION_CFG, STD, True, trfn.DataLines(*(t(a) for a in lines)), moved, INTRIN))
    out["depth_gradient_hessian"] = (depth_modality._gradient_hessian_jit, (
        DEPTH_STD, tdn.DepthDataPoints(*(t(a) for a in points)), moved))
    out["rasterize"] = (traster.rasterize, (_soup(arrays, device), WIDTH, HEIGHT, 64, True))
    return out


def _scene_triangles(arrays):
    """The sphere at the pose and a cube in front of its left half, camera frame: (T, 3,
    3) float32 vertices, ids (sphere 1, cube 2), cull flags."""
    pose = arrays["pose"]
    sphere = procedural.sphere_triangles(RADIUS, 2) @ pose[:3, :3].T + pose[:3, 3]
    cube_v, cube_t = procedural.cube(0.02)
    cube = cube_v[cube_t] + np.float32([-0.03, 0.0, 0.5])
    tri = np.concatenate([sphere, cube]).astype(np.float32)
    ids = np.repeat(np.int32([1, 2]), [len(sphere), len(cube)])
    return tri, ids, np.ones(len(tri), bool)


def _soup(arrays, device):
    tri, ids, culls = (torch.as_tensor(a, device=device)[None]
                       for a in _scene_triangles(arrays))
    return traster.triangle_coefficients(tri, ids, *INTRIN, cull_backfaces=culls, z_min=0.02)


@pytest.fixture(scope="module")
def arrays():
    out = scene()
    out["hist"] = _histograms(out)
    rng = np.random.default_rng(8)
    out["memory"] = rng.integers(0, 3, (2, N_BINS ** 3)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def cpu_calls(arrays):
    return calls(arrays, torch.device("cpu"))


# ---------------------------------------------------------------------------------------
# On the CPU, against the JAX package
# ---------------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_side(arrays):
    """The JAX package's jitted functions and their inputs (the same arrays), on the
    CPU machine: the card's machine runs the port alone."""
    if torch.cuda.is_available():
        pytest.skip("the JAX reference runs on the CPU machine, not beside the card")
    jnp = pytest.importorskip("jax.numpy")
    from m3t_tpu import depth_modality as jdepth_modality
    from m3t_tpu import region_modality as jregion_modality
    from m3t_tpu.ops import depth_fn as jdn
    from m3t_tpu.ops import raster as jraster
    from m3t_tpu.ops import region_fn as jrfn

    a = arrays
    f32 = tuple(np.float32(x) for x in INTRIN)
    corner = tuple(np.float32(c) for c in a["corner"])
    scale, visible = np.float32(FOCUSED_SCALE), jnp.asarray(True)
    measured = jrfn.MeasuredOcclusionInputs(
        depth_image=jnp.asarray(a["depth"]), body2depth_camera_pose=jnp.asarray(a["pose"]),
        fu=f32[0], fv=f32[1], ppu=f32[2], ppv=f32[3], depth_scale=np.float32(DEPTH_SCALE))
    modeled = jrfn.ModeledOcclusionInputs(jnp.asarray(a["focused_depth"]), *corner, scale,
                                          visible)
    region_check = jrfn.RegionCheckInputs(jnp.asarray(a["sil"]), *corner, scale,
                                          np.int32(3), visible)
    return dict(
        jnp=jnp, jregion_modality=jregion_modality, jdepth_modality=jdepth_modality,
        jdn=jdn, jraster=jraster, jrfn=jrfn, f32=f32, measured=measured, modeled=modeled,
        region_check=region_check,
        region_points=jrfn.ViewPoints(*(jnp.asarray(x) for x in a["region_points"])),
        depth_points=jdn.DepthViewPoints(*(jnp.asarray(x) for x in a["depth_points"])),
        depth_modeled=jdn.DepthModeledOcclusionInputs(jnp.asarray(a["focused_depth"]),
                                                      *corner, scale, visible),
        silhouette=jdn.SilhouetteCheckInputs(jnp.asarray(a["sil"]), *corner, scale,
                                             np.int32(3), visible))


def _jax_lines(j, arrays, handle=True):
    cfg = j["jrfn"].RegionConfig(**REGION_CFG._asdict())
    return j["jregion_modality"]._correspondences_jit(
        cfg, SCALE, WIDTH, HEIGHT, True, True, True, j["region_points"],
        j["jnp"].int32(N_LINES), j["jnp"].asarray(arrays["pose"]),
        j["jnp"].asarray(arrays["frame"]), *arrays["hist"], j["f32"],
        j["jnp"].asarray(handle), j["measured"], j["modeled"], j["region_check"],
        *cfg.function_lookups())


def _jax_points(j, arrays, handle=True):
    cfg = j["jdn"].DepthConfig(**DEPTH_CFG._asdict())
    return j["jdepth_modality"]._correspondences_jit(
        cfg, CONSIDERED, WIDTH, HEIGHT, True, True, True, j["depth_points"],
        j["jnp"].int32(N_POINTS), j["jnp"].asarray(arrays["pose"]),
        j["jnp"].asarray(arrays["depth"]), j["f32"], np.float32(DEPTH_SCALE),
        j["jnp"].asarray(handle), j["depth_modeled"], j["silhouette"])


@pytest.mark.parametrize("handle", [True, False])
def test_region_correspondences_match_jax(arrays, jax_side, handle):
    fn, args = calls(arrays, torch.device("cpu"), handle=handle)["region_correspondences"]
    got, want = fn(*args), _jax_lines(jax_side, arrays, handle)
    for name in trfn.DataLines._fields:
        g, w = getattr(got, name)[0].numpy(), np.asarray(getattr(want, name))
        if name == "valid":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
    # Every check takes lines away, and enough stay.
    assert 10 < got.valid.sum() < N_LINES - 10


@pytest.mark.parametrize("global_it", [True, False])
def test_region_gradient_hessian_matches_jax(arrays, jax_side, global_it):
    j = jax_side
    lines = _jax_lines(j, arrays)
    fn, args = calls(arrays, torch.device("cpu"),
                     lines=[np.asarray(x) for x in lines])["region_gradient_hessian"]
    args = args[:2] + (global_it,) + args[3:]
    got = fn(*args)
    want = j["jregion_modality"]._gradient_hessian_jit(
        j["jrfn"].RegionConfig(**REGION_CFG._asdict()), STD, global_it, lines,
        j["jnp"].asarray(args[4][0].numpy()), j["f32"])
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g[0].numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("handle", [True, False])
def test_add_colors_matches_jax(arrays, jax_side, cpu_calls, handle):
    j = jax_side
    fn, args = cpu_calls["add_colors"]
    args = args[:10] + (torch.tensor([handle]),) + args[11:]
    got = fn(*args)
    want = j["jregion_modality"]._add_colors_jit(
        j["jrfn"].RegionConfig(**REGION_CFG._asdict()), WIDTH, HEIGHT, True, True, True,
        j["region_points"], j["jnp"].int32(N_LINES), j["jnp"].asarray(arrays["pose"]),
        j["jnp"].asarray(arrays["frame"]), *(j["jnp"].asarray(m) for m in arrays["memory"]),
        j["f32"], j["jnp"].asarray(handle), j["measured"], j["modeled"], j["region_check"])
    for g, w, start in zip(got, want, arrays["memory"]):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
        assert g.sum() - start.sum() > 100


@pytest.mark.parametrize("handle", [True, False])
def test_depth_correspondences_match_jax(arrays, jax_side, handle):
    fn, args = calls(arrays, torch.device("cpu"), handle=handle)["depth_correspondences"]
    got, want = fn(*args), _jax_points(jax_side, arrays, handle)
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.correspondence_center_f_camera[0].numpy(),
                               np.asarray(want.correspondence_center_f_camera), rtol=0,
                               atol=1e-6)
    assert 10 < got.valid.sum() < N_POINTS - 10


def test_depth_gradient_hessian_matches_jax(arrays, jax_side):
    j = jax_side
    points = _jax_points(j, arrays)
    fn, args = calls(arrays, torch.device("cpu"),
                     points=[np.asarray(x) for x in points])["depth_gradient_hessian"]
    got = fn(*args)
    want = j["jdepth_modality"]._gradient_hessian_jit(DEPTH_STD, points,
                                                       j["jnp"].asarray(args[2][0].numpy()))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g[0].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("with_normals", [True, False])
def test_rasterize_matches_jax(arrays, jax_side, with_normals):
    j = jax_side
    tri, ids, culls = _scene_triangles(arrays)
    want = j["jraster"].rasterize(
        j["jraster"].triangle_coefficients(j["jnp"].asarray(tri), j["jnp"].asarray(ids),
                                           *INTRIN, cull_backfaces=j["jnp"].asarray(culls),
                                           z_min=0.02),
        WIDTH, HEIGHT, chunk=64, with_normals=with_normals)
    got = traster.rasterize(_soup(arrays, torch.device("cpu")), WIDTH, HEIGHT, chunk=64,
                            with_normals=with_normals)
    assert len(tri) > 3 * 64
    gd, wd = got[0][0].numpy(), np.asarray(want[0])
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    finite = np.isfinite(wd)
    np.testing.assert_allclose(gd[finite], wd[finite], rtol=1e-5)
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    assert set(np.unique(np.asarray(want[1]))) == {0, 1, 2}
    if with_normals:
        np.testing.assert_allclose(got[2][0].numpy(), np.asarray(want[2]), rtol=0,
                                   atol=1e-6)


# ---------------------------------------------------------------------------------------
# On the CPU, the port alone
# ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["region_correspondences", "add_colors",
                                  "depth_correspondences"])
def test_line_counts_and_handle_occlusions_share_a_key(arrays, cpu_calls, name):
    """The line (point) count and handle_occlusions are (1,) tensors, inputs of the
    graph as JAX traces them: two values of each give one static key."""
    fn, args = cpu_calls[name]
    other = calls(arrays, torch.device("cpu"), n_lines=60, handle=False)[name][1]
    assert graphs.static_key(fn, *args) == graphs.static_key(fn, *other)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_functions_read_nothing_back_on_the_host(cpu_calls, name, monkeypatch):
    """No operation of the function reads a value back on the host or builds a tensor
    on the device from host data, which a CUDA graph's capture refuses; every optional
    input present."""
    fn, args = cpu_calls[name]
    torch_host_reads.assert_reads_nothing_back(fn, args, {}, monkeypatch)


# ---------------------------------------------------------------------------------------
# On the card (marker "cuda")
# ---------------------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    graphs.clear_graphs()
    yield torch.device("cuda")
    graphs.clear_graphs()


def _two_inputs(device):
    """The calls at the module's scene, and at the sphere moved by 2 mm with 60 lines
    and handle_occlusions off, their gradient inputs the eager port's own."""
    first = scene()
    first["memory"] = np.random.default_rng(8).integers(0, 3, (2, N_BINS ** 3)).astype(
        np.float32)
    second = scene((0.002, 0.001, 0.0), seed=5)
    second["hist"], second["memory"] = _histograms(first), first["memory"] + 1.0
    return calls(first, device), calls(second, device, n_lines=60, handle=False)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONS)
def test_graph_equals_eager_on_card(card, name):
    """Three graphed calls (the capture, then replays on the other input and on the
    first again) equal the eager calls bit for bit, on one graph."""
    first, second = (c[name] for c in _two_inputs(card))
    fn = first[0]
    with graphs.disable_graphs():
        eager = [fn(*args) for _, args in (first, second, first)]
    graphed = [fn(*args) for _, args in (first, second, first)]
    for want, got in zip(eager, graphed):
        assert _equal(want, got)
    assert not _equal(eager[0], eager[1])
    (info,) = graphs.captured()
    assert info.replays == 2 and info.launches == {}


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUNCTIONS)
def test_graph_outputs_are_fresh(card, name):
    """A later call leaves an earlier call's outputs as they were."""
    first, second = (c[name] for c in _two_inputs(card))
    fn = first[0]
    kept = [a.clone() for a in fn(*first[1])]
    one = fn(*first[1])
    fn(*second[1])
    assert _equal(one, kept)


@pytest.mark.cuda
def test_graphed_rasterize_equals_windowed_eager(card):
    """The graphed whole-image rasterize gives the images of the eager windowed one
    (each chunk over its chunk_windows window), the renderers' form."""
    arrays = scene()
    soup = _soup(arrays, card)
    windows = traster.chunk_windows(soup, WIDTH, HEIGHT, 64)
    assert any(w is not None and w != (0, WIDTH, 0, HEIGHT) for w in windows)
    want = traster.rasterize_windows(soup, WIDTH, HEIGHT, windows, chunk=64,
                                     with_normals=True)
    for _ in range(2):
        assert _equal(traster.rasterize(soup, WIDTH, HEIGHT, chunk=64, with_normals=True),
                      want)
    assert graphs.captured()[0].replays == 1
