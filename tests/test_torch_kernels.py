"""The port's Hopper kernels against their plain PyTorch twins, with no JAX anywhere.

The tests marked ``cuda`` need a card and skip without one.  The machine with the card
has no JAX, so run them there without the JAX test configuration:

    python -m pytest --noconftest -q tests/test_torch_kernels.py

The unmarked tests check the CPU twins and the wrappers' argument checks.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_query_scenes as qs  # tests/torch_query_scenes.py: pytest puts tests/ on sys.path
from m3t_tpu_torch import graphs, pipeline
from m3t_tpu_torch.common import Intrinsics
from m3t_tpu_torch.ops import _cuda
from m3t_tpu_torch.ops import depth_fast as df
from m3t_tpu_torch.ops import kinematics, newton
from m3t_tpu_torch.ops import occlusion as oc
from m3t_tpu_torch.ops import raster
from m3t_tpu_torch.ops import region_fast as rf
from m3t_tpu_torch.ops.region_fn import RegionConfig
from m3t_tpu_torch.ops.texture_fn import TexturePoints
from m3t_tpu_torch.utils import procedural

NPZ = Path(pipeline.__file__).parent / "data" / "bench_sphere_region_model.npz"
DEPTH_NPZ = Path(pipeline.__file__).parent / "data" / "bench_sphere_depth_model.npz"
KIN_NPZ = Path(pipeline.__file__).parent / "data" / "bench_kinematic_model.npz"


def _scene(device, n_bodies=4, n_bins=16):
    """A 320x240 view of the committed sphere model at jittered poses, on `device`."""
    pcfg = pipeline.PipelineConfig(cfg=RegionConfig(n_lines_max=200, n_histogram_bins=n_bins))
    intr_t = Intrinsics(300.0, 300.0, 159.5, 119.5, 320, 240)
    intr = (intr_t.fu, intr_t.fv, intr_t.ppu, intr_t.ppv)
    rng = np.random.default_rng(11)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.5
    frame = procedural.render_synthetic_color_frame(
        procedural.sphere_triangles(0.06, 2), intr_t, pose0, noise_rng=rng)
    poses = np.tile(pose0, (n_bodies, 1, 1))
    poses[:, :2, 3] += rng.uniform(-0.01, 0.01, (n_bodies, 2)).astype(np.float32)
    model = pipeline.RegionModelArrays.from_npz(str(NPZ), 200, device=device)
    images = torch.as_tensor(frame, device=device).expand((n_bodies,) + frame.shape)
    return pcfg, intr, model.expand(n_bodies), images, torch.as_tensor(poses, device=device)


def _depth_scene(device, n_bodies=4):
    """The region scene plus its depth frame (0.3 m wall over the left third) and the
    committed depth model: (pcfg, intr, model, images, poses, depth_model, depth)."""
    pcfg, intr, model, images, poses = _scene(device, n_bodies)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.5
    depth = procedural.render_synthetic_depth_frame(
        procedural.sphere_triangles(0.06, 2),
        Intrinsics(*intr, images.shape[2], images.shape[1]), pose0)
    depth[:, :140] = 300
    depth_model = pipeline.DepthModelArrays.from_npz(str(DEPTH_NPZ), 200, device=device)
    depth_images = torch.as_tensor(depth, device=device).expand((n_bodies,) + depth.shape)
    pcfg = pcfg._replace(use_depth=True, region_measure_occlusions=True,
                         depth_measure_occlusions=True)
    return pcfg, intr, model, images, poses, depth_model.expand(n_bodies), depth_images


def _occluded_scene(device, n_bodies=4):
    """The depth scene plus a 3 cm cube occluder 0.35 m from the camera, in front of
    the sphere's left side, as a scene geometry with every scene check on:
    (pcfg, intr, model, images, poses, depth_model, depth, geom, occluder_poses)."""
    pcfg, intr, model, images, poses, depth_model, depth = _depth_scene(device, n_bodies)
    pcfg = pcfg._replace(region_model_occlusions=True, region_checking=True,
                         depth_model_occlusions=True, depth_silhouette_check=True,
                         region_measure_occlusions=False, depth_measure_occlusions=False,
                         focused_image_size=128)
    sphere = oc.SceneBody(*procedural.icosphere(2, 0.06), body_id=1, region_id=1)
    cube = oc.SceneBody(*procedural.cube(0.03), body_id=2, region_id=2)
    geom = oc.build_scene_geometry([[sphere, cube]], device=device).expand(n_bodies)
    occluder = np.eye(4, dtype=np.float32)
    occluder[:3, 3] = [-0.04, 0.0, 0.35]
    occluder_poses = torch.as_tensor(occluder, device=device).expand(n_bodies, 1, 4, 4)
    return pcfg, intr, model, images, poses, depth_model, depth, geom, occluder_poses


def _query_inputs(device, n_tri=None, n_bodies=4, n_query=3000):
    """(coeffs, tri_valid, sil_id, u, v): the occluded scene's focused coefficients at
    integer pixels in and around the 128-pixel crop, or (n_tri given) random
    camera-frame triangles with a random validity mask, which exceeds one shared-memory
    tile of the kernel when n_tri > 512."""
    rng = np.random.default_rng(5 if n_tri is None else n_tri)
    if n_tri is None:
        pcfg, intr, _, _, poses, _, _, geom, occluder_poses = _occluded_scene(device,
                                                                               n_bodies)
        sc = oc.focused_scene_coeffs(geom, torch.cat([poses[:, None], occluder_poses], 1),
                                     intr, 320, 240, pcfg.focused_image_size)
        coeffs, valid, sil = sc.coeffs, sc.tri_valid, sc.sil_id
    else:
        tri = np.empty((n_bodies, n_tri, 3, 3), np.float32)
        tri[..., :2] = rng.uniform(-0.1, 0.1, (n_bodies, n_tri, 3, 2))
        tri[..., 2] = rng.uniform(0.4, 0.8, (n_bodies, n_tri, 3))
        ids = rng.integers(1, 1 << 16, (n_bodies, n_tri)).astype(np.int32)
        soup = raster.triangle_coefficients(torch.as_tensor(tri, device=device),
                                            torch.as_tensor(ids, device=device),
                                            300.0, 300.0, 63.5, 63.5)
        coeffs, sil = soup.coeffs, soup.ids
        valid = soup.valid & torch.as_tensor(rng.random((n_bodies, n_tri)) > 0.2,
                                             device=device)
    u = torch.as_tensor(rng.integers(-8, 136, (n_bodies, n_query)), device=device)
    v = torch.as_tensor(rng.integers(-8, 136, (n_bodies, n_query)), device=device)
    return coeffs, valid, sil, u.to(torch.int32), v.to(torch.int32)


def _scene_inputs(device, n_scenes, n_tri, cull="mixed", seed=0, expanded=False):
    """scene_coeffs arguments on random scenes of n_tri triangles and three bodies:
    scene 0 lists no triangle, scene 1 every triangle, in front of the camera and
    unculled (all valid); in the others some triangles are culled, some unlisted, and
    the third body sits across z_min (triangles wholly and partly behind it).
    ``expanded``: scene 0's triangles, ids and flags broadcast over the batch (a scene
    stride of 0) and every scene listing its triangles."""
    rng = np.random.default_rng(seed)
    tri = rng.uniform(-0.05, 0.05, (n_scenes, n_tri, 3, 3)).astype(np.float32)
    owner = rng.integers(0, 3, (n_scenes, n_tri)).astype(np.int32)
    sil = rng.integers(1, 1 << 16, (n_scenes, n_tri)).astype(np.int32)
    listed = rng.random((n_scenes, n_tri)) > 0.15
    culled = {"mixed": rng.random((n_scenes, n_tri)) > 0.5,
              "off": np.zeros((n_scenes, n_tri), bool)}[cull]
    poses = np.tile(np.eye(4, dtype=np.float32), (n_scenes, 3, 1, 1))
    for k in range(3):
        angles = rng.uniform(-np.pi, np.pi, (n_scenes, 3))
        for axis in range(3):
            c, s = np.cos(angles[:, axis]), np.sin(angles[:, axis])
            turn = np.tile(np.eye(3), (n_scenes, 1, 1))
            i, j = [a for a in range(3) if a != axis]
            turn[:, i, i], turn[:, i, j], turn[:, j, i], turn[:, j, j] = c, -s, s, c
            poses[:, k, :3, :3] = (turn @ poses[:, k, :3, :3]).astype(np.float32)
    poses[:, :, :2, 3] = rng.uniform(-0.05, 0.05, (n_scenes, 3, 2))
    poses[:, :2, 2, 3] = rng.uniform(0.3, 0.8, (n_scenes, 2))
    poses[:, 2, 2, 3] = 0.02 + rng.uniform(-0.03, 0.03, n_scenes)  # across z_min
    listed[0] = False
    if n_scenes > 1:
        owner[1] %= 2
        listed[1], culled[1] = True, False
    if expanded:
        listed[:] = True
    focal = rng.uniform(250.0, 350.0, (2, n_scenes)).astype(np.float32)
    centre = rng.uniform(40.0, 80.0, (2, n_scenes)).astype(np.float32)

    def t(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    args = [t(tri), t(owner), t(sil), t(listed), t(culled), t(poses), *map(t, focal),
            *map(t, centre), 0.02]
    if expanded:
        for i in range(5):
            args[i] = args[i][:1].expand(args[i].shape)
    return args


def _window_inputs(device, considered_distance):
    """sample_windows arguments (image, u_min, v_min, stride, corner_u, corner_v,
    crop_size, k) of the correspondence windows (considered_distance > 0) or of the
    depth measured-occlusion windows (considered_distance None) on the depth scene's
    frame (an expanded view of one frame)."""
    pcfg, intr, _, _, poses, depth_model, depth = _depth_scene(device)
    cu, cv = df.depth_corners(depth, poses, *intr, pcfg.crop_size)
    centers = pipeline._select_depth_view(depth_model, poses).center_f_body
    if considered_distance is None:
        u_min, v_min, _, _, stride = df.occlusion_windows(
            pcfg.depth_cfg.measured_occlusion_radius, False, centers, poses, *intr,
            depth.shape[2], depth.shape[1])
        k = df.KMAX_N_OCCLUSION_STRIDES + 1
    else:
        u_min, v_min, stride, k = df.correspondence_windows(
            pcfg.depth_cfg, considered_distance, centers, poses, *intr)
    return depth, u_min, v_min, stride, cu, cv, pcfg.crop_size, k


def _kernel_inputs(device, scale, n_bins=16):
    pcfg, intr, model, images, poses = _scene(device, n_bins=n_bins)
    state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
    bin_crop, cu, cv = pipeline._prepare_crops(pcfg, intr, images, poses)
    points = pipeline._select_view_cl(model, poses)
    geo = rf.line_geometry(pcfg.cfg, scale, points, 200, poses, *intr, 320, 240, cu, cv,
                           pcfg.crop_size, pcfg.lp)
    walk_params, walk_mask = rf.histogram_walk_geometry(
        pcfg.cfg, points, 200, poses, *intr, 320, 240, cu, cv, pcfg.crop_size, 2 * pcfg.lp)
    rtab = rf.ratio_table(state.histogram_f, state.histogram_b)
    kp = rf.round_up(pcfg.cfg.line_length_in_segments * scale, 8)
    return geo, bin_crop, rtab, kp, walk_params, walk_mask


@pytest.mark.parametrize("scale", [6, 1])
def test_plain_sample_lines_matches_scalar_staircase(scale):
    """The plain twin against a scalar numpy walk of the staircase formula."""
    geo, bin_crop, rtab, kp, _, _ = _kernel_inputs("cpu", scale)
    got = rf.sample_lines(geo.params, bin_crop, rtab, kp).numpy()
    params, crop, table = geo.params.numpy(), bin_crop.numpy(), rtab.numpy()
    c = crop.shape[-1]
    f32 = np.float32
    lanes = np.flatnonzero(geo.valid[0].numpy())[::7]
    assert len(lanes) > 5
    for lane in lanes:
        r0, s0, step, udom, dir_ = params[0, :5, lane]
        for k in range(kp):
            i = int(np.clip(np.trunc(f32(r0 + f32(dir_ * f32(k)))), 0, c - 1))
            col_f = np.floor(f32(s0 + f32(f32(f32(i) - r0) * f32(step * dir_))))
            col = int(np.clip(col_f, 0, c - 1))
            b = crop[0, col, i] if udom > 0.5 else crop[0, i, col]
            assert got[0, k, lane] == table[0, b], (lane, k)


@pytest.mark.parametrize("considered_distance", [0.05, None])
def test_plain_sample_windows_matches_scalar_formula(considered_distance):
    """The plain twin against a scalar numpy evaluation of the window formula."""
    args = _window_inputs("cpu", considered_distance)
    got = df.sample_windows(*args).numpy()
    image, u_min, v_min, stride, cu, cv, c, k = (
        a.numpy() if isinstance(a, torch.Tensor) else a for a in args)
    h, w = image.shape[1:]
    assert got.shape == u_min.shape + (k, k)
    for b in (0, 3):
        for p in range(0, u_min.shape[1], 13):
            for kv in range(k):
                row = cv[b] + min(max(v_min[b, p] - cv[b] + kv * stride[b, p], 0), c - 1)
                for ku in range(k):
                    col = cu[b] + min(max(u_min[b, p] - cu[b] + ku * stride[b, p], 0),
                                      c - 1)
                    want = image[b, row, col] if row < h and col < w else 0
                    assert got[b, p, kv, ku] == want, (b, p, kv, ku)


@pytest.mark.parametrize("n_tri", [None, 600])
def test_plain_query_eval_matches_scalar_chains(n_tri):
    """The plain twin against a scalar numpy walk of the two chains, with one rounding
    per operation (numpy float32 scalars), on some queries of each body."""
    coeffs, valid, sil, u, v = _query_inputs("cpu", n_tri, n_query=400)
    inv, ids = oc.query_eval(coeffs, valid, sil, u, v)
    c = np.where(valid.numpy()[..., None], coeffs.numpy(), np.float32(0))
    n = oc.leading_valid_count(valid).numpy()
    f32 = np.float32
    for b in range(c.shape[0]):
        for q in range(0, u.shape[1], 9):
            uq, vq = f32(u[b, q]), f32(v[b, q])
            best, best_id = [f32(0), f32(0)], [0, 0]
            for t in range(n[b]):
                e = [f32(f32(f32(c[b, t, 3 * k] * uq) + f32(c[b, t, 3 * k + 1] * vq))
                         + c[b, t, 3 * k + 2]) for k in range(4)]
                s = e[3] if min(e[:3]) >= 0 and e[3] > f32(1e-12) else f32(0)
                if s > best[t % 2]:
                    best[t % 2], best_id[t % 2] = s, int(sil[b, t])
            chain = 1 if best[1] > best[0] else 0
            assert inv[b, q].item() == best[chain] and ids[b, q].item() == best_id[chain]
    assert (ids != 0).float().mean() > 0.05


@pytest.mark.parametrize("mask", ["random", "sparse", "dense", "all", "none"])
def test_plain_scene_coeffs_order_is_a_stable_partition(mask):
    """The twin's front compaction equals a numpy stable partition of each scene's
    triangles by validity (the valid ones, then the others, each in their order), on
    validity masks set by tri_valid over triangles that are otherwise all valid: the
    order that the kernel's scan has to give."""
    n_scenes, n_tri = 6, 300
    tri, owner, _, _, cull, poses, fu, fv, pu, pv, z_min = _scene_inputs(
        "cpu", n_scenes, n_tri, cull="off", seed=4)
    poses[:, 2] = poses[:, 0]  # every body in front of the camera
    rng = np.random.default_rng(8)
    share = {"random": 0.5, "sparse": 0.05, "dense": 0.95, "all": 1.0, "none": 0.0}[mask]
    listed = rng.random((n_scenes, n_tri)) < share
    ids = torch.arange(n_tri, dtype=torch.int32).expand(n_scenes, n_tri)
    coeffs, valid, sil, bbox = oc.scene_coeffs_plain(
        tri, owner, ids, torch.as_tensor(listed), cull, poses, fu, fv, pu, pv, z_min)
    for b in range(n_scenes):
        index = np.arange(n_tri)
        want = np.concatenate([index[listed[b]], index[~listed[b]]])
        assert np.array_equal(sil[b].numpy(), want)
        assert np.array_equal(valid[b].numpy(), listed[b][want])
    soup = oc._posed_soup(tri, owner, ids, torch.ones_like(valid), cull, poses, fu, fv,
                          pu, pv, z_min)
    assert soup.valid.all()
    order = sil.long()
    assert torch.equal(coeffs, torch.gather(soup.coeffs, 1, order[..., None].expand(
        coeffs.shape)))
    assert torch.equal(bbox, torch.gather(soup.bbox, 1, order[..., None].expand(bbox.shape)))


def test_focused_scene_coeffs_counts_its_triangles():
    """With the tracer on, an eager call counts B x T scene triangles; its CPU form is
    the plain one, which counts nothing and launches nothing."""
    from m3t_tpu_torch.utils import timing

    pcfg, intr, _, _, poses, _, _, geom, occluder_poses = _occluded_scene("cpu")
    scene_poses = torch.cat([poses[:, None], occluder_poses], 1)
    b, t = geom.tri_valid.shape
    launches = oc.scene_coeffs.launches
    timing.reset()
    try:
        with timing.tracing():
            got = oc.focused_scene_coeffs(geom, scene_poses, intr, 320, 240,
                                          pcfg.focused_image_size)
            assert timing.report().counters == {"occlusion.scene_triangles": b * t}
            want = oc.focused_scene_coeffs_plain(geom, scene_poses, intr, 320, 240,
                                                 pcfg.focused_image_size)
            assert timing.report().counters == {"occlusion.scene_triangles": b * t}
    finally:
        timing.reset()
    assert oc.scene_coeffs.launches == launches
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_wrappers_reject_bad_inputs():
    params = torch.zeros((2, 8, 128))
    crop = torch.zeros((2, 16, 16), dtype=torch.int32)
    table = torch.zeros((2, 4096))
    with pytest.raises(ValueError):
        rf.sample_lines(params.double(), crop, table, 8)
    with pytest.raises(ValueError):
        rf.sample_lines(params, crop.long(), table, 8)
    with pytest.raises(ValueError):
        rf.sample_lines(params, crop, None, 8)
    with pytest.raises(ValueError):
        rf.sample_lines(params, crop, table, 8, output="probabilities")
    with pytest.raises(ValueError):
        rf.bin_counts(torch.zeros((2, 10), dtype=torch.int32), torch.ones((2, 10)))
    image = torch.zeros((2, 16, 20), dtype=torch.uint16)
    geometry = torch.zeros((2, 5), dtype=torch.int32)
    corners = torch.zeros(2, dtype=torch.int32)
    window_args = (image, geometry, geometry, geometry, corners, corners, 16, 3)
    for at, bad in ((0, image.view(torch.int16)), (0, image[:1]), (1, geometry.long()),
                    (2, geometry[:, :3]), (4, corners[:1]), (5, corners.float()),
                    (6, 0), (7, 0)):
        with pytest.raises(ValueError):
            df.sample_windows(*window_args[:at], bad, *window_args[at + 1:])
    coeffs, valid = torch.zeros((2, 4, 12)), torch.ones((2, 4), dtype=torch.bool)
    sil, queries = torch.zeros((2, 4), dtype=torch.int32), torch.zeros((2, 6))
    with pytest.raises(ValueError):
        oc.query_eval(coeffs[..., :11], valid, sil, queries, queries)
    with pytest.raises(ValueError):
        oc.query_eval(coeffs, valid, sil, queries, queries[:, :3])
    scene_args = _scene_inputs("cpu", 2, 4)
    for at, bad in ((0, scene_args[0][..., :2]), (1, scene_args[1].long()),
                    (3, scene_args[3][:, :3]), (5, scene_args[5][:, :, :3]),
                    (6, scene_args[6].double()), (9, scene_args[9][:1])):
        with pytest.raises(ValueError):
            oc.scene_coeffs(*scene_args[:at], bad, *scene_args[at + 1:])
    counters = (rf.sample_lines, rf.bin_counts, df.sample_windows, oc.query_eval,
                oc.scene_coeffs)
    before = [fn.launches for fn in counters]
    rf.sample_lines(params, crop, table, 8)
    rf.bin_counts(torch.zeros((2, 10), dtype=torch.int32),
                  torch.ones((2, 10), dtype=torch.bool))
    df.sample_windows(*window_args)
    oc.query_eval(coeffs, valid, sil, queries, queries)
    oc.scene_coeffs(*scene_args)
    assert [fn.launches for fn in counters] == before, \
        "the CPU twins must not count as kernel launches"


def test_declared_kernels_are_the_sources_entry_points():
    """The entry points in the ``extern "C"`` blocks of csrc/*.cu and the kernels that
    ops/_cuda.py declares are the same symbols with the same argument counts (the
    declarations leave out the stream, every entry point's last argument)."""
    in_sources = {}
    for source in _cuda.SOURCES:
        for block in re.findall(r'extern "C" \{(.*?)\}  // extern "C"', source.read_text(),
                                re.S):
            for symbol, params in re.findall(r"\bint\s+(m3t_\w+)\s*\(([^)]*)\)", block):
                in_sources[symbol] = params.count(",") + 1
    declared = {fn.symbol: len(fn.argtypes) + 1 for fn in _cuda.wrappers()}
    assert newton.newton_step in _cuda.wrappers() and len(declared) == 6
    assert declared == in_sources


# ---------------------------------------------------------------------------------------
# On the card (marker "cuda")
# ---------------------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("output", ["ratio", "bins"])
@pytest.mark.parametrize("lp", [256, 512])
@pytest.mark.parametrize("scale", [6, 4, 2, 1])
@pytest.mark.parametrize("n_bins", [16, 32])
def test_sample_lines_kernel_matches_plain(cuda_device, n_bins, scale, lp, output):
    """Every kp of the region path (120, 80, 40, 24), LP 256 and 512, both modes; 32^3
    bins put the ratio table (128 KB) in dynamic shared memory."""
    pcfg, intr, model, images, poses = _scene(cuda_device, n_bins=n_bins)
    state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
    bin_crop, cu, cv = pipeline._prepare_crops(pcfg, intr, images, poses)
    points = pipeline._select_view_cl(model, poses)
    geo = rf.line_geometry(pcfg.cfg, scale, points, 200, poses, *intr, 320, 240, cu, cv,
                           pcfg.crop_size, lp)
    table = rf.ratio_table(state.histogram_f, state.histogram_b) if output == "ratio" else None
    kp = rf.round_up(pcfg.cfg.line_length_in_segments * scale, 8)
    launches = rf.sample_lines.launches
    got = rf.sample_lines(geo.params, bin_crop, table, kp, output)
    torch.cuda.synchronize()
    assert rf.sample_lines.launches == launches + 1
    assert torch.equal(got, rf.sample_lines_plain(geo.params, bin_crop, table, kp, output))


@pytest.mark.cuda
def test_sample_lines_kernel_histogram_walk(cuda_device):
    """The histogram walk's bins-mode call (LP = 2 x the region LP)."""
    _, bin_crop, _, _, walk_params, walk_mask = _kernel_inputs(cuda_device, 1)
    kp2 = walk_mask.shape[-1]
    got_bins = rf.sample_lines(walk_params, bin_crop, None, kp2, output="bins")
    assert torch.equal(got_bins,
                       rf.sample_lines_plain(walk_params, bin_crop, None, kp2, "bins"))


@pytest.mark.cuda
@pytest.mark.parametrize("n_total,n", [(4096, 6144), (32768, 1000), (512, 300)])
def test_bin_counts_kernel_matches_plain(cuda_device, n_total, n):
    """Out-of-range bins are dropped; 32^3 bins use dynamic shared memory."""
    rng = np.random.default_rng(n)
    bins = torch.as_tensor(rng.integers(-2, n_total + 2, size=(7, n)).astype(np.int32),
                           device=cuda_device)
    mask = torch.as_tensor(rng.random((7, n)) > 0.3, device=cuda_device)
    launches = rf.bin_counts.launches
    got = rf.bin_counts(bins, mask, n_total)
    torch.cuda.synchronize()
    assert rf.bin_counts.launches == launches + 1
    assert torch.equal(got, rf.bin_counts_plain(bins, mask, n_total))


@pytest.mark.cuda
def test_wrappers_refuse_noncontiguous_cuda_inputs(cuda_device):
    bins = torch.zeros((4, 20), dtype=torch.int32, device=cuda_device)[:, ::2]
    mask = torch.ones((4, 10), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError):
        rf.bin_counts(bins, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [6.0, 3.6, 0.001, 520.0])
def test_divisions_give_the_cpus_bits(cuda_device, c):
    """depth_fn.div_const, div_value and rdiv give on the card the bits they give on the
    CPU, which are jitted JAX's (tests/test_torch_divisions.py); a plain division by a
    Python number does not: PyTorch on CUDA multiplies by its reciprocal, taken in double
    and rounded to float32."""
    from m3t_tpu_torch.ops import depth_fn

    x = torch.as_tensor(np.random.default_rng(0).uniform(0, 100, 1 << 20).astype(np.float32))
    z = torch.as_tensor(np.random.default_rng(1).uniform(0.2, 2, 1 << 20).astype(np.float32))
    for fn in (depth_fn.div_const, depth_fn.div_value):
        assert torch.equal(fn(x.to(cuda_device), c).cpu(), fn(x, c))
    assert torch.equal(depth_fn.rdiv(c, z.to(cuda_device)).cpu(), depth_fn.rdiv(c, z))
    assert not torch.equal((x.to(cuda_device) / c).cpu(), x / c)


@pytest.mark.cuda
def test_cycle_on_card_matches_cpu(cuda_device):
    states = {}
    for dev in ("cpu", cuda_device):
        pcfg, intr, model, images, poses = _scene(dev)
        pcfg = pcfg._replace(scales=(2, 1), standard_deviations=(5.0, 1.5),
                             n_corr_iterations=3)
        state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
        for _ in range(3):
            state = pipeline.tracking_cycle(pcfg, intr, images, model, state)
        states[str(dev)] = [a.cpu().numpy() for a in state]
    for got, want in zip(states["cuda"], states["cpu"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("widened", [False, True])
def test_kinematic_step_on_card_matches_cpu(cuda_device, widened):
    """The batched KKT step (torch.linalg.solve_ex) on the card against the CPU, for 64
    copies of the committed bench structure: as committed its KKT system is singular and
    the step must be zeroed on the card too; with the child free in all six directions
    the system is regular and the step moves the structure."""
    with np.load(KIN_NPZ) as f:
        arrays = {k: f[k] for k in f.files}
    if widened:
        arrays["free"] = np.ones_like(arrays["free"])
    s = 64
    rng = np.random.default_rng(3)
    jp = np.tile(arrays.pop("joint2parent"), (s, 1, 1, 1))
    g = rng.normal(size=(s, 2, 6)).astype(np.float32)
    h = np.broadcast_to(-100.0 * np.eye(6, dtype=np.float32), (s, 2, 6, 6)).copy()
    steps = {}
    for dev in (torch.device("cpu"), cuda_device):
        kin = kinematics.KinematicModel.from_numpy(arrays, dev).expand(s)
        steps[dev.type] = kinematics.update_structures(
            kin, *(torch.as_tensor(a, device=dev) for a in (jp, g, h)), 1000.0,
            30000.0).cpu().numpy()
    np.testing.assert_allclose(steps["cuda"], steps["cpu"], rtol=0, atol=1e-5)
    assert np.array_equal(steps["cuda"], jp) != widened


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("considered_distance", [0.05, 0.02, 0.01, None, 0.03, 0.015])
def test_sample_windows_kernel_matches_plain(cuda_device, considered_distance, shared):
    """Every instantiation of the kernel: the correspondence windows (K = 11, 5, 3) and
    measured-occlusion windows (K = 6) of the pipeline, and the runtime K (7, 4), on the
    shared frame (an expanded view, batch stride 0) and on its materialised copy."""
    args = _window_inputs(cuda_device, considered_distance)
    if not shared:
        args = (args[0].contiguous(),) + args[1:]
    assert args[-1] == {0.05: 11, 0.02: 5, 0.01: 3, None: 6, 0.03: 7,
                        0.015: 4}[considered_distance]
    launches = df.sample_windows.launches
    got = df.sample_windows(*args)
    torch.cuda.synchronize()
    assert df.sample_windows.launches == launches + 1
    assert torch.equal(got, df.sample_windows_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("frames", ["materialised", "distinct", "small", "ragged",
                                    "ragged distinct"])
def test_sample_windows_kernel_frames(cuda_device, frames):
    """K=11 windows on the scene's frame materialised per body and on a different frame
    per body, on a 100x90 frame under
    the 128-pixel crop (0 beyond it), and with P=37 on the shared and on distinct frames
    (a body's output starts off a 16-byte boundary: ragged heads and tails)."""
    image, *geometry = _window_inputs(cuda_device, 0.05)
    if frames == "materialised":
        image = image.contiguous()
    elif "distinct" in frames:
        planes = image.contiguous().view(torch.int16)
        image = torch.stack([planes[b].roll((3 * b, -5 * b), (0, 1))
                             for b in range(image.shape[0])]).view(torch.uint16)
    if frames == "small":
        # The frame's 100x90 centre, the windows moved with it, crops at the origin.
        image = image[0, 60:150, 110:210].contiguous().expand(image.shape[0], -1, -1)
        u_min, v_min, stride, cu, _, c, k = geometry
        geometry = [u_min - 110, v_min - 60, stride, torch.zeros_like(cu),
                    torch.zeros_like(cu), c, k]
    elif frames.startswith("ragged"):
        geometry[:3] = [g[:, :37].contiguous() for g in geometry[:3]]
    got = df.sample_windows(image, *geometry)
    want = df.sample_windows_plain(image, *geometry)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if frames == "small":
        assert (want == 0).any() and (want > 0).any()


@pytest.mark.cuda
def test_sample_windows_refuses_what_the_kernel_does_not_take(cuda_device):
    image, *geometry = _window_inputs(cuda_device, 0.01)
    with pytest.raises(ValueError):
        df.sample_windows(image.contiguous()[:, :, ::2], *geometry)
    with pytest.raises(ValueError):
        df.sample_windows(image, geometry[0][:, ::2], *geometry[1:])
    with pytest.raises(ValueError):
        df.sample_windows(image, *geometry[:4], geometry[4].cpu(), *geometry[5:])


@pytest.mark.cuda
def test_rgbd_cycle_on_card_matches_cpu(cuda_device):
    """Measured occlusions on both modalities; each cycle starts both devices from the
    CPU's state (see chip_smoke.py's card-versus-CPU phase)."""
    setups = {str(dev): _depth_scene(dev) for dev in ("cpu", cuda_device)}
    pcfg, intr, model, images, poses, _, _ = setups["cpu"]
    pcfg = pcfg._replace(scales=(2, 1), standard_deviations=(5.0, 1.5), n_corr_iterations=3)
    state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
    for _ in range(3):
        results = {}
        for dev, (_, _, model, images, _, depth_model, depth) in setups.items():
            start = pipeline.TrackingState(*(a.to(dev) for a in state))
            results[dev] = pipeline.tracking_cycle_rgbd(
                pcfg, intr, intr, 0.001, images, depth, model, depth_model, start)
        for got, want in zip(results["cuda"], results["cpu"]):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-4)
        state = results["cpu"]


@pytest.mark.cuda
@pytest.mark.parametrize("pixels", [torch.int32, torch.float32])
@pytest.mark.parametrize("n_tri,n_bodies,n_query", [(None, 512, 9600), (1600, 16, 4096),
                                                    ("robots", 4, 7200), (2500, 8, 1100),
                                                    ("trap", 64, 1024)])
def test_query_eval_kernel_matches_plain(cuda_device, n_tri, n_bodies, n_query, pixels):
    """The occluded scene's coefficients at B=512, Q=9600 (the flagship occlusion
    path's shape; at most 512 rows, staged whole), 1600 random triangles, the kinematic
    cell's robot scenes at S = 4 (28 scenes of 2240 triangles, 7200 windowed queries
    each: a ragged last block), and 2500 random triangles over the queries' span, of
    which each block keeps more than its list of 512 holds (rounds), and
    tests/torch_query_scenes.py's trap_scene (the chain of a row from its t, the block's
    box from all of its tiles), with int32 and float32 pixels: inverse depths bit for
    bit, ids exactly, one launch a call."""
    if n_tri == "robots":
        coeffs, valid, sil, u, v = qs.robot_queries(cuda_device, 1, n_bodies)
        assert u.shape[1] == n_query
    elif n_tri == "trap":
        coeffs, valid, sil, u, v = qs.trap_scene(n_bodies, cuda_device)
        assert u.shape[1] == n_query
    else:
        coeffs, valid, sil, u, v = _query_inputs(cuda_device, n_tri, n_bodies, n_query)
    u, v = u.to(pixels), v.to(pixels)
    launches = oc.query_eval.launches
    inv, ids = oc.query_eval(coeffs, valid, sil, u, v)
    torch.cuda.synchronize()
    assert oc.query_eval.launches == launches + 1
    want_inv, want_ids = oc.query_eval_plain(coeffs, valid, sil, u, v)
    assert torch.equal(inv.view(torch.int32), want_inv.view(torch.int32))
    assert torch.equal(ids, want_ids)
    assert (ids != 0).any() and (ids == 0).any()


@pytest.mark.cuda
def test_query_eval_kernel_adversarial(cuda_device):
    """chip_smoke's adversarial case at B=512: ties at t=0 and t=2 with t=1 culled and
    across the chains, an invalid and a valid row of NaN coefficients, a triangle whose
    edge is the edge of a half-warp's query box, one a float step beyond it, and NaN,
    -1e9 and infinite queries."""
    import chip_smoke

    args, _ = chip_smoke.adversarial_queries(512, cuda_device)
    inv, ids = oc.query_eval(*args)
    want_inv, want_ids = oc.query_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(inv.view(torch.int32), want_inv.view(torch.int32))
    assert torch.equal(ids, want_ids)
    assert set(ids.unique().tolist()) == {0, 11, 15}


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["robots", "whole"])
def test_query_eval_counts_its_block_cull(cuda_device, scene):
    """With the tracer on, two eager calls count occlusion.query_rows_scanned and
    occlusion.query_rows_kept twice as the CPU emulation of the kernel counts them
    (tests/torch_query_scenes.py, the blocks' loop bounds and the rows of their lists),
    on the robot scenes at S = 2 (the block cull keeps some of the rows) and on the
    occluded scene of at most 512 rows (staged whole: every row under the bound); no call
    waits for the card (the report reads the tally); the same call with the tracer off,
    or captured into a CUDA graph and replayed with it on, counts nothing, and every
    call gives the same results."""
    from m3t_tpu_torch.utils import timing

    if scene == "robots":
        args = qs.robot_queries(cuda_device, 2, 2)
    else:
        args = _query_inputs(cuda_device, None, 16, 9600)
        assert args[0].shape[1] <= qs.LIST_ROWS
    want = oc.query_eval(*args)
    timing.reset()
    try:
        with timing.tracing():
            torch.cuda.set_sync_debug_mode("error")
            try:
                eager = [oc.query_eval(*args) for _ in range(2)]
            finally:
                torch.cuda.set_sync_debug_mode("default")
            counters = dict(timing.report().counters)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                captured = oc.query_eval(*args)
            graph.replay()
            torch.cuda.synchronize()
            assert timing.report().counters == counters
    finally:
        timing.reset()
    _, _, tally = qs.culled_query_eval(*(x.cpu() for x in args))
    kept = int(tally.kept.sum())
    assert counters == {"occlusion.query_rows_scanned": 2 * tally.scanned,
                        "occlusion.query_rows_kept": 2 * kept}
    if scene == "robots":
        assert 0 < kept < tally.scanned
    else:
        assert 0 < kept == tally.scanned
    for got in eager + [captured]:
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.cuda
def test_query_eval_refuses_misaligned_coeffs(cuda_device):
    """The kernel reads coefficient rows as 16-byte words: a contiguous coeffs view that
    starts 4 bytes into its storage is refused, not launched."""
    coeffs, valid, sil, u, v = _query_inputs(cuda_device, 600, 2, 64)
    shifted = torch.empty(coeffs.numel() + 1, device=cuda_device)[1:].view(coeffs.shape)
    shifted.copy_(coeffs)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    launches = oc.query_eval.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        oc.query_eval(shifted, valid, sil, u, v)
    assert oc.query_eval.launches == launches


def _assert_same_scene(got, want):
    for name, x, y in zip(oc.SceneCoeffs._fields, got, want):
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_scene_coeffs_kernel_matches_plain_on_robot_scenes(cuda_device, seed):
    """The kinematic cell's robot scenes at S = 4 (28 scenes of 2240 triangles): every
    SceneCoeffs field of the kernel's focused scenes equals the plain twin's on the same
    card inputs, one launch a call, and the query kernel on both gives the same inverse
    depths and ids at every pixel of a grid over the crop."""
    geom, scene_poses, intr, width, height = qs.robot_scenes(cuda_device, seed)
    launches = oc.scene_coeffs.launches
    got = oc.focused_scene_coeffs(geom, scene_poses, intr, width, height, 200)
    torch.cuda.synchronize()
    assert oc.scene_coeffs.launches == launches + 1
    want = oc.focused_scene_coeffs_plain(geom, scene_poses, intr, width, height, 200)
    _assert_same_scene(got, want)
    n_valid = got.tri_valid.sum(1)
    assert (n_valid > 0).all() and (n_valid < got.tri_valid.shape[1]).all()
    grid = torch.arange(0, 200, 3, dtype=torch.int32, device=cuda_device)
    u = grid[None, :].expand(len(grid), -1).reshape(1, -1).expand(geom.owner.shape[0], -1)
    v = grid[:, None].expand(-1, len(grid)).reshape(1, -1).expand_as(u)
    inv, ids = oc.query_eval(got.coeffs, got.tri_valid, got.sil_id, u, v)
    want_inv, want_ids = oc.query_eval(want.coeffs, want.tri_valid, want.sil_id, u, v)
    torch.cuda.synchronize()
    assert torch.equal(inv.view(torch.int32), want_inv.view(torch.int32))
    assert torch.equal(ids, want_ids)
    assert len(ids.unique()) > 2


@pytest.mark.cuda
@pytest.mark.parametrize("n_scenes,n_tri,cull,expanded", [
    (7, 300, "mixed", False),    # T not a multiple of the 256-thread tile
    (5, 20, "mixed", False),     # T under one warp
    (9, 100, "mixed", False),    # a 128-thread block
    (3, 1000, "off", False),     # culling off, four tiles
    (6, 600, "mixed", True),     # one scene's rows broadcast: scene stride 0
])
def test_scene_coeffs_kernel_matches_plain(cuda_device, n_scenes, n_tri, cull, expanded):
    """Random scenes, scene 0 with no valid triangle and scene 1 with every triangle
    valid, triangles wholly and partly behind z_min: the kernel's four outputs equal the
    plain twin's on the same card inputs, one launch a call."""
    args = _scene_inputs(cuda_device, n_scenes, n_tri, cull, seed=n_tri, expanded=expanded)
    launches = oc.scene_coeffs.launches
    got = oc.scene_coeffs(*args)
    torch.cuda.synchronize()
    assert oc.scene_coeffs.launches == launches + 1
    want = oc.scene_coeffs_plain(*args)
    for name, x, y in zip(("coeffs", "tri_valid", "sil_id", "bbox"), got, want):
        assert torch.equal(x, y), name
    n_valid = got[1].sum(1)
    if not expanded:
        assert n_valid[0] == 0 and n_valid[1] == n_tri
        assert (n_valid[2:] > 0).all() and (n_valid[2:] < n_tri).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sample_lines ratio", "sample_lines bins",
                                    "sample_windows", "query_eval"])
def test_kernels_take_more_bodies_than_one_grid_y(cuda_device, kernel):
    """B = 65536 + 3 bodies, more than one launch's grid y holds (65535): the launcher
    slices the batch, and every body, the last three too, equals the plain twin."""
    b = 65536 + 3
    gen = torch.Generator(cuda_device).manual_seed(3)

    def ints(high, *shape, low=0):
        return torch.randint(low, high, shape, generator=gen, device=cuda_device,
                             dtype=torch.int32)

    def uniform(low, high, *shape):
        return low + (high - low) * torch.rand(shape, generator=gen, device=cuda_device)

    launches = {"sample_lines": rf.sample_lines, "sample_windows": df.sample_windows,
                "query_eval": oc.query_eval}[kernel.split()[0]]
    before = launches.launches
    if kernel.startswith("sample_lines"):
        c, lp, kp, n_table = 32, 128, 24, 512
        params = torch.zeros((b, 8, lp), device=cuda_device)
        params[:, 0], params[:, 1] = uniform(0, c, b, lp), uniform(0, c, b, lp)
        params[:, 2], params[:, 3] = uniform(-1, 1, b, lp), ints(2, b, lp).float()
        params[:, 4] = ints(2, b, lp).float() * 2 - 1
        crop = ints(n_table, b, c, c)
        output = kernel.split()[1]
        table = uniform(0, 1, b, n_table) if output == "ratio" else None
        got = rf.sample_lines(params, crop, table, kp, output)
        want = rf.sample_lines_plain(params, crop, table, kp, output)
        got, want = got.view(torch.int32), want.view(torch.int32)
    elif kernel == "sample_windows":
        h, w, p, c = 20, 24, 4, 16
        image = ints(1 << 16, b, h, w).to(torch.uint16)
        corner_u, corner_v = ints(w, b, low=-8), ints(h, b, low=-8)
        u_min = corner_u[:, None] + ints(c, b, p, low=-2)
        v_min = corner_v[:, None] + ints(c, b, p, low=-2)
        args = (image, u_min, v_min, ints(4, b, p, low=1), corner_u, corner_v, c, 3)
        got, want = df.sample_windows(*args), df.sample_windows_plain(*args)
    else:
        coeffs, valid, sil, u, v = _query_inputs(cuda_device, 8, b, 64)
        got = torch.stack([x.view(torch.int32) for x in
                           oc.query_eval(coeffs, valid, sil, u, v)], 1)
        want = torch.stack([x.view(torch.int32) for x in
                            oc.query_eval_plain(coeffs, valid, sil, u, v)], 1)
    torch.cuda.synchronize()
    assert launches.launches == before + 1
    assert got.shape[0] == b and torch.equal(got, want)
    assert want[-1].any(), "the last body's output is all zeros: nothing was checked"


@pytest.mark.cuda
@pytest.mark.parametrize("rgbd", [False, True])
def test_scene_cycles_on_card_match_cpu(cuda_device, rgbd):
    """The region cycle with both region scene checks and the RGB-D cycle with all four,
    a cube occluding the sphere; each cycle starts both devices from the CPU's state."""
    setups = {str(dev): _occluded_scene(dev) for dev in ("cpu", cuda_device)}
    pcfg, intr, model, images, poses = setups["cpu"][:5]
    pcfg = pcfg._replace(scales=(2, 1), standard_deviations=(5.0, 1.5), n_corr_iterations=3,
                         use_depth=rgbd)
    state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
    for _ in range(3):
        results = {}
        for dev, (_, _, model, images, _, depth_model, depth, geom, occ) in setups.items():
            start = pipeline.TrackingState(*(a.to(dev) for a in state))
            if rgbd:
                results[dev] = pipeline.tracking_cycle_rgbd(
                    pcfg, intr, intr, 0.001, images, depth, model, depth_model, start,
                    scene_geom=geom, occluder_poses=occ)
            else:
                results[dev] = pipeline.tracking_cycle(pcfg, intr, images, model, start,
                                                       scene_geom=geom, occluder_poses=occ)
        for got, want in zip(results["cuda"], results["cpu"]):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-4)
        state = results["cpu"]


def _scale_out_steps(path, inp):
    """The scale-out path's StartModality and its one-step call on inp (a dry-run
    problem on one device): (start, step(state, t) -> state) with t the frame."""
    from m3t_tpu_torch.parallel import dryrun, sharding

    pcfg, intr, cam2ref = inp["pcfg"], inp["intr"], inp["cam2ref"]
    if path == "rigid":
        pcfg = pcfg._replace(use_texture=True)
        start = pipeline.initialize_multicamera_histograms(pcfg, intr, inp["images"], cam2ref,
                                                           inp["model"], inp["poses"])
        cycle = pipeline.make_sharded_cycle(pcfg, None, intr, intr, with_depth=True,
                                            with_scene=True, with_texture=True)
        b, c = inp["images"].shape[:2]
        gen = torch.Generator().manual_seed(5)
        tex = TexturePoints(0.03 * torch.randn((b, c, 16, 3), generator=gen),
                            60 + 40 * torch.rand((b, c, 16, 2), generator=gen),
                            torch.rand((b, c, 16), generator=gen) > 0.4)
        tex = TexturePoints(*(a.to(cam2ref.device) for a in tex))
        return start, lambda state, t: cycle(
            inp["images"], cam2ref, inp["model"], state, inp["depth_images"],
            dryrun.DEPTH_SCALE, inp["depth_model"], inp["scene_geom"], inp["occluder_poses"],
            tex)
    if path == "kinematic":
        jp = inp["joint2parent"]
        s, nl = jp.shape[:2]
        link_poses = pipeline._kinematic_flat_poses(inp["kin"], jp)[1]
        mc = pipeline.initialize_multicamera_histograms(
            pcfg, intr, pipeline._repeat_each(inp["kin_images"], nl), cam2ref,
            inp["link_model"], link_poses)
        start = pipeline.KinematicMultiCameraState(
            jp, *(h.reshape((s, nl) + h.shape[1:]) for h in mc[1:]))
        cycle = pipeline.make_sharded_kinematic_cycle(pcfg, None, intr, intr, with_depth=True,
                                                      with_scene=True)
        return start, lambda state, t: cycle(
            inp["kin_images"], cam2ref, inp["link_model"], inp["kin"], state,
            inp["kin_depth"], dryrun.DEPTH_SCALE, inp["link_depth_model"], inp["kin_scene"],
            None)
    scan_pcfg = pcfg._replace(use_depth=path == "scan_rgbd", region_model_occlusions=False,
                              region_checking=False, region_measure_occlusions=False,
                              depth_model_occlusions=False, depth_silhouette_check=False,
                              depth_measure_occlusions=False)
    start = pipeline.initialize_histograms(scan_pcfg, intr, inp["scan_images"][0],
                                           inp["model"], inp["poses"])
    if path == "scan":
        return start, lambda state, t: sharding.track_sequences_scan(
            scan_pcfg, intr, inp["scan_images"][t:t + 1], inp["model"], state)[0]
    return start, lambda state, t: sharding.track_sequences_scan_rgbd(
        scan_pcfg, intr, intr, dryrun.DEPTH_SCALE, inp["scan_images"][t:t + 1],
        inp["scan_depth"][t:t + 1], inp["model"], inp["depth_model"], state)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["rigid", "kinematic", "scan", "scan_rgbd"])
def test_scale_out_paths_on_card_match_cpu(cuda_device, path):
    """The multi-camera rigid cycle (depth, every scene check, measured occlusions,
    texture), the multi-camera articulated cycle (depth, per-link scenes) and both
    sequence scans at B=4 (S=4) and C=2, on the inputs of m3t_tpu_torch.parallel.dryrun:
    StartModality, then two steps, each started on both devices from the CPU's state."""
    from m3t_tpu_torch.parallel import dryrun

    inputs = {dev: dryrun.problem(torch.device(dev), 2) for dev in ("cpu", "cuda")}
    runs = {dev: _scale_out_steps(path, inp) for dev, inp in inputs.items()}
    for got, want in zip(runs["cuda"][0], runs["cpu"][0]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-4)
    state = runs["cpu"][0]
    for t in (1, 2):
        results = {dev: step(type(state)(*(a.to(dev) for a in state)), t)
                   for dev, (_, step) in runs.items()}
        for got, want in zip(results["cuda"], results["cpu"]):
            np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-4)
        state = results["cpu"]


def _serve_tracker(device, tmp_path, frames, depth_frames, poses, rgbd):
    """The serve path's object graph (chip_smoke.py phase 9) over len(poses) bodies of
    the bench sphere on device: the committed models loaded as the cache files of the
    port's RegionModel and DepthModel, one colour (and depth) camera, a Tracker with 3x2
    iterations through the fused serve backend."""
    import shutil

    from m3t_tpu_torch import (camera, depth_modality, detector, link, optimizer,
                               region_modality, tracker)
    from m3t_tpu_torch.depth_model import DepthModel
    from m3t_tpu_torch.region_model import RegionModel

    models = []
    for cls, npz in ((RegionModel, NPZ), (DepthModel, DEPTH_NPZ)):
        path = tmp_path / f"{device}_{npz.name}"
        shutil.copy(npz, path)
        models.append(cls(npz.stem, procedural.sphere_body("bench", 0.06, 2), str(path),
                          n_divides=2, n_points=200, image_size=800))
        assert models[-1].SetUp()
    intr = Intrinsics(300.0, 300.0, 159.5, 119.5, 320, 240)
    color_camera = camera.ImageColorCamera("color", intr, frames)
    depth_camera = camera.ImageDepthCamera("depth", intr, depth_frames)
    srv = tracker.Tracker("serve", n_corr_iterations=3, n_update_iterations=2,
                          use_fused_cycle=True)
    for i, pose in enumerate(poses):
        body = procedural.sphere_body(f"body{i}", 0.06, 2)
        rm = region_modality.RegionModality(f"region{i}", body, color_camera, models[0],
                                            device=device)
        rm.scales, rm.standard_deviations = [4, 2, 1], [5.0, 3.5, 1.5]
        body_link = link.Link(f"link{i}", body)
        body_link.AddModality(rm)
        if rgbd:
            body_link.AddModality(depth_modality.DepthModality(
                f"depth{i}", body, depth_camera, models[1], device=device))
        opt = optimizer.Optimizer(f"optimizer{i}", body_link)
        srv.AddOptimizer(opt)
        srv.AddDetector(detector.StaticDetector(f"detector{i}", opt, link2world_pose=pose))
    assert srv.SetUp()
    srv.ExecuteDetection(start_tracking=True)
    return srv


@pytest.mark.cuda
@pytest.mark.parametrize("rgbd", [False, True], ids=["region", "rgbd"])
def test_serve_on_card_matches_cpu(cuda_device, rgbd, tmp_path, monkeypatch):
    """The Tracker at B=4 served through the fused backend on the card and on the CPU:
    detection and the starting step at frame 0, then a step per frame (the sphere moves
    1 mm per frame), each started on both devices from the CPU's state.  Every kernel
    call of the card's steps equals its twin on the same inputs; poses and histograms
    agree within 1e-4 but for at most one body per step: a sphere's rotation is held
    only by the Tikhonov term, so a sample on a rounding boundary of the plain
    arithmetic moves it by ~3e-3, and its histograms with it (at step 1 body 1 does so
    on the card, by 2.889e-3 in pose and 5.4e-4 in histograms, and on the CPU alone
    when its state moves by a relative 1e-7; chip_smoke.py phase 7).  That body stays
    within 1e-2 in pose and 1e-3 in histograms."""
    from m3t_tpu_torch import fused_serve

    intr = Intrinsics(300.0, 300.0, 159.5, 119.5, 320, 240)
    sphere = procedural.sphere_triangles(0.06, 2)
    frames, depth_frames = [], []
    for t in range(3):
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [0.001 * t, 0.0, 0.5]
        frames.append(procedural.render_synthetic_color_frame(
            sphere, intr, pose, noise_rng=np.random.default_rng(t)))
        depth_frames.append(procedural.render_synthetic_depth_frame(sphere, intr, pose))
    rng = np.random.default_rng(12)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, 2, 3] = 0.5
    poses[:, :2, 3] += rng.uniform(-0.004, 0.004, (4, 2)).astype(np.float32)
    trackers = {dev: _serve_tracker(dev, tmp_path, frames, depth_frames, poses, rgbd)
                for dev in ("cpu", "cuda")}
    calls = []
    for module, name in ((rf, "sample_lines"), (rf, "bin_counts"), (df, "sample_windows")):
        def record(*args, kernel=getattr(module, name), twin=getattr(module, f"{name}_plain"),
                   **kwargs):
            out = kernel(*args, **kwargs)
            if out.is_cuda:
                calls.append(torch.equal(out, twin(*args, **kwargs)))
            return out
        monkeypatch.setattr(module, name, record)

    def state(srv):
        rms = [o.root_link_ptr.modality_ptrs[0] for o in srv.optimizer_ptrs]
        return [np.stack([o.root_link_ptr.link2world_pose for o in srv.optimizer_ptrs]),
                *(torch.stack([getattr(m.color_histograms_ptr, f"histogram_{s}") for m in rms])
                  .cpu().numpy() for s in "fb")]

    # The recorder holds every kernel call against its twin, so the card's steps run
    # eagerly: a graph's replay makes no wrapper call.
    with graphs.disable_graphs():
        for i in range(3):
            for srv in trackers.values():
                assert (srv.UpdateCameras(i) and srv.CalculateConsistentPoses()
                        and srv.ExecuteDetectingStep(i) and srv.ExecuteStartingStep(i)
                        and srv.ExecuteTrackingStep(i))
                assert srv._fused_backend is not None
            want = state(trackers["cpu"])
            got = state(trackers["cuda"])
            # A body parts when its pose or its histograms do (a moved pose moves the
            # histogram update too).
            parted = np.any([np.abs(g - w).reshape(4, -1).max(1) > 1e-4
                             for g, w in zip(got, want)], axis=0)
            assert parted.sum() <= 1, f"step {i}: bodies {np.flatnonzero(parted)} parted"
            for g, w, bound in zip(got, want, (1e-2, 1e-3, 1e-3)):
                np.testing.assert_allclose(g[~parted], w[~parted], rtol=0, atol=1e-4,
                                           err_msg=f"step {i}")
                np.testing.assert_allclose(g[parted], w[parted], rtol=0, atol=bound,
                                           err_msg=f"step {i}, parted body "
                                                   f"{np.flatnonzero(parted)}")
            fused_serve.load_graph_state(trackers["cuda"],
                                         fused_serve.read_graph_state(trackers["cpu"]))
    assert calls and all(calls), calls
