"""Parity tests: m3t_tpu_torch.ops.region_fast (PyTorch twins on the CPU) against the JAX
package's m3t_tpu.ops.region_fast (Pallas in interpret mode on the CPU).

Inputs are the scene of tests/test_region_fast.py (320x240 frame, 128 lines) made from
numpy seeds and handed to both sides as numpy arrays.  Integer results (crops, bins,
validity, masks, counts) and the line parameters must match exactly; float reductions
match to the tolerances stated per test.  The kernels themselves are held against
these twins on the card by tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu import pipeline as jpipe
from m3t_tpu.ops import depth_fast as jdf
from m3t_tpu.ops import region_fast as jrf
from m3t_tpu.ops import region_fn as jrfn
from m3t_tpu.ops.region_fn import RegionConfig as JRegionConfig
from m3t_tpu.region_model import RegionModel
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.ops import depth_fast as tdf
from m3t_tpu_torch.ops import region_fast as trf
from m3t_tpu_torch.ops import region_fn as trfn
from m3t_tpu_torch.ops.region_fn import RegionConfig as TRegionConfig
from tests import fixtures

L = 128


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trf")
    intr = fixtures.test_intrinsics(320, 240)
    body = fixtures.sphere_body("s", radius=0.07, n_subdiv=2)
    model = RegionModel("m", body, str(tmp / "m.npz"), n_divides=1, n_points=L,
                        image_size=400)
    assert model.SetUp()
    rng = np.random.default_rng(3)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.01, -0.008, 0.45]
    frame = fixtures.render_synthetic_color_frame(body, intr, pose, noise_rng=rng)
    arrays = jpipe.RegionModelArrays.from_models([model], L)
    intr4 = (np.float32(intr.fu), np.float32(intr.fv),
             np.float32(intr.ppu), np.float32(intr.ppv))
    jpcfg = jpipe.PipelineConfig(cfg=JRegionConfig(n_lines_max=L))
    tpcfg = tpipe.PipelineConfig(cfg=TRegionConfig(n_lines_max=L))
    state = jpipe.initialize_histograms(
        jpcfg, intr4, jnp.asarray(frame)[None], arrays, jnp.asarray(pose)[None])
    images, poses = jnp.asarray(frame)[None], jnp.asarray(pose)[None]
    bin_crop, bin_cropT, cu, cv = jpipe._prepare_crops(jpcfg, intr4, images, poses)
    jpoints = jax.vmap(jpipe._select_view_cl)(arrays, poses)
    tmodel = tpipe.RegionModelArrays.from_numpy(
        {k: np.asarray(v) for k, v in arrays._asdict().items()}, device="cpu")
    tpoints = tpipe._select_view_cl(tmodel, _t(pose[None]))
    return dict(intr=intr, intr4=intr4, body=body, frame=frame, pose=pose, jpcfg=jpcfg,
                tpcfg=tpcfg, state=state, arrays=arrays, tmodel=tmodel,
                jcrop=(bin_crop, bin_cropT, cu, cv), jpoints=jpoints, tpoints=tpoints)


def _geometries(scene, scale):
    s = scene
    intr, (fu, fv, ppu, ppv) = s["intr"], s["intr4"]
    bin_crop, _, cu, cv = s["jcrop"]
    jcfg, tcfg = s["jpcfg"], s["tpcfg"]
    jgeo = jax.vmap(lambda p, po, u, v: jrf.line_geometry(
        jcfg.cfg, scale, p, jnp.int32(L), po, fu, fv, ppu, ppv, intr.width, intr.height,
        u, v, jcfg.crop_size, jcfg.lp))(s["jpoints"], jnp.asarray(s["pose"])[None], cu, cv)
    tgeo = trf.line_geometry(
        tcfg.cfg, scale, s["tpoints"], L, _t(s["pose"][None]), float(fu), float(fv),
        float(ppu), float(ppv), intr.width, intr.height, _t(cu), _t(cv),
        tcfg.crop_size, tcfg.lp)
    return jgeo, tgeo


def _occluded_depth_frame(scene):
    """The body's depth frame with a near wall (0.3 m) over the left half of the
    silhouette, so that part of the contour is occluded."""
    s = scene
    intr = s["intr"]
    depth = fixtures.render_synthetic_depth_frame(s["body"], intr, s["pose"])
    center_u = int(s["pose"][0, 3] * intr.fu / s["pose"][2, 3] + intr.ppu)
    depth[:, :center_u] = 300
    return depth


@pytest.mark.parametrize("presampled,handle,min_lines", [
    (True, True, 0), (False, True, 0), (True, False, 0), (False, True, 10000)])
def test_line_geometry_measured_occlusion_matches(scene, presampled, handle, min_lines):
    """Measured occlusions drop the lines behind the wall, unless occlusion handling is
    off or fewer than min_n_unoccluded_lines survive (two-pass fallback)."""
    s = scene
    intr, (fu, fv, ppu, ppv) = s["intr"], s["intr4"]
    _, _, cu, cv = s["jcrop"]
    scale, crop = 2, s["jpcfg"].crop_size
    jcfg = s["jpcfg"].cfg._replace(min_n_unoccluded_lines=min_lines)
    tcfg = s["tpcfg"].cfg._replace(min_n_unoccluded_lines=min_lines)
    depth = _occluded_depth_frame(s)
    pose_j = jnp.asarray(s["pose"])[None]
    pose_t = _t(s["pose"][None])
    jpre = tpre = None
    if presampled:
        cropT, dcu, dcv = jdf.depth_crops(jnp.asarray(depth)[None], pose_j, fu, fv, ppu,
                                          ppv, crop)
        jpre = jdf.presample_occlusion_windows(
            jcfg.measured_occlusion_radius, False,
            jnp.swapaxes(s["jpoints"].center_f_body, 1, 2), pose_j, cropT, dcu, dcv, crop,
            fu, fv, ppu, ppv, intr.width, intr.height)
        tdcu, tdcv = tdf.depth_corners(_t(depth[None]), pose_t, float(fu), float(fv),
                                       float(ppu), float(ppv), crop)
        tpre = tdf.presample_occlusion_windows(
            tcfg.measured_occlusion_radius, False,
            s["tpoints"].center_f_body.transpose(1, 2), pose_t, _t(depth[None]), tdcu,
            tdcv, crop, float(fu), float(fv), float(ppu), float(ppv), intr.width,
            intr.height)

    def bc(x):
        return jnp.full((1,), x, jnp.float32)

    jmo = jrfn.MeasuredOcclusionInputs(jnp.asarray(depth)[None], pose_j, bc(fu), bc(fv),
                                       bc(ppu), bc(ppv), bc(0.001), jpre)
    jgeo = jax.vmap(lambda p, po, u, v, mo, ho: jrf.line_geometry(
        jcfg, scale, p, jnp.int32(L), po, fu, fv, ppu, ppv, intr.width, intr.height,
        u, v, crop, s["jpcfg"].lp, measured_occlusion=mo, handle_occlusions=ho))(
            s["jpoints"], pose_j, cu, cv, jmo, jnp.asarray([handle]))
    tmo = trfn.MeasuredOcclusionInputs(_t(depth[None]), pose_t, float(fu), float(fv),
                                       float(ppu), float(ppv), 0.001, tpre)
    tgeo = trf.line_geometry(
        tcfg, scale, s["tpoints"], L, pose_t, float(fu), float(fv), float(ppu),
        float(ppv), intr.width, intr.height, _t(cu), _t(cv), crop, s["tpcfg"].lp,
        measured_occlusion=tmo, handle_occlusions=torch.tensor([handle]))
    valid = np.asarray(jgeo.valid)
    np.testing.assert_array_equal(_n(tgeo.valid), valid)
    unoccluded = np.asarray(_geometries(s, scale)[0].valid)
    if handle and min_lines == 0:
        assert 10 < valid.sum() < unoccluded.sum() - 10
    else:
        np.testing.assert_array_equal(valid, unoccluded)


def _tables(scene):
    st = scene["state"]
    return (jrf.ratio_table(st.histogram_f, st.histogram_b),
            trf.ratio_table(_t(st.histogram_f), _t(st.histogram_b)))


def test_crops_and_ratio_table_match(scene):
    s = scene
    bin_crop, _, cu, cv = s["jcrop"]
    t_crop, t_cu, t_cv = tpipe._prepare_crops(
        s["tpcfg"], s["intr4"], _t(s["frame"][None]), _t(s["pose"][None]))
    np.testing.assert_array_equal(_n(t_cu), np.asarray(cu))
    np.testing.assert_array_equal(_n(t_cv), np.asarray(cv))
    np.testing.assert_array_equal(_n(t_crop), np.asarray(bin_crop))
    assert t_crop.dtype == torch.int32
    j_tab, t_tab = _tables(s)
    np.testing.assert_array_equal(_n(t_tab), np.asarray(j_tab).reshape(1, -1))


@pytest.mark.parametrize("scale", [6, 2, 1])
def test_line_geometry_matches(scene, scale):
    jgeo, tgeo = _geometries(scene, scale)
    valid = np.asarray(jgeo.valid)
    assert valid.sum() > 30, "scene produced too few valid lines to be meaningful"
    np.testing.assert_array_equal(_n(tgeo.valid), valid)
    np.testing.assert_array_equal(_n(tgeo.params), np.asarray(jgeo.params))
    for name in ("center_u", "center_v", "normal_u", "normal_v", "center_f_body",
                 "normal_p", "delta_r", "normal_component_to_scale"):
        np.testing.assert_allclose(_n(getattr(tgeo, name)),
                                   np.asarray(getattr(jgeo, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("scale", [6, 7])
def test_line_geometry_scale_quotient_matches_jitted_jax(scene, scale, monkeypatch):
    """normal_component_to_scale = |normal_p| / scale, whose ulp decides the distribution
    index trunc of gradient_hessian_cl, bit for bit as jitted JAX computes it (XLA
    multiplies by the float32 reciprocal of the constant scale); a plain division
    differs on some of these lines."""
    s = scene
    intr, (fu, fv, ppu, ppv) = s["intr"], s["intr4"]
    _, _, cu, cv = s["jcrop"]
    jcfg = s["jpcfg"]
    jgeo = jax.jit(jax.vmap(lambda p, po, u, v: jrf.line_geometry(
        jcfg.cfg, scale, p, jnp.int32(L), po, fu, fv, ppu, ppv, intr.width, intr.height,
        u, v, jcfg.crop_size, jcfg.lp)))(s["jpoints"], jnp.asarray(s["pose"])[None], cu, cv)
    want = np.asarray(jgeo.normal_component_to_scale)
    _, tgeo = _geometries(s, scale)
    # Jitted JAX may round the normalized normal another way (XLA's rsqrt): the lines
    # whose normal_p is the same bits on both sides.
    same = _n(tgeo.normal_p) == np.asarray(jgeo.normal_p)
    assert same.sum() > L // 2
    np.testing.assert_array_equal(_n(tgeo.normal_component_to_scale)[same], want[same])
    monkeypatch.setattr(trf, "div_const", lambda x, n: x / n)
    _, plain = _geometries(s, scale)
    assert (_n(plain.normal_component_to_scale)[same] != want[same]).any()


@pytest.mark.parametrize("scale", [6, 2, 1])
def test_sample_lines_ratio_matches(scene, scale):
    s = scene
    jgeo, tgeo = _geometries(s, scale)
    bin_crop, bin_cropT, _, _ = s["jcrop"]
    j_tab, t_tab = _tables(s)
    kp = jrf.round_up(s["jpcfg"].cfg.line_length_in_segments * scale, 8)
    j_out = np.asarray(jrf.sample_lines(jgeo.params, bin_crop, bin_cropT, j_tab, kp))
    t_out = _n(trf.sample_lines(tgeo.params, _t(bin_crop), t_tab, kp))
    valid = np.asarray(jgeo.valid)[0]
    assert t_out.shape == j_out.shape and t_out.dtype == np.float32
    np.testing.assert_array_equal(t_out[0][:, valid], j_out[0][:, valid])


def _walks(scene):
    s = scene
    intr, (fu, fv, ppu, ppv) = s["intr"], s["intr4"]
    _, _, cu, cv = s["jcrop"]
    jcfg, tcfg = s["jpcfg"], s["tpcfg"]
    jparams, jmask = jax.vmap(lambda p, po, u, v: jrf.histogram_walk_geometry(
        jcfg.cfg, p, jnp.int32(L), po, fu, fv, ppu, ppv, intr.width, intr.height,
        u, v, jcfg.crop_size, 2 * jcfg.lp))(
            s["jpoints"], jnp.asarray(s["pose"])[None], cu, cv)
    tparams, tmask = trf.histogram_walk_geometry(
        tcfg.cfg, s["tpoints"], L, _t(s["pose"][None]), float(fu), float(fv),
        float(ppu), float(ppv), intr.width, intr.height, _t(cu), _t(cv),
        tcfg.crop_size, 2 * tcfg.lp)
    return (jparams, jmask), (tparams, tmask)


def test_histogram_walk_geometry_matches(scene):
    (jparams, jmask), (tparams, tmask) = _walks(scene)
    assert np.asarray(jmask).sum() > 100
    np.testing.assert_array_equal(_n(tmask), np.asarray(jmask))
    np.testing.assert_array_equal(_n(tparams), np.asarray(jparams))


def test_sample_lines_bins_matches(scene):
    s = scene
    (jparams, jmask), (tparams, _) = _walks(s)
    bin_crop, bin_cropT, _, _ = s["jcrop"]
    kp2 = jmask.shape[-1]
    j_tab, _ = _tables(s)
    j_out = np.asarray(jrf.sample_lines(jparams, bin_crop, bin_cropT, j_tab, kp2,
                                        output="bins"))
    t_out = _n(trf.sample_lines(tparams, _t(bin_crop), None, kp2, output="bins"))
    assert t_out.dtype == np.int32
    mask = np.swapaxes(np.asarray(jmask), 1, 2)                    # (B, kp2, lp2)
    np.testing.assert_array_equal(t_out[mask], j_out[mask])


@pytest.mark.parametrize("scale", [6, 2, 1])
def test_lines_from_samples_matches(scene, scale):
    s = scene
    jgeo, tgeo = _geometries(s, scale)
    j_tab, _ = _tables(s)
    bin_crop, bin_cropT, _, _ = s["jcrop"]
    kp = jrf.round_up(s["jpcfg"].cfg.line_length_in_segments * scale, 8)
    samples = jrf.sample_lines(jgeo.params, bin_crop, bin_cropT, j_tab, kp)
    jl = jax.vmap(lambda g, x: jrf.lines_from_samples(s["jpcfg"].cfg, scale, g, x))(
        jgeo, samples)
    tl = trf.lines_from_samples(s["tpcfg"].cfg, scale, tgeo, _t(samples))
    valid = np.asarray(jl.valid)
    np.testing.assert_array_equal(_n(tl.valid), valid)
    for name in ("distribution", "mean", "measured_variance"):
        np.testing.assert_allclose(_n(getattr(tl, name)), np.asarray(getattr(jl, name)),
                                   rtol=0, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("global_iteration", [True, False])
def test_gradient_hessian_matches(scene, global_iteration):
    s = scene
    scale, std = 2, 5.0
    fu, fv, ppu, ppv = s["intr4"]
    bin_crop, bin_cropT, cu, cv = s["jcrop"]
    j_tab, t_tab = _tables(s)
    poses = jnp.asarray(s["pose"])[None]
    jl = jpipe._region_terms(s["jpcfg"], s["intr4"], scale, s["jpoints"], poses,
                             jnp.int32(L), bin_crop, bin_cropT, j_tab, cu, cv,
                             s["intr"].width, s["intr"].height)
    g_j, h_j = jax.vmap(lambda ln, p: jrf.gradient_hessian_cl(
        s["jpcfg"].cfg, ln, p, fu, fv, ppu, ppv, std, global_iteration))(jl, poses)
    tl = tpipe._region_terms(s["tpcfg"], s["intr4"], scale, s["tpoints"],
                             _t(s["pose"][None]), L, _t(bin_crop), t_tab, _t(cu), _t(cv),
                             s["intr"].width, s["intr"].height)
    g_t, h_t = trf.gradient_hessian_cl(s["tpcfg"].cfg, tl, _t(s["pose"][None]),
                                       float(fu), float(fv), float(ppu), float(ppv),
                                       std, global_iteration)
    g_j, h_j = np.asarray(g_j), np.asarray(h_j)
    scale_g = max(np.abs(g_j).max(), 1e-6)
    scale_h = max(np.abs(h_j).max(), 1e-6)
    np.testing.assert_allclose(_n(g_t) / scale_g, g_j / scale_g, rtol=0, atol=2e-4)
    np.testing.assert_allclose(_n(h_t) / scale_h, h_j / scale_h, rtol=0, atol=2e-4)


def test_histogram_memories_match(scene):
    s = scene
    bin_crop, bin_cropT, cu, cv = s["jcrop"]
    poses = jnp.asarray(s["pose"])[None]
    j_f, j_b = jpipe._histogram_memories(
        s["jpcfg"], s["intr4"], s["jpoints"], poses, jnp.int32(L), bin_crop, bin_cropT,
        jnp.zeros((1, 32, 128), jnp.float32), cu, cv, s["intr"].width, s["intr"].height)
    t_f, t_b = tpipe._histogram_memories(
        s["tpcfg"], s["intr4"], s["tpoints"], _t(s["pose"][None]), L, _t(bin_crop),
        _t(cu), _t(cv), s["intr"].width, s["intr"].height)
    assert np.asarray(j_f).sum() > 100
    np.testing.assert_array_equal(_n(t_f), np.asarray(j_f))
    np.testing.assert_array_equal(_n(t_b), np.asarray(j_b))


@pytest.mark.parametrize("n_total,n", [(4096, 6144), (4096, 300), (512, 1000)])
def test_bin_counts_matches_numpy(rng, n_total, n):
    """The port's bin_counts == numpy bincount, incl. masking and odd sample counts."""
    bins = rng.integers(0, n_total, size=(5, n)).astype(np.int32)
    mask = rng.random((5, n)) > 0.3
    got = _n(trf.bin_counts(_t(bins), _t(mask), n_total))
    want = np.stack([np.bincount(bins[i][mask[i]], minlength=n_total).astype(np.float32)
                     for i in range(5)])
    np.testing.assert_array_equal(got, want)
    jgot = np.asarray(jrf.bin_counts(jnp.asarray(bins), jnp.asarray(mask), n_total))
    np.testing.assert_array_equal(got, jgot)
