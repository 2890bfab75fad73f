"""Divisions that decide a trunc, an integer cast or a comparison, against jitted JAX.

Jitted JAX (every cycle and modality of the JAX package) divides two ways.  By a
constant of the jitted function (a literal or a static config field) XLA multiplies by
the constant's float32 reciprocal; by a traced value (the intrinsics, the depth scale) it
divides, rounding once.  PyTorch divides by a Python number on the CPU and, on CUDA,
multiplies by the reciprocal of the number rounded to float32 from double; ``a / x`` for
a Python number ``a`` is ``x.reciprocal() * a`` on both.  Each differs from the other by
an ulp, which matters only where the quotient lands on the boundary of a trunc or a
comparison.  The port divides at such places through ``depth_fn.div_const`` (a constant
of the JAX function), ``div_value`` (a traced value) and ``rdiv`` (a Python numerator).

Each site's test builds inputs whose quotient lands on such a boundary (found by a
float32 search in numpy) and holds the port's discrete result equal to jitted JAX's;
with a plain ``/`` the same inputs give another result, which shows that they do land
on the boundary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from m3t_tpu import pipeline as jpipe
from m3t_tpu.ops import region_fast as jrf
from m3t_tpu.ops import region_fn as jrfn
from m3t_tpu_torch import pipeline as tpipe
from m3t_tpu_torch.ops import depth_fn as tdn
from m3t_tpu_torch.ops import region_fast as trf
from m3t_tpu_torch.ops import region_fn as trfn

F32 = np.float32


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _near(value, n_ulps: int):
    """The float32 values within n_ulps of value (positive), in order."""
    bits = np.asarray(value, F32).view(np.int32) + np.arange(-n_ulps, n_ulps + 1,
                                                             dtype=np.int32)
    return bits.view(F32)


def _fma(a, b, c):
    """a * b + c rounded once to float32, as XLA may contract it (the float64 product of
    two float32 values is exact)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _plain_division(monkeypatch):
    """Plain divisions in place of the helpers: ``x / c`` and ``a / x`` as PyTorch does
    them."""
    monkeypatch.setattr(tdn, "div_const", lambda x, n: x / n)
    monkeypatch.setattr(tdn, "div_value", lambda x, c: x / c)
    monkeypatch.setattr(trf, "div_const", lambda x, n: x / n)
    monkeypatch.setattr(trf, "rdiv", lambda a, x: a / x)


def test_helpers_divide_as_jitted_jax():
    x = np.random.default_rng(0).uniform(0.0, 100.0, 1 << 16).astype(F32)
    z = np.random.default_rng(1).uniform(0.2, 2.0, 1 << 16).astype(F32)
    for c in (6.0, 7.0, 5.0, 3.6, 0.001, 520.0):
        by_constant = np.asarray(jax.jit(lambda x, c=c: x / c)(x))
        by_value = np.asarray(jax.jit(lambda x, c: x / c)(x, F32(c)))
        np.testing.assert_array_equal(tdn.div_const(_t(x), c).numpy(), by_constant)
        np.testing.assert_array_equal(tdn.div_value(_t(x), c).numpy(), by_value)
        assert (by_constant != by_value).any()
        numerator = np.asarray(jax.jit(lambda z, c: c / z)(z, F32(c)))
        np.testing.assert_array_equal(tdn.rdiv(c, _t(z)).numpy(), numerator)


def test_adaptive_line_count_matches_jitted_jax(monkeypatch):
    """pipeline._adaptive_n_lines: int(n_lines_max * min(contour / reference, 1)) with a
    reference contour length of 3 (a static config field in JAX)."""
    ref, n_max = 3.0, 200
    candidates = np.concatenate([_near(F32(k * ref / n_max), 64) for k in range(1, n_max)])
    by_division = np.trunc(F32(n_max) * np.minimum(candidates / F32(ref), F32(1)))
    by_product = np.trunc(F32(n_max) * np.minimum(candidates * (F32(1) / F32(ref)), F32(1)))
    lengths = candidates[by_division != by_product][:32]
    assert len(lengths) == 32
    b, v = len(lengths), 4
    rng = np.random.default_rng(2)
    orientations = rng.normal(size=(b, v, 3)).astype(F32)
    orientations /= np.linalg.norm(orientations, axis=-1, keepdims=True)
    arrays = dict(orientations=orientations,
                  centers=np.zeros((b, v, 3, n_max), F32),
                  normals=np.zeros((b, v, 3, n_max), F32),
                  foreground_distances=np.zeros((b, v, n_max), F32),
                  background_distances=np.zeros((b, v, n_max), F32),
                  measured_depth_offsets=np.zeros((b, v, n_max), F32),
                  modeled_depth_offsets=np.zeros((b, v, n_max), F32),
                  contour_lengths=np.repeat(lengths[:, None], v, axis=1),
                  max_contour_length=lengths.copy())
    poses = np.tile(np.eye(4, dtype=F32), (b, 1, 1))
    poses[:, 2, 3] = 0.6
    jpcfg = jpipe.PipelineConfig(use_adaptive_coverage=True, reference_contour_length=ref)
    tpcfg = tpipe.PipelineConfig(use_adaptive_coverage=True, reference_contour_length=ref)
    want = np.asarray(jax.jit(jpipe._adaptive_n_lines, static_argnums=0)(
        jpcfg, jpipe.RegionModelArrays(**{k: jnp.asarray(a) for k, a in arrays.items()}),
        jnp.asarray(poses)))
    tmodel = tpipe.RegionModelArrays.from_numpy(arrays, device="cpu")
    np.testing.assert_array_equal(tpipe._adaptive_n_lines(tpcfg, tmodel, _t(poses)).numpy(),
                                  want)
    _plain_division(monkeypatch)
    assert (tpipe._adaptive_n_lines(tpcfg, tmodel, _t(poses)).numpy() != want).any()


def _region_check_inputs(pkg, scale, n_lines):
    b = len(scale)
    fields = dict(silhouette=np.ones((b, 64, 64), np.int32),
                  corner_u=np.zeros(b, F32), corner_v=np.zeros(b, F32), scale=scale,
                  region_id=np.ones(b, np.int32), body_visible=np.ones(b, bool))
    if pkg == "jax":
        return jrfn.RegionCheckInputs(**{k: jnp.asarray(a) for k, a in fields.items()})
    return trfn.RegionCheckInputs(**{k: _t(a) for k, a in fields.items()})


def test_region_check_strides_match_jitted_jax(monkeypatch):
    """region_fn._region_check_grid: the focused stride (min_cd * scale - 2) / 5, and the
    sample pixels trunc(center + (2 + i * stride)) of lines along u.  The samples are
    chosen where XLA's contraction of a product and a sum into one rounding does not
    change them."""
    cfg_j, cfg_t = jrfn.RegionConfig(), trfn.RegionConfig()
    # Scales whose last offset 2 + 5 * stride (54-61 px) and the sample 62 share the
    # binade [32, 64), so that an ulp of the stride shows in the sample.
    scales = np.random.default_rng(3).uniform(18.0, 20.4, 4096).astype(F32)
    x = F32(cfg_t.min_continuous_distance) * scales - F32(2.0)
    strides = {"division": x / F32(5.0), "product": x * (F32(1) / F32(5.0))}
    centers, kept = [], []
    for b, s in enumerate(scales):
        near = _near(F32((62.0 - 2.0 - 5.0 * strides["product"][b] - 0.5) / s), 512)
        fcus = (F32(0.5) + near * s, _fma(near, s, F32(0.5)))
        samples = {}
        for name, stride in strides.items():
            offs = (F32(2.0) + F32(5.0) * stride[b], _fma(F32(5.0), stride[b], F32(2.0)))
            samples[name] = [np.trunc(fcu + off) for fcu in fcus for off in offs]
        same = np.all([t == samples["product"][0] for t in samples["product"]], axis=0)
        flips = near[same & (samples["division"][0] != samples["product"][0])]
        if len(flips) >= 2:
            centers.append(flips[:2])
            kept.append(s)
    assert len(centers) >= 8
    centers, scales = np.stack(centers[:8]), np.array(kept[:8], F32)
    b, n = centers.shape
    normal_u, normal_v = np.ones((b, n), F32), np.zeros((b, n), F32)
    center_v = np.full((b, n), 20.0, F32)
    chk = _region_check_inputs("jax", scales, n)
    want = jax.jit(jax.vmap(lambda cu, cv, nu, nv, c: jrfn._region_check_grid(
        cfg_j, 1.0, cu, cv, nu, nv, c, 128)))(centers, center_v, normal_u, normal_v, chk)
    args = (cfg_t, 1.0, _t(centers), _t(center_v), _t(normal_u), _t(normal_v),
            _region_check_inputs("torch", scales, n), 128)
    got = trfn._region_check_grid(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _plain_division(monkeypatch)
    assert any((g.numpy() != np.asarray(w)).any()
               for g, w in zip(trfn._region_check_grid(*args), want))


def test_dynamic_region_distance_matches_jitted_jax(monkeypatch):
    """region_fn.dynamic_region_distance: the first sample i_start = trunc((2 / scale -
    0.5) / stride + 1) with the stride 18 / 5 = 3.6 of a maximum line length of 18 (a
    static config field in JAX); lines far outside the crop stop at i_start, so the
    foreground distance is stride * i_start."""
    cfg_j = jrfn.RegionConfig(max_considered_line_length=18.0)
    cfg_t = trfn.RegionConfig(max_considered_line_length=18.0)
    stride = F32(18.0 / 5)
    # (2 / scale - 0.5) / stride just below 3 or 5, where + 1 keeps its ulp: i_start 3
    # or 4, 5 or 6 (no sample).
    scales = np.concatenate([_near(F32(2.0 / (0.5 + k * 3.6)), 20000) for k in (3, 5)])
    delta = F32(2.0) / scales - F32(0.5)
    by_division = np.trunc(delta / stride + F32(1))
    by_product = np.trunc(delta * (F32(1) / stride) + F32(1))
    contracted = np.trunc(_fma(delta, F32(1) / stride, F32(1)))
    scales = scales[(by_division != by_product) & (by_product == contracted)]
    assert len(scales) >= 1
    b, n = len(scales), 4
    center_u = np.full((b, n), -1000.0, F32)
    center_v = np.full((b, n), 30.0, F32)
    normal_u, normal_v = np.ones((b, n), F32), np.zeros((b, n), F32)
    want = jax.jit(jax.vmap(lambda cu, cv, nu, nv, c: jrfn.dynamic_region_distance(
        cfg_j, cu, cv, nu, nv, c, 64)))(center_u, center_v, normal_u, normal_v,
                                        _region_check_inputs("jax", scales, n))
    args = (cfg_t, _t(center_u), _t(center_v), _t(normal_u), _t(normal_v),
            _region_check_inputs("torch", scales, n), 64)
    for g, w in zip(trfn.dynamic_region_distance(*args), want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _plain_division(monkeypatch)
    assert any((g.numpy() != np.asarray(w)).any()
               for g, w in zip(trfn.dynamic_region_distance(*args), want))


def _lines(pkg, center_f_body, normal_component_to_scale):
    """One valid lane per body (lane 0 of 128) along u: centre (0, 0) in the image,
    delta_r 0, a distribution rising over its 12 bins."""
    b, lp, d = center_f_body.shape[0], 128, 12
    dist = np.broadcast_to((np.arange(d, dtype=F32) + 1) / F32(78.0), (b, lp, d))
    fields = dict(
        center_f_body=np.zeros((b, 3, lp), F32), center_u=np.zeros((b, lp), F32),
        center_v=np.zeros((b, lp), F32), normal_u=np.ones((b, lp), F32),
        normal_v=np.zeros((b, lp), F32), delta_r=np.zeros((b, lp), F32),
        normal_component_to_scale=np.ones((b, lp), F32),
        distribution=np.ascontiguousarray(np.swapaxes(dist, 1, 2)),
        mean=np.zeros((b, lp), F32), measured_variance=np.ones((b, lp), F32),
        valid=np.arange(lp)[None].repeat(b, 0) == 0)
    fields["center_f_body"][:, :, 0] = center_f_body
    fields["normal_component_to_scale"][:, 0] = normal_component_to_scale
    if pkg == "jax":
        return jrf.DataLinesCL(**{k: jnp.asarray(a) for k, a in fields.items()})
    return trf.DataLinesCL(**{k: _t(a) for k, a in fields.items()})


def test_distribution_index_matches_jitted_jax(monkeypatch):
    """region_fast.gradient_hessian_cl: the distribution index trunc(delta_cs + 6.5) of
    a local iteration, delta_cs = (x * (fu / z) - center_u) * normal_component_to_scale,
    where JAX divides fu, a traced value, by z.  At index 0 the line leaves the
    distribution and adds nothing to the gradient."""
    fu = F32(520.0)
    # Points (x, 0, z) with x * fu / z at -5.5: the index trunc(1 -+ an ulp) is 1 (in
    # range) or 0.
    zs = _near(F32(0.6), 2000)
    by_division, by_product = fu / zs, (F32(1) / zs) * fu
    points = []
    for z, a, b in zip(zs, by_division, by_product):
        xs = _near(F32(-5.5) / a, 8)
        flips = xs[np.trunc(xs * a + F32(6.5)) != np.trunc(xs * b + F32(6.5))]
        points += [(x, 0.0, z) for x in flips[:1]]
    points = np.array(points[:16], F32)
    assert len(points) == 16
    nts = np.ones(len(points), F32)
    poses = np.tile(np.eye(4, dtype=F32), (len(points), 1, 1))
    want_g, want_h = jax.jit(jax.vmap(lambda ln, p: jrf.gradient_hessian_cl(
        jrfn.RegionConfig(), ln, p, fu, fu, F32(0.0), F32(0.0), 5.0, False)))(
        _lines("jax", points, nts), jnp.asarray(poses))
    args = (trfn.RegionConfig(), _lines("torch", points, nts), _t(poses), float(fu),
            float(fu), 0.0, 0.0, 5.0, False)
    g, h = trf.gradient_hessian_cl(*args)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-6)
    _plain_division(monkeypatch)
    moved = np.abs(np.asarray(want_g)).max(axis=1) > 0
    plain = np.abs(trf.gradient_hessian_cl(*args)[0].numpy()).max(axis=1) > 0
    assert (plain != moved).any()
