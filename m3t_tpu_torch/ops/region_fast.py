"""Region-modality fast path on PyTorch/CUDA (port of m3t_tpu/ops/region_fast.py).

Two hand-written Hopper kernels (``csrc/region_kernels.cu``) replace the two Pallas
kernels of the region cycle: :func:`sample_lines` (staircase line sampling) and
:func:`bin_counts` (masked histogram counts).  Each wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch twin (``*_plain``) for CPU tensors; there is no
fallback from one to the other.

The glue keeps the JAX module's lane-major layout with the ``vmap`` written out as a
leading batch dimension:
  line params   (B, NPARAM=8, LP)   LP = padded line count (multiple of 128)
  samples       (B, KP, LP)         KP = padded line length (multiple of 8)
  model points  (B, 3, L)
The TPU-only transposed crop copy (``bin_cropT``) is gone: the GPU indexes the crop in
either direction.

Numerics: every expression is evaluated in the JAX source's written order with one
rounding per operation (PyTorch runs each operation as its own kernel, so nothing is
contracted into a fused multiply-add on either device).  XLA on the CPU contracts some
``a * b + c`` sites depending on how it fuses them, so a float parameter can differ from
the JAX package's in the last bit on rare lines; the integer results built from them
(validity, walk masks, bins) are what the parity tests hold exactly.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from m3t_tpu_torch.ops import _cuda
from m3t_tpu_torch.ops._cuda import require as _require
from m3t_tpu_torch.ops import region_fn as rfn
from m3t_tpu_torch.ops.depth_fn import div_const, rdiv
from m3t_tpu_torch.ops.region_fn import MeasuredOcclusionInputs, RegionConfig

# Parameter-row indices of the staircase kernel input (region_fast.py:45-50).
_ROW_R0 = 0     # dominant-axis start, crop coords (integer-valued f32)
_ROW_S0 = 1     # secondary-axis affine offset at k == 0, crop coords (f32)
_ROW_STEP = 2   # secondary-axis slope per dominant-axis step (f32)
_ROW_UDOM = 3   # 1.0 if the u axis is dominant
_ROW_DIR = 4    # dominant-axis direction (+1 / -1) per step
_NPARAM = 8


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ----------------------------------------------------------------------------------------
# Crop extraction / binning
# ----------------------------------------------------------------------------------------


def crop_corners(center_u, center_v, crop_size: int, width: int, height: int):
    """Top-left crop corner per body so the crop stays inside the image (int32)."""
    cu = torch.clamp(torch.round(center_u).to(torch.int32) - crop_size // 2,
                     0, max(width - crop_size, 0))
    cv = torch.clamp(torch.round(center_v).to(torch.int32) - crop_size // 2,
                     0, max(height - crop_size, 0))
    return cu, cv


def binify_crops(images_planar, corner_u, corner_v, crop_size: int, n_bins: int):
    """Per-body (C, C) crops of planar (B, 3, H, W) uint8 images as flat histogram-bin
    indices (reference bitshift scheme, color_histograms.cpp:61-69).  Returns
    bin_crop (B, C, C) int32."""
    shift = 8 - (n_bins.bit_length() - 1)
    dev = images_planar.device
    ar = torch.arange(crop_size, device=dev)
    rows = (corner_v.long()[:, None] + ar)[:, :, None]            # (B, C, 1)
    cols = (corner_u.long()[:, None] + ar)[:, None, :]            # (B, 1, C)
    body = torch.arange(images_planar.shape[0], device=dev)[:, None, None]
    bins = None
    for ch, weight in enumerate((n_bins * n_bins, n_bins, 1)):
        c = images_planar[:, ch][body, rows, cols].to(torch.int32) >> shift
        bins = c * weight if bins is None else bins + c * weight
    return bins


def ratio_table(hist_f, hist_b):
    """Per-bin normalized foreground probability (region_modality.cpp:1575-1598):
    (B, n_bins^3) f32, 0.5 where both histograms are empty."""
    total = hist_f + hist_b
    nz = total > 0.0
    return torch.where(nz, hist_f / torch.where(nz, total, torch.ones_like(total)),
                       torch.full_like(total, 0.5))


# ----------------------------------------------------------------------------------------
# Kernel 1: staircase line sampling
# ----------------------------------------------------------------------------------------


def _check_sample_inputs(params, bin_crop, table, output):
    _require(output in ("ratio", "bins"), f"output must be 'ratio' or 'bins', not {output!r}")
    _require(params.dtype == torch.float32 and params.dim() == 3
             and params.shape[1] == _NPARAM, "params must be (B, 8, LP) float32")
    b = params.shape[0]
    _require(bin_crop.dtype == torch.int32 and bin_crop.dim() == 3
             and bin_crop.shape[0] == b and bin_crop.shape[1] == bin_crop.shape[2],
             "bin_crop must be (B, C, C) int32")
    devices = {params.device, bin_crop.device}
    if output == "ratio":
        _require(table is not None and table.dtype == torch.float32 and table.dim() == 2
                 and table.shape[0] == b, "table must be (B, n_bins^3) float32")
        devices.add(table.device)
    _require(len(devices) == 1, f"inputs on different devices: {devices}")


def clamp_index(x, c: int):
    """Crop index of float coordinates: clamp to [0, c-1] in float (NaN -> 0), then
    truncate, as the kernels do."""
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, c - 1).to(torch.int64)


def staircase_index(params, c: int, kp: int):
    """(B, kp, LP) int64 flat index into the (B, C, C) crops of every staircase sample:
    the address arithmetic of the sample_lines kernel, in the same order."""
    b = params.shape[0]
    r0 = params[:, _ROW_R0, None, :]                               # (B, 1, LP)
    s0 = params[:, _ROW_S0, None, :]
    stp = params[:, _ROW_STEP, None, :] * params[:, _ROW_DIR, None, :]
    udom = params[:, _ROW_UDOM, None, :] > 0.5
    k = torch.arange(kp, dtype=torch.float32, device=params.device)[None, :, None]

    i = clamp_index(r0 + params[:, _ROW_DIR, None, :] * k, c)     # (B, kp, LP)
    col = clamp_index(torch.floor(s0 + (i.to(torch.float32) - r0) * stp), c)
    body = torch.arange(b, device=params.device)[:, None, None] * (c * c)
    return body + torch.where(udom, col * c + i, i * c + col)


def sample_lines_plain(params, bin_crop, table, kp: int, output: str = "ratio"):
    """Plain PyTorch twin of the sample_lines kernel (same arithmetic, same order)."""
    _check_sample_inputs(params, bin_crop, table, output)
    b, _, lp = params.shape
    bins = bin_crop.reshape(-1)[staircase_index(params, bin_crop.shape[-1], kp)]
    if output == "bins":
        return bins
    return torch.gather(table, 1, bins.reshape(b, -1).to(torch.int64)).reshape(b, kp, lp)


@_cuda.kernel("m3t_sample_lines", [_cuda.PTR] * 4 + [_cuda.INT] * 6)
def sample_lines(params, bin_crop, table, kp: int, output: str = "ratio"):
    """Batched staircase line sampling.

    params: (B, 8, LP) f32 line parameters (rows _ROW_*).
    bin_crop: (B, C, C) int32 flat histogram-bin crops.
    table: (B, n_bins^3) f32 per-bin values (unused, may be None, when output == 'bins').
    Returns (B, kp, LP): f32 ratio samples, or int32 bin indices.
    """
    if params.device.type == "cpu":
        return sample_lines_plain(params, bin_crop, table, kp, output)
    _check_sample_inputs(params, bin_crop, table, output)
    _require(params.device.type == "cuda", f"unsupported device {params.device}")
    ratio = output == "ratio"
    tensors = [params, bin_crop] + ([table] if ratio else [])
    _require(all(t.is_contiguous() for t in tensors), "sample_lines inputs must be contiguous")
    b, _, lp = params.shape
    c = bin_crop.shape[-1]
    _require(b > 0 and kp > 0, "sample_lines: need B > 0 and kp > 0")
    n_table = table.shape[1] if ratio else 0
    _require(n_table * 4 <= 227 * 1024, "ratio table exceeds a block's shared memory")
    # The kernel brings each body's table in with one bulk copy: 16-byte units.
    _require(not ratio or (n_table % 4 == 0 and table.data_ptr() % 16 == 0),
             "ratio table rows must be 16-byte aligned multiples of 4 floats")
    out = torch.empty((b, kp, lp), dtype=torch.float32 if ratio else torch.int32,
                      device=params.device)
    _cuda.launch("m3t_sample_lines", params.device, params.data_ptr(), bin_crop.data_ptr(),
                 table.data_ptr() if ratio else None, out.data_ptr(), b, lp, kp, c,
                 n_table, int(ratio))
    return out


# ----------------------------------------------------------------------------------------
# Kernel 2: masked histogram counts
# ----------------------------------------------------------------------------------------


def _check_count_inputs(bins, mask, n_bins_total):
    _require(bins.dtype == torch.int32 and bins.dim() == 2, "bins must be (B, N) int32")
    _require(mask.dtype == torch.bool and mask.shape == bins.shape,
             "mask must be a bool tensor shaped like bins")
    _require(mask.device == bins.device, "bins and mask on different devices")
    _require(n_bins_total > 0, "n_bins_total must be positive")


def bin_counts_plain(bins, mask, n_bins_total: int = 4096):
    """Plain PyTorch twin of the bin_counts kernel: masked samples and bins outside
    [0, n_bins_total) go to a sentinel column that is dropped."""
    _check_count_inputs(bins, mask, n_bins_total)
    keep = mask & (bins >= 0) & (bins < n_bins_total)
    idx = torch.where(keep, bins, torch.full_like(bins, n_bins_total)).to(torch.int64)
    counts = torch.zeros((bins.shape[0], n_bins_total + 1), dtype=torch.float32,
                         device=bins.device)
    counts.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float32))
    return counts[:, :n_bins_total].contiguous()


@_cuda.kernel("m3t_bin_counts", [_cuda.PTR] * 3 + [_cuda.INT] * 3)
def bin_counts(bins, mask, n_bins_total: int = 4096):
    """Masked histogram counts: bins (B, N) int32, mask (B, N) bool ->
    (B, n_bins_total) f32, counts[b, j] = #{n : mask[b, n] and bins[b, n] == j}."""
    if bins.device.type == "cpu":
        return bin_counts_plain(bins, mask, n_bins_total)
    _check_count_inputs(bins, mask, n_bins_total)
    _require(bins.device.type == "cuda", f"unsupported device {bins.device}")
    _require(bins.is_contiguous() and mask.is_contiguous(),
             "bin_counts inputs must be contiguous")
    _require(n_bins_total * 4 <= 227 * 1024, "histogram exceeds a block's shared memory")
    b, n = bins.shape
    out = torch.empty((b, n_bins_total), dtype=torch.float32, device=bins.device)
    if b == 0:
        return out
    _cuda.launch("m3t_bin_counts", bins.device, bins.data_ptr(), mask.data_ptr(),
                 out.data_ptr(), b, n, n_bins_total)
    return out


# ----------------------------------------------------------------------------------------
# Lane-major per-frame glue (batched over bodies)
# ----------------------------------------------------------------------------------------


class ViewPointsCL(NamedTuple):
    """Channel-major gathered model points for a batch of bodies."""

    center_f_body: torch.Tensor       # (B, 3, L)
    normal_f_body: torch.Tensor       # (B, 3, L)
    foreground_distance: torch.Tensor  # (B, L)
    background_distance: torch.Tensor  # (B, L)
    measured_depth_offset: torch.Tensor  # (B, L)
    modeled_depth_offset: torch.Tensor   # (B, L)


class LineGeometry(NamedTuple):
    """Per-line projection results and staircase parameters (all (B, LP))."""

    center_u: torch.Tensor
    center_v: torch.Tensor
    normal_u: torch.Tensor
    normal_v: torch.Tensor
    center_f_body: torch.Tensor       # (B, 3, LP)
    normal_p: torch.Tensor
    delta_r: torch.Tensor
    normal_component_to_scale: torch.Tensor
    params: torch.Tensor              # (B, 8, LP) kernel input
    valid: torch.Tensor               # (B, LP) bool


class DataLinesCL(NamedTuple):
    """Lane-major correspondence state for a batch of bodies."""

    center_f_body: torch.Tensor       # (B, 3, LP)
    center_u: torch.Tensor            # (B, LP)
    center_v: torch.Tensor
    normal_u: torch.Tensor
    normal_v: torch.Tensor
    delta_r: torch.Tensor
    normal_component_to_scale: torch.Tensor
    distribution: torch.Tensor        # (B, D, LP)
    mean: torch.Tensor                # (B, LP)
    measured_variance: torch.Tensor   # (B, LP)
    valid: torch.Tensor               # (B, LP) bool


def _pad_lanes(x, lp):
    pad = lp - x.shape[-1]
    if pad <= 0:
        return x
    out = x.new_zeros(x.shape[:-1] + (lp,))
    out[..., :x.shape[-1]] = x
    return out


def _line_mask(n_lines, count: int, device):
    """(B or 1, count) bool: line index < n_lines (a Python int or a (B,) tensor)."""
    idx = torch.arange(count, device=device)[None, :]
    if isinstance(n_lines, torch.Tensor):
        return idx < n_lines[:, None]
    return idx < n_lines


def project_lines_cl(points: ViewPointsCL, pose, fu, fv, ppu, ppv):
    """Channel-major region_fn._project_lines (cpp:1231-1250) for the batch."""
    rot = pose[:, :3, :3]
    center_cam = rot @ points.center_f_body + pose[:, :3, 3, None]   # (B, 3, L)
    z = center_cam[:, 2]
    z_safe = torch.where(z > 0.0, z, torch.ones_like(z))
    center_u = center_cam[:, 0] * fu / z_safe + ppu
    center_v = center_cam[:, 1] * fv / z_safe + ppv
    normal_xy = rot[:, :2] @ points.normal_f_body                     # (B, 2, L)
    nu, nv = normal_xy[:, 0], normal_xy[:, 1]
    norm = torch.sqrt(nu * nu + nv * nv)
    safe = torch.where(norm > 0.0, norm, torch.ones_like(norm))
    return z, center_u, center_v, nu / safe, nv / safe


def line_geometry(cfg: RegionConfig, scale: int, points: ViewPointsCL, n_lines,
                  pose, fu, fv, ppu, ppv, width: int, height: int,
                  corner_u, corner_v, crop_size: int, lp: int,
                  region_check=None,
                  measured_occlusion: MeasuredOcclusionInputs | None = None,
                  modeled_occlusion=None, handle_occlusions=None) -> LineGeometry:
    """Project model points and derive staircase parameters + validity (region_fast.py
    :309-442): IsLineValid plus the requirement that every sampled pixel lies inside
    the (C, C) crop.

    Region checking (``region_check``: region_fn.RegionCheck[Query]Inputs) folds into
    the validity (cpp:1293-1341).  Measured occlusions (depth images) and modeled
    occlusions (``modeled_occlusion``: region_fn.ModeledOcclusion[Query]Inputs, the
    focused scene) AND into one mask that goes through the reference's two-pass
    fallback (cpp:435-463): occlusion handling is off for a body whose
    ``handle_occlusions`` (B,) bool is False (None means True for all), or when fewer
    than ``cfg.min_n_unoccluded_lines`` lines would survive.  When both scene checks
    come as queries (the pipeline's default) they share one query evaluation."""
    s_seg = cfg.line_length_in_segments
    line_length = s_seg * scale
    fscale = float(scale)
    ll_minus_1 = line_length - 1
    ll_minus_1_half = (line_length - 1) * 0.5
    ll_half_minus_1 = line_length * 0.5 - 1.0

    z, center_u, center_v, normal_u, normal_v = project_lines_cl(
        points, pose, fu, fv, ppu, ppv)
    lcount = center_u.shape[-1]
    ones = torch.ones_like(z)

    z_pos = torch.where(z > 0, z, ones)
    continuous_distance = (
        torch.minimum(points.background_distance, points.foreground_distance)
        * fu / (z_pos * fscale))
    valid = _line_mask(n_lines, lcount, z.device) & (z > 0.0)
    valid = valid & (continuous_distance >= cfg.min_continuous_distance)
    i_cu = torch.trunc(center_u + 0.5).to(torch.int32)
    i_cv = torch.trunc(center_v + 0.5).to(torch.int32)
    valid = valid & (i_cu >= 0) & (i_cu <= width - 1) & (i_cv >= 0) & (i_cv <= height - 1)

    is_u_dom = torch.abs(normal_v) < torch.abs(normal_u)
    normal_p = torch.where(is_u_dom, normal_u, normal_v)
    normal_s = torch.where(is_u_dom, normal_v, normal_u)
    center_p = torch.where(is_u_dom, center_u, center_v)
    center_s = torch.where(is_u_dom, center_v, center_u)
    size_p = torch.where(is_u_dom, width, height)
    size_s = torch.where(is_u_dom, height, width)
    normal_ok = torch.abs(normal_p) > 0.0
    valid = valid & normal_ok
    safe_normal_p = torch.where(normal_ok, normal_p, ones)
    step = normal_s / safe_normal_p

    p0 = torch.trunc(center_p - ll_half_minus_1).to(torch.int32)
    p_end = p0 + ll_minus_1
    s_f0 = center_s + step * (p0.to(torch.float32) - center_p) + 0.5
    s_f_end = s_f0 + step * float(ll_minus_1)
    t0 = torch.trunc(s_f0).to(torch.int32)
    t_end = torch.trunc(s_f_end).to(torch.int32)
    valid = valid & ((p0 >= 0) & (p_end <= size_p - 1)
                     & (t0 >= 0) & (t0 <= size_s - 1)
                     & (t_end >= 1) & (t_end <= size_s - 2))

    # Crop coverage: every sampled pixel must fall inside the (C, C) crop.
    corner_p = torch.where(is_u_dom, corner_u[:, None], corner_v[:, None])
    corner_s = torch.where(is_u_dom, corner_v[:, None], corner_u[:, None])
    s_lo = torch.minimum(t0, t_end)
    s_hi = torch.maximum(t0, t_end)
    valid = valid & ((p0 >= corner_p) & (p_end <= corner_p + crop_size - 1)
                     & (s_lo >= corner_s) & (s_hi <= corner_s + crop_size - 1))

    rc_query = isinstance(region_check, rfn.RegionCheckQueryInputs)
    mo_query = isinstance(modeled_occlusion, rfn.ModeledOcclusionQueryInputs)
    combined_rc = combined_mo = None
    if ((rc_query or mo_query) and (region_check is None or rc_query)
            and (modeled_occlusion is None or mo_query)):
        combined_rc, combined_mo = rfn.combined_scene_checks(
            cfg, fscale, center_u, center_v, normal_u, normal_v, z,
            points.modeled_depth_offset, fu, region_check, modeled_occlusion)
    if region_check is not None:
        if combined_rc is None:
            combined_rc = rfn.region_check_ok(
                cfg, fscale, center_u, center_v, normal_u, normal_v, region_check,
                region_check.silhouette.shape[-1])
        valid = valid & combined_rc
    occl_ok = torch.ones_like(valid)
    if measured_occlusion is not None:
        depth_image = measured_occlusion.depth_image
        occl_ok = occl_ok & rfn._measured_occlusion_free(
            cfg, points.center_f_body.transpose(1, 2), points.measured_depth_offset,
            measured_occlusion, depth_image.shape[2], depth_image.shape[1])
    if modeled_occlusion is not None:
        if combined_mo is None:
            combined_mo = rfn.modeled_occlusion_free(
                cfg, center_u, center_v, z, points.modeled_depth_offset, fu,
                modeled_occlusion, modeled_occlusion.focused_depth.shape[-1])
        occl_ok = occl_ok & combined_mo
    if measured_occlusion is not None or modeled_occlusion is not None:
        valid_with = valid & occl_ok
        use_occlusions = valid_with.sum(dim=-1, keepdim=True) >= cfg.min_n_unoccluded_lines
        if handle_occlusions is not None:
            use_occlusions = use_occlusions & handle_occlusions[:, None]
        valid = torch.where(use_occlusions, valid_with, valid)

    normal_component_to_scale = div_const(torch.abs(normal_p), fscale)
    delta_r = (torch.floor(center_p - ll_minus_1_half + 0.5) + ll_minus_1_half
               - center_p) / safe_normal_p

    b = z.shape[0]
    params = torch.zeros((b, _NPARAM, lp), dtype=torch.float32, device=z.device)
    params[:, _ROW_R0, :lcount] = (p0 - corner_p).to(torch.float32)
    params[:, _ROW_S0, :lcount] = s_f0 - corner_s.to(torch.float32)
    params[:, _ROW_STEP, :lcount] = step
    params[:, _ROW_UDOM, :lcount] = is_u_dom.to(torch.float32)
    params[:, _ROW_DIR] = 1.0

    return LineGeometry(
        center_u=_pad_lanes(center_u, lp), center_v=_pad_lanes(center_v, lp),
        normal_u=_pad_lanes(normal_u, lp), normal_v=_pad_lanes(normal_v, lp),
        center_f_body=_pad_lanes(points.center_f_body, lp),
        normal_p=_pad_lanes(normal_p, lp),
        delta_r=_pad_lanes(delta_r, lp),
        normal_component_to_scale=_pad_lanes(normal_component_to_scale, lp),
        params=params, valid=_pad_lanes(valid, lp))


def lines_from_samples(cfg: RegionConfig, scale: int, geo: LineGeometry,
                       ratio_samples) -> DataLinesCL:
    """Segment products -> distribution -> moments (cpp:1458-1658), lane-major.

    ratio_samples: (B, KP, LP) normalized foreground probabilities from sample_lines.
    """
    s_seg = cfg.line_length_in_segments
    d = cfg.distribution_length
    f = cfg.function_length
    line_length = s_seg * scale
    b, _, lp = ratio_samples.shape

    lookup_f, lookup_b = cfg.function_lookups()

    pf = ratio_samples[:, :line_length, :]
    pb = 1.0 - pf
    # (B, S, scale, LP) -> per-segment products (cpp:1458-1489); lines stay last.
    seg_f = torch.prod(pf.reshape(b, s_seg, scale, lp), dim=2)
    seg_b = torch.prod(pb.reshape(b, s_seg, scale, lp), dim=2)
    forward = (geo.normal_p > 0)[:, None, :]
    seg_f = torch.where(forward, seg_f, torch.flip(seg_f, dims=(1,)))
    seg_b = torch.where(forward, seg_b, torch.flip(seg_b, dims=(1,)))
    if scale > 1:
        total = seg_f + seg_b
        nzero = total > 0.0
        safe = torch.where(nzero, total, torch.ones_like(total))
        half = torch.full_like(total, 0.5)
        seg_f = torch.where(nzero, seg_f / safe, half)
        seg_b = torch.where(nzero, seg_b / safe, half)

    # distribution[d] = prod_i seg_f[d+i]*lf[i] + seg_b[d+i]*lb[i]  (cpp:1600-1637)
    dist = torch.ones((b, d, lp), dtype=torch.float32, device=pf.device)
    for i in range(f):
        dist = dist * (seg_f[:, i:i + d] * float(lookup_f[i])
                       + seg_b[:, i:i + d] * float(lookup_b[i]))
    area = torch.sum(dist, dim=1, keepdim=True)
    dist = dist / torch.where(area > 0.0, area, torch.ones_like(area))

    idx = torch.arange(d, dtype=torch.float32, device=pf.device)[None, :, None]
    mean_from_begin = torch.sum(idx * dist, dim=1)
    var = torch.sum((idx - mean_from_begin[:, None, :]) ** 2 * dist, dim=1)
    mean = mean_from_begin - (d - 1) / 2.0
    measured_variance = torch.clamp(var, min=cfg.min_expected_variance)

    return DataLinesCL(
        center_f_body=geo.center_f_body,
        center_u=geo.center_u, center_v=geo.center_v,
        normal_u=geo.normal_u, normal_v=geo.normal_v,
        delta_r=geo.delta_r,
        normal_component_to_scale=geo.normal_component_to_scale,
        distribution=dist, mean=mean, measured_variance=measured_variance,
        valid=geo.valid)


def gradient_hessian_cl(cfg: RegionConfig, lines: DataLinesCL, pose,
                        fu, fv, ppu, ppv, standard_deviation: float,
                        global_iteration: bool):
    """Lane-major Newton gradient/Hessian (cpp:485-558); returns ((B, 6), (B, 6, 6))."""
    d = cfg.distribution_length
    rot = pose[:, :3, :3]
    variance = standard_deviation ** 2

    c = rot @ lines.center_f_body + pose[:, :3, 3, None]            # (B, 3, LP)
    x, y, z = c[:, 0], c[:, 1], c[:, 2]
    z_safe = torch.where(z != 0, z, torch.ones_like(z))
    fu_z = rdiv(fu, z_safe)
    fv_z = rdiv(fv, z_safe)
    xfu_z = x * fu_z
    yfv_z = y * fv_z
    delta_cs = (lines.normal_u * (xfu_z + ppu - lines.center_u)
                + lines.normal_v * (yfv_z + ppv - lines.center_v)
                - lines.delta_r) * lines.normal_component_to_scale

    if global_iteration:
        dll = (lines.mean - delta_cs) / lines.measured_variance
        valid = lines.valid
    else:
        dist_idx_upper = torch.trunc(delta_cs + (d + 1) / 2.0).to(torch.int64)
        dist_idx_lower = dist_idx_upper - 1
        in_range = (dist_idx_upper > 0) & (dist_idx_upper < d)
        iu = torch.clamp(dist_idx_upper, 0, d - 1)
        il = torch.clamp(dist_idx_lower, 0, d - 1)
        # Per-line row select from the (D, LP) distribution (the JAX package uses a
        # one-hot contraction for the TPU; a gather selects the same single value).
        p_u = torch.gather(lines.distribution, 1, iu[:, None, :])[:, 0]
        p_l = torch.gather(lines.distribution, 1, il[:, None, :])[:, 0]
        dll = (torch.log(torch.clamp(p_u, min=1e-30))
               - torch.log(torch.clamp(p_l, min=1e-30))) \
            * cfg.learning_rate / lines.measured_variance
        valid = lines.valid & in_range

    nts = lines.normal_component_to_scale
    dcenter = torch.stack([
        nts * lines.normal_u * fu_z,
        nts * lines.normal_v * fv_z,
        nts * (-lines.normal_u * xfu_z - lines.normal_v * yfv_z) / z_safe,
    ], dim=1)                                                        # (B, 3, LP)
    dtrans = rot.transpose(1, 2) @ dcenter                           # (B, 3, LP)
    cb = lines.center_f_body
    dtheta = torch.cat([
        torch.stack([cb[:, 1] * dtrans[:, 2] - cb[:, 2] * dtrans[:, 1],
                     cb[:, 2] * dtrans[:, 0] - cb[:, 0] * dtrans[:, 2],
                     cb[:, 0] * dtrans[:, 1] - cb[:, 1] * dtrans[:, 0]], dim=1),
        dtrans,
    ], dim=1)                                                        # (B, 6, LP)

    weight = cfg.min_expected_variance / (nts * nts * variance)
    wmask = torch.where(valid, weight, torch.zeros_like(weight))
    gradient = (dtheta @ (wmask * dll)[:, :, None])[:, :, 0]
    wh = wmask / lines.measured_variance
    hessian = -(dtheta * wh[:, None, :]) @ dtheta.transpose(1, 2)
    return gradient, hessian


# ----------------------------------------------------------------------------------------
# Histogram update walk (AddLinePixelColorsToTempHistograms, cpp:1025-1155)
# ----------------------------------------------------------------------------------------


def histogram_walk_geometry(cfg: RegionConfig, points: ViewPointsCL, n_lines, pose,
                            fu, fv, ppu, ppv, width: int, height: int,
                            corner_u, corner_v, crop_size: int, lp2: int):
    """Staircase params + masks for the fg/bg color-collection walks.

    Returns (params (B, 8, lp2), mask (B, lp2, KP2)) where the first half of the lanes
    are the foreground walks and the second half the background walks.
    """
    max_steps = math.ceil(cfg.max_considered_line_length) + 1
    kp2 = round_up(max_steps, 8)
    l = points.center_f_body.shape[-1]
    dev = pose.device

    z, center_u, center_v, normal_u, normal_v = project_lines_cl(
        points, pose, fu, fv, ppu, ppv)
    ones = torch.ones_like(z)

    valid = _line_mask(n_lines, l, dev) & (z > 0.0)
    i_cu = torch.trunc(center_u + 0.5).to(torch.int32)
    i_cv = torch.trunc(center_v + 0.5).to(torch.int32)
    valid = valid & (i_cu >= 0) & (i_cu <= width - 1) & (i_cv >= 0) & (i_cv <= height - 1)

    z_safe = torch.where(z > 0, z, ones)
    l_f = points.foreground_distance * fu / z_safe
    l_b = points.background_distance * fu / z_safe
    length_f = torch.clamp(l_f - 2.0 * cfg.unconsidered_line_length,
                           max=cfg.max_considered_line_length)
    length_b = torch.clamp(l_b - 2.0 * cfg.unconsidered_line_length,
                           max=cfg.max_considered_line_length)

    abs_nu = torch.abs(normal_u)
    abs_nv = torch.abs(normal_v)
    u_dom = abs_nu > abs_nv
    u_step = torch.where(u_dom, torch.sign(normal_u),
                         normal_u / torch.where(abs_nv > 0, abs_nv, ones))
    v_step = torch.where(u_dom, normal_v / torch.where(abs_nu > 0, abs_nu, ones),
                         torch.sign(normal_v))
    dom = torch.where(u_dom, abs_nu, abs_nv)
    proj_len_f = torch.trunc(length_f * dom + 0.5).to(torch.int32)
    proj_len_b = torch.trunc(length_b * dom + 0.5).to(torch.int32)

    corner_p = torch.where(u_dom, corner_u[:, None], corner_v[:, None]).to(torch.float32)
    corner_s = torch.where(u_dom, corner_v[:, None], corner_u[:, None]).to(torch.float32)
    p_step = torch.where(u_dom, u_step, v_step)   # +-1 on the dominant axis
    s_step = torch.where(u_dom, v_step, u_step)
    size_p = torch.where(u_dom, width, height)[:, :, None]
    size_s = torch.where(u_dom, height, width)[:, :, None]

    k = torch.arange(max_steps, dtype=torch.float32, device=dev)[None, None, :]
    steps_ok = torch.arange(max_steps, device=dev)[None, None, :]

    def side(sign, proj_len):
        u0 = center_u + sign * normal_u * cfg.unconsidered_line_length + 0.5
        v0 = center_v + sign * normal_v * cfg.unconsidered_line_length + 0.5
        p0f = torch.where(u_dom, u0, v0)
        s0f = torch.where(u_dom, v0, u0)
        # Dominant axis: trunc(p0f) + k*dir exactly (dir == +-1); secondary axis:
        # trunc(s0f + k*stp), which the kernel evaluates as floor(s0c + (i - r0c)*stp*dir)
        # at i = r0c + dir*k, i.e. floor(s0c + k*stp) since dir*dir == 1.
        dir_ = sign * p_step
        r0 = torch.trunc(p0f)
        stp = sign * s_step
        zeros = torch.zeros_like(r0)
        params = torch.stack([r0 - corner_p, s0f - corner_s, stp,
                              u_dom.to(torch.float32), dir_, zeros, zeros, zeros], dim=1)
        # Masks: within projected length, inside image, valid line.  The walk is affine
        # in k, so in-bounds k form an interval and the reference's break-on-exit scan
        # equals interval membership from k == 0.
        pk = r0[:, :, None] + dir_[:, :, None] * k
        sk = torch.trunc(s0f[:, :, None] + sign * k * s_step[:, :, None])
        inb = ((pk >= 0) & (pk <= size_p - 1) & (sk >= 0) & (sk <= size_s - 1))
        inb = inb & inb[:, :, :1]
        running = torch.cumprod(inb.to(torch.int32), dim=2).to(torch.bool)
        mask = running & (steps_ok < proj_len[:, :, None]) & valid[:, :, None]
        cp = corner_p[:, :, None]
        cs = corner_s[:, :, None]
        mask = mask & ((pk >= cp) & (pk <= cp + crop_size - 1)
                       & (sk >= cs) & (sk <= cs + crop_size - 1))
        return params, mask

    params_f, mask_f = side(-1.0, proj_len_f)
    params_b, mask_b = side(1.0, proj_len_b)

    half = lp2 // 2
    b = pose.shape[0]
    params = torch.cat([_pad_lanes(params_f, half), _pad_lanes(params_b, half)], dim=2)
    mask = torch.zeros((b, lp2, kp2), dtype=torch.bool, device=dev)
    mask[:, :l, :max_steps] = mask_f
    mask[:, half:half + l, :max_steps] = mask_b
    return params, mask
