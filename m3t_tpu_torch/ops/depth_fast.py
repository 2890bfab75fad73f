"""Depth-window presampling on PyTorch/CUDA (port of m3t_tpu/ops/depth_fast.py).

The depth modality samples a strided (K, K) window of the depth image around every
projected model point, both to search correspondences (FindCorrespondence,
depth_modality.cpp:826-884) and to test measured occlusions (depth_modality.cpp:736-776,
region_modality.cpp:1343-1389).  As in the JAX package, each body's depth image is
cropped once per cycle to a (C, C) window around the projected body origin, and the
windows are fetched from the crop by one kernel, :func:`sample_windows`: every
(point, window row) pair is a "line" that walks K samples along u at ``stride`` pixels
per step at a fixed crop row.  Samples outside the crop are masked invalid (the
crop-coverage caveat of the JAX module: a point whose window leaves the crop loses
those samples).

The hand-written Hopper kernel is in ``csrc/depth_kernels.cu``; the wrapper launches it
for CUDA tensors and runs its plain PyTorch twin (:func:`sample_windows_plain`) for CPU
tensors, with no fallback from one to the other.  The crop is (B, C, C) int32, not
transposed: the TPU-only ``cropT`` is gone, as ``bin_cropT`` went from the region path.
Layouts at the function boundary are the JAX module's: params (B, 4, LP), samples
(B, kp, LP), windows (B, P, Kv, Ku).
"""

from __future__ import annotations

import torch

from m3t_tpu_torch.ops import _cuda
from m3t_tpu_torch.ops import depth_fn
from m3t_tpu_torch.ops.depth_fn import KMAX_N_OCCLUSION_STRIDES, DepthConfig
from m3t_tpu_torch.ops.region_fast import _require, clamp_index, crop_corners, round_up

# Parameter rows of the window kernel input (depth_fast.py:37-41).
_ROW_U0 = 0      # u start, crop coords (integer-valued f32)
_ROW_ROW = 1     # fixed crop row (v) per line (integer-valued f32)
_ROW_STRIDE = 2  # pixels advanced per step along u (integer-valued f32)
_NPARAM = 4


# ----------------------------------------------------------------------------------------
# Kernel 3: strided window rows
# ----------------------------------------------------------------------------------------


def _check_window_inputs(params, crop, kp: int):
    _require(params.dtype == torch.float32 and params.dim() == 3
             and params.shape[1] == _NPARAM, "params must be (B, 4, LP) float32")
    _require(crop.dtype == torch.int32 and crop.dim() == 3
             and crop.shape[0] == params.shape[0] and crop.shape[1] == crop.shape[2],
             "crop must be (B, C, C) int32")
    _require(params.device == crop.device,
             f"inputs on different devices: {params.device}, {crop.device}")
    _require(kp > 0, "kp must be positive")


def window_index(params, c: int, kp: int):
    """(B, kp, LP) int64 flat index into the (B, C, C) crops of every window sample:
    the address arithmetic of the sample_windows kernel, in the same order."""
    b = params.shape[0]
    u0 = params[:, _ROW_U0, None, :]                               # (B, 1, LP)
    row = clamp_index(params[:, _ROW_ROW, None, :], c)
    stride = params[:, _ROW_STRIDE, None, :]
    k = torch.arange(kp, dtype=torch.float32, device=params.device)[None, :, None]
    col = clamp_index(u0 + stride * k, c)                           # (B, kp, LP)
    body = torch.arange(b, device=params.device)[:, None, None] * (c * c)
    return body + row * c + col


def sample_windows_plain(params, crop, kp: int):
    """Plain PyTorch twin of the sample_windows kernel (same arithmetic, same order)."""
    _check_window_inputs(params, crop, kp)
    return crop.reshape(-1)[window_index(params, crop.shape[-1], kp)]


def sample_windows(params, crop, kp: int):
    """Batched strided row sampling:
    ``out[b, k, l] = crop[b, clip(int(row_l)), clip(int(u0_l + stride_l * k))]``.

    params: (B, 4, LP) f32 (rows _ROW_*); crop: (B, C, C) int32.  Returns (B, kp, LP)
    int32."""
    if params.device.type == "cpu":
        return sample_windows_plain(params, crop, kp)
    _check_window_inputs(params, crop, kp)
    _require(params.device.type == "cuda", f"unsupported device {params.device}")
    _require(params.is_contiguous() and crop.is_contiguous(),
             "sample_windows inputs must be contiguous")
    b, _, lp = params.shape
    _require(0 < b <= 65535, "sample_windows: need 0 < B <= 65535")
    out = torch.empty((b, kp, lp), dtype=torch.int32, device=params.device)
    with torch.cuda.device(params.device):
        err = _cuda.library().m3t_sample_windows(
            params.data_ptr(), crop.data_ptr(), out.data_ptr(), b, lp, kp, crop.shape[-1],
            _cuda.stream_handle(params.device))
    _cuda.check(err, "sample_windows")
    sample_windows.launches += 1
    return out


sample_windows.launches = 0


# ----------------------------------------------------------------------------------------
# Crops and window presampling (batched over bodies)
# ----------------------------------------------------------------------------------------


def pad_depth(depth_images, crop_size: int):
    """Zero-pad (B, H, W) so both spatial dims are >= crop_size (small test images)."""
    b, h, w = depth_images.shape
    ph = max(crop_size - h, 0)
    pw = max(crop_size - w, 0)
    if not (ph or pw):
        return depth_images
    out = depth_images.new_zeros((b, h + ph, w + pw))
    out[:, :h, :w] = depth_images
    return out


def depth_crops(depth_images, poses, fu: float, fv: float, ppu: float, ppv: float,
                crop_size: int):
    """Per-body (C, C) int32 crops of (B, H, W) uint16 depth images around the
    projected body centers: (crop (B, C, C), corner_u (B,), corner_v (B,)).

    The crop is an index gather, as region_fast.binify_crops; an expanded batch of one
    image is never materialised."""
    padded = pad_depth(depth_images, crop_size)
    t = poses[:, :3, 3]
    z = torch.where(t[:, 2] > 0, t[:, 2], torch.ones_like(t[:, 2]))
    cu = t[:, 0] * fu / z + ppu
    cv = t[:, 1] * fv / z + ppv
    corner_u, corner_v = crop_corners(cu, cv, crop_size, padded.shape[2], padded.shape[1])
    dev = padded.device
    ar = torch.arange(crop_size, device=dev)
    rows = (corner_v.long()[:, None] + ar)[:, :, None]              # (B, C, 1)
    cols = (corner_u.long()[:, None] + ar)[:, None, :]              # (B, 1, C)
    body = torch.arange(padded.shape[0], device=dev)[:, None, None]
    return depth_fn.gather_u16(padded, body, rows, cols), corner_u, corner_v


def correspondence_windows(cfg: DepthConfig, considered_distance: float, centers_b,
                           poses, fu: float, fv: float, ppu: float, ppv: float):
    """Image-coordinate geometry of FindCorrespondence's windows (depth_modality.cpp
    :826-884), as depth_fn.calculate_correspondences computes it:
    (u_min, v_min, stride) (B, P) int32 and the sample count K."""
    _, z, z_safe, cu, cv = depth_fn.project_points(centers_b, poses, fu, fv, ppu, ppv)
    k_max = depth_fn.max_n_strides(cfg, considered_distance)
    _, diameter = depth_fn.correspondence_diameter(cfg, considered_distance, z, z_safe,
                                                   fu)
    u_min0, v_min0, _, stride = depth_fn.window_start(diameter, k_max, cu, cv)
    return torch.clamp(u_min0, min=0), torch.clamp(v_min0, min=0), stride, k_max + 1


def window_params(u_min, v_min, stride, corner_u, corner_v, k: int):
    """Kernel parameters (B, 4, LP) of (B, P) windows: line l = p*K + kv walks K samples
    along u at ``stride`` px per step at crop row v_min_c + kv*stride; LP = P*K rounded
    up to 128.  Returns (params, v_rows (B, P, K) int32 crop rows)."""
    b, p = u_min.shape
    kv = torch.arange(k, dtype=torch.int32, device=u_min.device)
    u_min_c = (u_min - corner_u[:, None]).to(torch.float32)          # (B, P)
    v_rows = (v_min - corner_v[:, None])[:, :, None] + kv * stride[:, :, None]
    lp = round_up(p * k, 128)
    params = torch.zeros((b, _NPARAM, lp), dtype=torch.float32, device=u_min.device)
    params[:, _ROW_U0, :p * k] = u_min_c[:, :, None].expand(b, p, k).reshape(b, p * k)
    params[:, _ROW_ROW, :p * k] = v_rows.to(torch.float32).reshape(b, p * k)
    params[:, _ROW_STRIDE, :p * k] = (stride.to(torch.float32)[:, :, None]
                                      .expand(b, p, k).reshape(b, p * k))
    return params, v_rows


def _fetch_strided_windows(u_min, v_min, stride, corner_u, corner_v, crop,
                           crop_size: int, k: int):
    """Fetch (B, P, K, K) strided windows from the crops through the kernel.

    u_min/v_min/stride: (B, P) int32 window geometry in image coords.  Returns (d (B, P,
    Kv, Ku) f32 raw depth values, in_crop (B, P, Kv, Ku) bool); samples outside the
    body-centred crop are masked."""
    b, p = u_min.shape
    params, v_rows = window_params(u_min, v_min, stride, corner_u, corner_v, k)
    out = sample_windows(params, crop, round_up(k, 8))
    # out[b, ku, p*K + kv] -> (B, P, Kv, Ku)
    d = (out[:, :k, :p * k].reshape(b, k, p, k).permute(0, 2, 3, 1)
         .to(torch.float32))

    # Samples outside the crop were clamped by the kernel: mask them out.
    ks = torch.arange(k, dtype=torch.int32, device=u_min.device)
    us_c = (u_min - corner_u[:, None])[:, :, None] + ks * stride[:, :, None]  # (B, P, K)
    u_in = (us_c >= 0) & (us_c < crop_size)
    v_in = (v_rows >= 0) & (v_rows < crop_size)
    return d, v_in[:, :, :, None] & u_in[:, :, None, :]


def presample_windows(cfg: DepthConfig, considered_distance: float, centers_b, poses,
                      crop, corner_u, corner_v, crop_size: int,
                      fu: float, fv: float, ppu: float, ppv: float):
    """Fetch the strided correspondence-search windows for a batch of bodies.

    centers_b: (B, P, 3) model-point centers (body frame) of the selected views.
    Returns (d (B, P, K, K) f32 raw depth values, in_crop (B, P, K, K) bool) in the
    (kv, ku) order of depth_fn's direct gather (argmin ties break identically)."""
    u_min, v_min, stride, k = correspondence_windows(
        cfg, considered_distance, centers_b, poses, fu, fv, ppu, ppv)
    return _fetch_strided_windows(u_min, v_min, stride, corner_u, corner_v,
                                  crop, crop_size, k)


def occlusion_windows(radius: float, use_depth_scaling: bool, centers_b, poses,
                      fu: float, fv: float, ppu: float, ppv: float, width: int,
                      height: int):
    """Image-coordinate geometry of the measured-occlusion windows:
    (u_min, v_min, u_max, v_max, stride), each (B, P) int32."""
    _, _, z_safe, cu, cv = depth_fn.project_points(centers_b, poses, fu, fv, ppu, ppv)
    return depth_fn.measured_occlusion_window(radius, use_depth_scaling, z_safe, cu, cv,
                                              fu, width, height)


def presample_occlusion_windows(radius: float, use_depth_scaling: bool, centers_b,
                                poses, crop, corner_u, corner_v, crop_size: int,
                                fu: float, fv: float, ppu: float, ppv: float,
                                width: int, height: int):
    """Fetch the strided measured-occlusion windows for a batch of bodies
    (IsLineUnoccludedMeasured, region_modality.cpp:1343-1389; IsPointUnoccludedMeasured,
    depth_modality.cpp:736-776).

    centers_b: (B, P, 3) model points (body frame); poses: (B, 4, 4) body to depth
    camera.  Returns (d (B, P, K, K) raw depth, ok (B, P, K, K) bool: the image-bounds
    sample mask and the crop-coverage mask)."""
    k = KMAX_N_OCCLUSION_STRIDES + 1
    u_min, v_min, u_max, v_max, stride = occlusion_windows(
        radius, use_depth_scaling, centers_b, poses, fu, fv, ppu, ppv, width, height)
    d, in_crop = _fetch_strided_windows(u_min, v_min, stride, corner_u, corner_v,
                                        crop, crop_size, k)
    ks = torch.arange(k, dtype=torch.int32, device=u_min.device)
    u_ok = (u_min[:, :, None] + ks * stride[:, :, None]) <= u_max[:, :, None]
    v_ok = (v_min[:, :, None] + ks * stride[:, :, None]) <= v_max[:, :, None]
    return d, v_ok[:, :, :, None] & u_ok[:, :, None, :] & in_crop
