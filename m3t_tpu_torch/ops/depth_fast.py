"""Depth-window presampling on PyTorch/CUDA (port of m3t_tpu/ops/depth_fast.py).

The depth modality samples a strided (K, K) window of the depth image around every
projected model point, both to search correspondences (FindCorrespondence,
depth_modality.cpp:826-884) and to test measured occlusions (depth_modality.cpp:736-776,
region_modality.cpp:1343-1389).  As in the JAX package, every body's samples are confined
to a (C, C) crop around its projected body origin: a sample position is clamped to the
crop, and a sample outside it is masked invalid (the crop-coverage caveat of the JAX
module: a point whose window leaves the crop loses those samples).

The crop itself is never built.  One kernel, :func:`sample_windows`, reads the (B, H, W)
uint16 frame at the clamped crop positions (0 outside the frame, which is what the JAX
package's zero-padding of a frame smaller than the crop gives) and writes the windows as
(B, P, Kv, Ku) float32, the layout depth_fn.calculate_correspondences reads.  The
hand-written Hopper kernel is in ``csrc/depth_kernels.cu``; the wrapper launches it for
CUDA tensors and runs its plain PyTorch twin (:func:`sample_windows_plain`) for CPU
tensors, with no fallback from one to the other.
"""

from __future__ import annotations

import torch

from m3t_tpu_torch.ops import _cuda
from m3t_tpu_torch.ops import depth_fn
from m3t_tpu_torch.ops.depth_fn import KMAX_N_OCCLUSION_STRIDES, DepthConfig
from m3t_tpu_torch.ops.region_fast import _require, crop_corners
from m3t_tpu_torch.utils import timing

# ----------------------------------------------------------------------------------------
# Kernel 3: strided windows
# ----------------------------------------------------------------------------------------


def _check_window_inputs(image, u_min, v_min, stride, corner_u, corner_v, crop_size: int,
                         k: int):
    _require(image.dtype == torch.uint16 and image.dim() == 3,
             "image must be (B, H, W) uint16")
    b = image.shape[0]
    _require(u_min.dim() == 2 and u_min.shape[0] == b
             and all(x.dtype == torch.int32 and x.shape == u_min.shape
                     for x in (u_min, v_min, stride)),
             "u_min, v_min and stride must be (B, P) int32")
    _require(all(x.dtype == torch.int32 and x.shape == (b,) for x in (corner_u, corner_v)),
             "corner_u and corner_v must be (B,) int32")
    devices = {x.device for x in (image, u_min, v_min, stride, corner_u, corner_v)}
    _require(len(devices) == 1, f"inputs on different devices: {devices}")
    _require(crop_size > 0 and k > 0, "crop_size and k must be positive")


def _crop_offsets(start, corner, stride, k: int):
    """(B, P, K) int32 crop coordinates of the K samples along one window axis."""
    ks = torch.arange(k, dtype=torch.int32, device=start.device)
    return (start - corner[:, None])[:, :, None] + ks * stride[:, :, None]


def window_positions(u_min, v_min, stride, corner_u, corner_v, crop_size: int, k: int):
    """Image (rows, cols), each (B, P, K) int32, of every window's samples: the window
    position clamped to the body's (C, C) crop, in the kernel's int32 arithmetic."""
    def axis(start, corner):
        return (torch.clamp(_crop_offsets(start, corner, stride, k), 0, crop_size - 1)
                + corner[:, None, None])

    return axis(v_min, corner_v), axis(u_min, corner_u)


def sample_windows_plain(image, u_min, v_min, stride, corner_u, corner_v, crop_size: int,
                         k: int):
    """Plain PyTorch twin of the sample_windows kernel (same int32 arithmetic)."""
    _check_window_inputs(image, u_min, v_min, stride, corner_u, corner_v, crop_size, k)
    b, h, w = image.shape
    rows, cols = window_positions(u_min, v_min, stride, corner_u, corner_v, crop_size, k)
    inside = (((rows >= 0) & (rows < h))[..., :, None]
              & ((cols >= 0) & (cols < w))[..., None, :])                # (B, P, K, K)
    body = torch.arange(b, device=image.device)[:, None, None, None]
    d = depth_fn.gather_u16(image, body, rows.clamp(0, h - 1).long()[..., :, None],
                            cols.clamp(0, w - 1).long()[..., None, :])
    return torch.where(inside, d, 0).to(torch.float32)


@_cuda.kernel("m3t_sample_windows", [_cuda.PTR, _cuda.INT64, _cuda.INT, _cuda.INT]
              + [_cuda.PTR] * 6 + [_cuda.INT] * 4)
def sample_windows(image, u_min, v_min, stride, corner_u, corner_v, crop_size: int,
                   k: int):
    """(B, P, K, K) float32 strided windows of the (B, H, W) uint16 frames:
    ``d[b, p, kv, ku] = image[b, corner_v + r, corner_u + c]`` with
    ``r = clamp(v_min - corner_v + kv*stride, 0, C-1)``,
    ``c = clamp(u_min - corner_u + ku*stride, 0, C-1)``, and 0 outside the frame.

    u_min, v_min, stride: (B, P) int32 in image coordinates; corner_u, corner_v: (B,)
    int32.  On the card each (H, W) plane must be contiguous; the batch may be an
    expanded view (batch stride 0)."""
    if image.device.type == "cpu":
        return sample_windows_plain(image, u_min, v_min, stride, corner_u, corner_v,
                                    crop_size, k)
    _check_window_inputs(image, u_min, v_min, stride, corner_u, corner_v, crop_size, k)
    _require(image.device.type == "cuda", f"unsupported device {image.device}")
    b, h, w = image.shape
    p = u_min.shape[1]
    _require(b > 0 and p > 0 and h > 0 and w > 0,
             "sample_windows: need B > 0, P > 0 and a non-empty frame")
    _require(p * k * k < 2 ** 31, "sample_windows: P * K * K must fit in int32")
    _require(image.stride(2) == 1 and image.stride(1) == w and image.stride(0) >= 0,
             "sample_windows: each (H, W) plane of the image must be contiguous")
    _require(all(x.is_contiguous() for x in (u_min, v_min, stride, corner_u, corner_v)),
             "sample_windows: the window geometry must be contiguous")
    out = torch.empty((b, p, k, k), dtype=torch.float32, device=image.device)
    _cuda.launch("m3t_sample_windows", image.device, image.data_ptr(), image.stride(0), h,
                 w, u_min.data_ptr(), v_min.data_ptr(), stride.data_ptr(),
                 corner_u.data_ptr(), corner_v.data_ptr(), out.data_ptr(), b, p, k,
                 crop_size)
    return out


# ----------------------------------------------------------------------------------------
# Crop corners and window presampling (batched over bodies)
# ----------------------------------------------------------------------------------------


def depth_corners(depth_images, poses, fu: float, fv: float, ppu: float, ppv: float,
                  crop_size: int):
    """Top-left corners (corner_u (B,), corner_v (B,)) int32 of the (C, C) crops around
    the projected body centres in (B, H, W) depth images, computed on the sizes of the
    images zero-padded to at least the crop (m3t_tpu/ops/depth_fast.py:116-132)."""
    height, width = depth_images.shape[1], depth_images.shape[2]
    t = poses[:, :3, 3]
    z = torch.where(t[:, 2] > 0, t[:, 2], torch.ones_like(t[:, 2]))
    cu = t[:, 0] * fu / z + ppu
    cv = t[:, 1] * fv / z + ppv
    return crop_corners(cu, cv, crop_size, max(width, crop_size), max(height, crop_size))


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


def _fetch_strided_windows(image, u_min, v_min, stride, corner_u, corner_v,
                           crop_size: int, k: int):
    """Fetch (B, P, K, K) strided windows of the frames through the kernel.

    u_min/v_min/stride: (B, P) int32 window geometry in image coords.  Returns (d (B, P,
    Kv, Ku) f32 raw depth values, in_crop (B, P, Kv, Ku) bool); samples outside the
    body-centred crop are masked."""
    d = sample_windows(image, u_min, v_min, stride, corner_u, corner_v, crop_size, k)
    # Samples outside the crop were clamped by the kernel: mask them out.
    us_c = _crop_offsets(u_min, corner_u, stride, k)                 # (B, P, K)
    vs_c = _crop_offsets(v_min, corner_v, stride, k)
    u_in = (us_c >= 0) & (us_c < crop_size)
    v_in = (vs_c >= 0) & (vs_c < crop_size)
    return d, v_in[:, :, :, None] & u_in[:, :, None, :]


def presample_windows(cfg: DepthConfig, considered_distance: float, centers_b, poses,
                      image, corner_u, corner_v, crop_size: int,
                      fu: float, fv: float, ppu: float, ppv: float):
    """Fetch the strided correspondence-search windows for a batch of bodies.

    centers_b: (B, P, 3) model-point centers (body frame) of the selected views; image:
    (B, H, W) uint16 depth frames.  Returns (d (B, P, K, K) f32 raw depth values, in_crop
    (B, P, K, K) bool) in the (kv, ku) order of depth_fn's direct gather (argmin ties
    break identically)."""
    u_min, v_min, stride, k = correspondence_windows(
        cfg, considered_distance, centers_b, poses, fu, fv, ppu, ppv)
    return _fetch_strided_windows(image, u_min, v_min, stride, corner_u, corner_v,
                                  crop_size, k)


def occlusion_windows(radius: float, use_depth_scaling: bool, centers_b, poses,
                      fu: float, fv: float, ppu: float, ppv: float, width: int,
                      height: int):
    """Image-coordinate geometry of the measured-occlusion windows:
    (u_min, v_min, u_max, v_max, stride), each (B, P) int32."""
    _, _, z_safe, cu, cv = depth_fn.project_points(centers_b, poses, fu, fv, ppu, ppv)
    return depth_fn.measured_occlusion_window(radius, use_depth_scaling, z_safe, cu, cv,
                                              fu, width, height)


def presample_occlusion_windows(radius: float, use_depth_scaling: bool, centers_b,
                                poses, image, corner_u, corner_v, crop_size: int,
                                fu: float, fv: float, ppu: float, ppv: float,
                                width: int, height: int):
    """Fetch the strided measured-occlusion windows for a batch of bodies
    (IsLineUnoccludedMeasured, region_modality.cpp:1343-1389; IsPointUnoccludedMeasured,
    depth_modality.cpp:736-776).

    centers_b: (B, P, 3) model points (body frame); poses: (B, 4, 4) body to depth
    camera; image: (B, H, W) uint16 depth frames.  Returns (d (B, P, K, K) raw depth, ok
    (B, P, K, K) bool: the image-bounds sample mask and the crop-coverage mask).  Counts
    its B * P windows (utils/timing counter ``depth.occlusion_windows``)."""
    k = KMAX_N_OCCLUSION_STRIDES + 1
    timing.count("depth.occlusion_windows", centers_b.shape[0] * centers_b.shape[1])
    u_min, v_min, u_max, v_max, stride = occlusion_windows(
        radius, use_depth_scaling, centers_b, poses, fu, fv, ppu, ppv, width, height)
    d, in_crop = _fetch_strided_windows(image, u_min, v_min, stride, corner_u, corner_v,
                                        crop_size, k)
    ks = torch.arange(k, dtype=torch.int32, device=u_min.device)
    u_ok = (u_min[:, :, None] + ks * stride[:, :, None]) <= u_max[:, :, None]
    v_ok = (v_min[:, :, None] + ks * stride[:, :, None]) <= v_max[:, :, None]
    return d, v_ok[:, :, :, None] & u_ok[:, :, None, :] & in_crop
