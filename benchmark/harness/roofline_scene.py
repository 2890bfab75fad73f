"""The work of the depth-window kernel (K3, ``sample_windows``) and the scene-query kernel
(K4, ``query_eval``), counted from their calls' inputs whatever implements them, beside
the line-sampling kernel's (``harness/roofline.py``), and the recorder of one cycle's
calls of all three.

K3 (PERF.md section 6): its float32 output written, the (B, P) window geometry (first
column, first row, stride) and the (B,) crop corners read once, and 2 bytes for every
distinct (frame, pixel) inside the frames that the windows sample (a frame shared by the
batch as an expanded view counts once); 5 operations per output sample (1 mul, 2 add and
2 min/max: its column; a window row's samples share its row).

K4: each query's (u, v) read and its (inverse depth, id) written, each scene's validity
flags, and each scene's coefficient rows and ids up to its loop bound (the last valid
triangle); 27 operations per (query, valid triangle) pair whose query lies in the
triangle's box, the pairs the algorithm has to evaluate (8 mul and 8 add for the four
planes, 4 compares and 3 ands for the coverage, 1 select for its value, 1 compare and 2
selects for the running best).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.harness import roofline

SAMPLE_WINDOWS_OPS = 5
QUERY_EVAL_OPS = 27
# Per query: u, v read and the inverse depth and id written, 4 bytes each.
QUERY_BYTES = 16
# Per triangle row up to the loop bound: 12 float32 coefficients and an int32 id.
TRIANGLE_BYTES = 52


def touched_pixels(image, u_min, v_min, stride, corner_u, corner_v, crop_size: int,
                   k: int) -> int:
    """Distinct (frame, pixel) pairs inside the (B, H, W) frames that the (B, P, k, k)
    windows sample: each sample's position clamped to its body's (C, C) crop."""
    b, h, w = image.shape
    n_frames = 1 if b > 1 and image.stride(0) == 0 else b
    ks = torch.arange(k, dtype=torch.int64, device=u_min.device)

    def axis(start, corner):
        offset = (start.long() - corner.long()[:, None])[..., None] + ks * stride.long()[
            ..., None]
        return offset.clamp(0, crop_size - 1) + corner.long()[:, None, None]

    rows, cols = axis(v_min, corner_v), axis(u_min, corner_u)       # (B, P, k)
    frame = torch.arange(b, device=u_min.device) % n_frames
    index = ((frame[:, None, None, None] * h + rows[..., :, None]) * w
             + cols[..., None, :])
    inside = ((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[
        ..., None, :]
    return torch.unique(index[inside]).numel()


def sample_windows_work(image, u_min, v_min, stride, corner_u, corner_v, crop_size: int,
                        k: int):
    """(bytes, operations) of one depth-window call (K3)."""
    b, p = u_min.shape
    n_out = b * p * k * k
    touched = touched_pixels(image, u_min, v_min, stride, corner_u, corner_v, crop_size, k)
    return n_out * 4 + 3 * u_min.numel() * 4 + 2 * b * 4 + 2 * touched, \
        SAMPLE_WINDOWS_OPS * n_out


def loop_bound(tri_valid):
    """(B,) the index of each scene's last valid triangle plus one, or 0."""
    index = torch.arange(1, tri_valid.shape[-1] + 1, device=tri_valid.device)
    return torch.where(tri_valid, index, torch.zeros_like(index)).amax(-1)


def in_box_pairs(u, v, bbox, tri_valid) -> int:
    """(query, valid triangle) pairs whose query (B, Q) lies in the triangle's box (B,
    T, 4) [u0, u1, v0, v1] (ends included), counted by a summed-area table of the
    queries over the pixels.  The cycles' queries are pixels of the focused image:
    non-negative int32."""
    b = u.shape[0]
    u = u.reshape(b, -1)
    v = v.reshape(b, -1)
    if not (u.dtype == v.dtype == torch.int32 and u.numel() and int(u.min()) >= 0
            and int(v.min()) >= 0):
        raise ValueError("scene queries must be non-negative int32 pixels")
    w, h = int(u.max()) + 1, int(v.max()) + 1
    table = torch.zeros((b, (h + 1) * (w + 1)), dtype=torch.int64, device=u.device)
    table.scatter_add_(1, (v.long() + 1) * (w + 1) + u.long() + 1,
                       torch.ones_like(u, dtype=torch.int64))
    table = table.reshape(b, h + 1, w + 1).cumsum(1).cumsum(2).reshape(b, -1)
    finite = torch.isfinite(bbox).all(-1)
    bbox = torch.where(finite[..., None], bbox, torch.zeros_like(bbox))
    u0 = torch.ceil(bbox[..., 0]).clamp(0, w).long()           # first column in the box
    u1 = (torch.floor(bbox[..., 1]) + 1).clamp(0, w).long()    # one past its last
    v0 = torch.ceil(bbox[..., 2]).clamp(0, h).long()
    v1 = (torch.floor(bbox[..., 3]) + 1).clamp(0, h).long()
    u1, v1 = torch.maximum(u1, u0), torch.maximum(v1, v0)

    def at(row, col):
        return torch.gather(table, 1, row * (w + 1) + col)

    count = at(v1, u1) - at(v0, u1) - at(v1, u0) + at(v0, u0)
    return int(torch.where(tri_valid & finite, count, 0).sum())


def query_eval_work(coeffs, tri_valid, sil_id, u, v, bbox, cull: bool = True):
    """(bytes, operations) of one scene-query call (K4); bbox (B, T, 4): the focused
    scene's triangle boxes, in the order of ``coeffs``."""
    n_bytes = (QUERY_BYTES * u.numel() + tri_valid.numel()
               + TRIANGLE_BYTES * int(loop_bound(tri_valid).sum()))
    return n_bytes, QUERY_EVAL_OPS * in_box_pairs(u, v, bbox, tri_valid)


@contextlib.contextmanager
def recorded_calls():
    """The arguments of every K1, K3 and K4 call the block makes, as {"sample_lines":
    [(args, kwargs)], "sample_windows": [...], "query_eval": [(args, kwargs, bbox)]},
    each K4 call with the boxes of the focused scene whose coefficients it reads.  The
    cycles run eagerly inside the block (roofline.recorded_calls); the callers look the
    wrappers up in their modules at each call."""
    from m3t_tpu_torch.ops import depth_fast, occlusion

    windows, queries, scenes = [], [], []
    originals = (depth_fast.sample_windows, occlusion.query_eval,
                 occlusion.focused_scene_coeffs)

    def sample_windows(*args, **kwargs):
        windows.append((args, kwargs))
        return originals[0](*args, **kwargs)

    def query_eval(*args, **kwargs):
        boxes = [sc.bbox for sc in scenes if sc.coeffs is args[0]]
        queries.append((args, kwargs, boxes[-1] if boxes else None))
        return originals[1](*args, **kwargs)

    def focused_scene_coeffs(*args, **kwargs):
        scenes.append(originals[2](*args, **kwargs))
        return scenes[-1]

    sample_windows.launches = originals[0].launches
    query_eval.launches = originals[1].launches
    depth_fast.sample_windows = sample_windows
    occlusion.query_eval = query_eval
    occlusion.focused_scene_coeffs = focused_scene_coeffs
    try:
        with roofline.recorded_calls() as calls:
            calls.update(sample_windows=windows, query_eval=queries)
            yield calls
    finally:
        (depth_fast.sample_windows, occlusion.query_eval,
         occlusion.focused_scene_coeffs) = originals


def cycle_work(calls) -> dict:
    """{"sample_lines" | "sample_windows" | "query_eval": (bytes, ops)} summed over one
    cycle's recorded calls; a kernel left out where the cycle makes no call of it (or,
    for K4, where a call's scene was not recorded)."""
    work = roofline.cycle_work(calls)

    def add(name, n_bytes, n_ops):
        old = work.get(name, (0, 0))
        work[name] = (old[0] + n_bytes, old[1] + n_ops)

    for args, kwargs in calls.get("sample_windows", []):
        add("sample_windows", *sample_windows_work(*args, **kwargs))
    for args, kwargs, bbox in calls.get("query_eval", []):
        if bbox is None:
            return {k: w for k, w in work.items() if k != "query_eval"}
        add("query_eval", *query_eval_work(*args, bbox=bbox, **kwargs))
    return work
