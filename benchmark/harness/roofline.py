"""The work each hand-written kernel's calls ask for, counted from their inputs and
outputs whatever implements them, and the least time the chip could take for it.

Counts follow the algorithm, not the kernel: each input byte read once, each output byte
written once.  Scalar operations per element, read off the algorithm: a line sample
takes 2 mul, 3 add/sub, 1 floor and 4 min/max.
"""

from __future__ import annotations

import contextlib

import torch

SAMPLE_LINES_OPS = 10
# The sample_lines call's (B, 8, LP) line parameters: the rows it reads.
ROW_R0, ROW_S0, ROW_STEP, ROW_UDOM, ROW_DIR = range(5)
SAMPLE_LINES_PARAM_ROWS = 5


def _crop_index(x, c: int):
    return torch.clamp(torch.nan_to_num(x, nan=0.0), 0, c - 1).to(torch.int64)


def sampled_words(params, c: int, kp: int):
    """(B, kp, LP) flat index into the (B, C, C) crops of every sample a line-sampling
    call reads: sample k of a line lies k steps from its start along its dominant axis,
    and on the line's slope across it."""
    r0, s0 = params[:, ROW_R0, None], params[:, ROW_S0, None]
    direction = params[:, ROW_DIR, None]
    along_u = params[:, ROW_UDOM, None] > 0.5
    k = torch.arange(kp, dtype=torch.float32, device=params.device)[None, :, None]
    i = _crop_index(r0 + direction * k, c)
    j = _crop_index(torch.floor(s0 + (i.to(torch.float32) - r0)
                                * params[:, ROW_STEP, None] * direction), c)
    body = torch.arange(params.shape[0], device=params.device)[:, None, None] * (c * c)
    return body + torch.where(along_u, j * c + i, i * c + j)


def sample_lines_work(params, bin_crop, table, kp: int, output: str = "ratio"):
    """(bytes, operations) of one line-sampling call (K1): the parameter rows it reads,
    each distinct crop word once, the samples it writes and the tables."""
    b, _, lp = params.shape
    touched = torch.unique(sampled_words(params, bin_crop.shape[-1], kp)).numel()
    n_out = b * kp * lp
    n_bytes = (b * SAMPLE_LINES_PARAM_ROWS * lp * 4 + touched * 4 + n_out * 4
               + (table.numel() * 4 if output == "ratio" else 0))
    return n_bytes, SAMPLE_LINES_OPS * n_out


def bound_s(n_bytes: float, n_ops: float, peaks: dict) -> float:
    """The larger of bytes over the memory rate and operations over the float32 rate."""
    return max(n_bytes / peaks["bytes_per_s"], n_ops / peaks["fp32_ops_per_s"])


@contextlib.contextmanager
def recorded_calls():
    """The arguments of every K1 call the block makes, as {"sample_lines": [(args,
    kwargs)]}.  The cycles run eagerly inside the block: a graph's replay calls no
    wrapper.  The callers look the wrapper up in its module at each call."""
    from m3t_tpu_torch import graphs
    from m3t_tpu_torch.ops import region_fast

    original = region_fast.sample_lines
    calls = {"sample_lines": []}

    def sample_lines(*args, **kwargs):
        calls["sample_lines"].append((args, kwargs))
        return original(*args, **kwargs)

    sample_lines.launches = original.launches
    region_fast.sample_lines = sample_lines
    try:
        with graphs.disable_graphs():
            yield calls
    finally:
        region_fast.sample_lines = original


def cycle_work(calls) -> dict:
    """{"sample_lines": (bytes, ops)} summed over one cycle's recorded calls; left out
    where the cycle makes none."""
    work = {}
    for args, kwargs in calls["sample_lines"]:
        n_bytes, n_ops = sample_lines_work(*args, **kwargs)
        old = work.get("sample_lines", (0, 0))
        work["sample_lines"] = (old[0] + n_bytes, old[1] + n_ops)
    return work
