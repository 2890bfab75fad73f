"""The comparison that decides ``correct``, and the lower precision of its control.

Each number compared is a gap between what the program produced and what the plain
reference (``benchmark/reference``) computes from the same inputs: the widest over all
bodies and steps, or the median over them of each body-step's widest, of the entries of
the 4x4 body-to-camera poses and of the histograms.  Each has a limit
of its own in the cell's file; the limits and the readings they were set from are in
PERF.md.
"""

from __future__ import annotations

import math
import statistics

import torch

def gap(program, reference) -> float:
    """Widest absolute gap between two tensors; inf where either is not finite."""
    rows = gaps(program.reshape(1, -1), reference.reshape(1, -1))
    return float(rows.max()) if rows.numel() else 0.0


def gaps(program, reference):
    """(B,) float64: the widest absolute gap of each leading row of two tensors; inf in a
    row where either is not finite."""
    a = program.to(torch.float64)
    b = reference.to(torch.float64).to(a.device)
    if a.shape[1:].numel() == 0:
        return torch.zeros(a.shape[0], dtype=torch.float64, device=a.device)
    wide = (a - b).abs().reshape(a.shape[0], -1).amax(1)
    finite = (torch.isfinite(a) & torch.isfinite(b)).reshape(a.shape[0], -1).all(1)
    return torch.where(finite, wide, torch.full_like(wide, math.inf))


def median(values) -> float:
    """The median of a 1-D tensor, the mean of the two middle values of an even count."""
    return float(statistics.median(values.tolist()))


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": reading, "limit": limit}}): correct when every number
    is at or under its limit and no limit lacks its number."""
    missing = sorted(set(limits) - set(readings))
    if missing:
        raise KeyError(f"no reading for the limits {missing}")
    shown = {name: {"value": readings[name] if math.isfinite(readings[name]) else "inf",
                    "limit": limits[name]} for name in limits}
    return all(readings[name] <= limits[name] for name in limits), shown


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (8 exponent bits, 10 mantissa bits), to nearest, ties to even,
    as the tensor cores round a float32 matmul's operands when TF32 is on."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    keep = ~torch.isfinite(x.contiguous())
    return torch.where(keep, x.contiguous(), rounded.view(torch.float32)).view_as(x)


_MATMULS = {torch.matmul, torch.bmm, torch.mm, torch.einsum, torch.Tensor.matmul,
            torch.Tensor.__matmul__, torch.Tensor.__rmatmul__, torch.Tensor.bmm,
            torch.Tensor.mm}


class TF32Matmuls(torch.overrides.TorchFunctionMode):
    """Inside the block every float32 matmul, bmm, mm and einsum takes its operands
    rounded to TF32 and accumulates in float32: the computation TF32 would run, on any
    device."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _MATMULS:
            args = tuple(tf32(a) if isinstance(a, torch.Tensor) else a for a in args)
        return func(*args, **kwargs)
