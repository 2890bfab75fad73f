"""Colour-histogram operations (port of m3t_tpu/ops/histogram.py).

Foreground/background RGB histograms are ``(..., n_bins**3)`` float32 tensors; the
colour index follows the reference's bitshift scheme exactly
(color_histograms.cpp:61-69: ``idx = (c0 >> s) * n^2 + (c1 >> s) * n + (c2 >> s)``) in
the image's channel order (BGR for colour cameras).  Leading dimensions of a histogram
or a memory are a batch.
"""

from __future__ import annotations

import torch


def color_index(pixels, n_bins: int):
    """Flat histogram index (int32) of uint8 pixels (..., 3)."""
    bitshift = 8 - (n_bins.bit_length() - 1)  # n_bins in {2,4,8,16,32,64}
    p = pixels.to(torch.int32) >> bitshift
    return p[..., 0] * (n_bins * n_bins) + p[..., 1] * n_bins + p[..., 2]


def add_colors(memory, pixels, mask, n_bins: int):
    """Memory plus the masked pixel colours (AddForegroundColor), out of place.

    memory (*lead, N); pixels (*lead, ..., 3) uint8; mask a bool broadcastable to
    pixels[..., 0]."""
    lead = memory.shape[:-1]
    n = memory.shape[-1]
    idx = color_index(pixels, n_bins)
    w = torch.as_tensor(mask, device=memory.device).to(torch.float32).expand(idx.shape)
    rows = idx.reshape(lead.numel(), -1).to(torch.int64)
    rows = rows + n * torch.arange(rows.shape[0], device=rows.device)[:, None]
    return memory.reshape(-1).index_add(0, rows.reshape(-1), w.reshape(-1)).reshape(
        memory.shape)


def calculate_histogram(histogram, memory, learning_rate: float):
    """Reference CalculateHistogram over the last axis: normalized memory blended at
    learning_rate.  With sum == 0: learning_rate == 1 resets to uniform, otherwise the
    histogram is unchanged (color_histograms.cpp:187-195)."""
    n = histogram.shape[-1]
    total = torch.sum(memory, dim=-1, keepdim=True)
    uniform = torch.full_like(histogram, 1.0 / n)
    safe_total = torch.where(total > 0.0, total, torch.ones_like(total))
    blended = histogram * (1.0 - learning_rate) + memory * (learning_rate / safe_total)
    zero_case = uniform if learning_rate == 1.0 else histogram
    return torch.where(total > 0.0, blended, zero_case)


def lookup_probabilities(hist_f, hist_b, pixels, n_bins: int):
    """Per-pixel (p_f, p_b) of (*lead, N) histograms at pixels (*lead, ..., 3),
    normalized as in MultiplyPixelColorProbability (region_modality.cpp:1575-1598):
    p_f + p_b == 1, or 0.5/0.5 where both are 0."""
    idx = color_index(pixels, n_bins).to(torch.int64)
    lead = hist_f.dim() - 1
    flat = idx.reshape(idx.shape[:lead] + (-1,))
    pf = torch.take_along_dim(hist_f, flat, dim=lead).reshape(idx.shape)
    pb = torch.take_along_dim(hist_b, flat, dim=lead).reshape(idx.shape)
    total = pf + pb
    nonzero = total > 0.0
    safe = torch.where(nonzero, total, torch.ones_like(total))
    half = torch.full_like(total, 0.5)
    return torch.where(nonzero, pf / safe, half), torch.where(nonzero, pb / safe, half)
