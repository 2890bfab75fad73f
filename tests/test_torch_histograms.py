"""Parity tests: the port's colour-histogram operations and its ColorHistograms
component against the JAX package's (m3t_tpu.ops.histogram, m3t_tpu.color_histograms),
on the CPU.  Bins and counts are exact; float32 values within atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from m3t_tpu.color_histograms import ColorHistograms as JColorHistograms
from m3t_tpu.ops import histogram as jhist
from m3t_tpu_torch.color_histograms import ColorHistograms as TColorHistograms
from m3t_tpu_torch.ops import histogram as thist

ATOL = 1e-6


def _pixels(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, size=shape + (3,), dtype=np.uint8)


@pytest.mark.parametrize("n_bins", [2, 16, 64])
def test_color_index_matches_jax(n_bins):
    px = _pixels(0, (7, 33))
    np.testing.assert_array_equal(thist.color_index(torch.as_tensor(px), n_bins).numpy(),
                                  np.asarray(jhist.color_index(px, n_bins)))


@pytest.mark.parametrize("mask_kind", ["array", "scalar"])
def test_add_colors_matches_jax(mask_kind):
    n_bins = 16
    px = _pixels(1, (40, 21))
    mask = (np.random.default_rng(2).random((40, 21)) > 0.3 if mask_kind == "array"
            else True)
    memory = np.random.default_rng(3).integers(0, 5, n_bins ** 3).astype(np.float32)
    want = np.asarray(jhist.add_colors(jnp.asarray(memory), px, mask, n_bins))
    got = thist.add_colors(torch.as_tensor(memory), torch.as_tensor(px), mask, n_bins)
    np.testing.assert_array_equal(got.numpy(), want)
    # A leading batch: each memory row gets its own row's pixels.
    memories = np.stack([memory, memory[::-1].copy()])
    pixels = np.stack([px, px[::-1]])
    masks = np.stack([mask, mask]) if mask_kind == "array" else mask
    got_b = thist.add_colors(torch.as_tensor(memories), torch.as_tensor(pixels), masks,
                             n_bins)
    for b in range(2):
        row_mask = masks[b] if mask_kind == "array" else mask
        want_b = np.asarray(jhist.add_colors(jnp.asarray(memories[b]), pixels[b],
                                             row_mask, n_bins))
        np.testing.assert_array_equal(got_b[b].numpy(), want_b)


def test_lookup_probabilities_matches_jax():
    n_bins = 8
    rng = np.random.default_rng(4)
    hist_f = rng.random(n_bins ** 3).astype(np.float32)
    hist_b = rng.random(n_bins ** 3).astype(np.float32)
    hist_f[:40] = 0.0
    hist_b[:20] = 0.0  # bins where both are 0 give 0.5 / 0.5
    px = _pixels(5, (300,))
    px[:50] = 0
    want = jhist.lookup_probabilities(jnp.asarray(hist_f), jnp.asarray(hist_b), px, n_bins)
    got = thist.lookup_probabilities(torch.as_tensor(hist_f), torch.as_tensor(hist_b),
                                     torch.as_tensor(px), n_bins)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    # Batched histograms, pixels per row.
    got_b = thist.lookup_probabilities(
        torch.as_tensor(np.stack([hist_f, hist_b])), torch.as_tensor(np.stack([hist_b, hist_f])),
        torch.as_tensor(np.stack([px, px])), n_bins)
    np.testing.assert_allclose(got_b[0][0].numpy(), np.asarray(want[0]), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_b[0][1].numpy(), np.asarray(want[1]), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n_bins", [4, 16])
def test_color_histograms_component_matches_jax(n_bins):
    """SetUp, AddForeground/BackgroundColors, InitializeHistograms, ClearMemory,
    UpdateHistograms and GetProbabilities, step by step."""
    j = JColorHistograms("h", n_bins, 0.2, 0.3)
    t = TColorHistograms("h", n_bins, 0.2, 0.3, device="cpu")
    assert j.SetUp() and t.SetUp()

    def same():
        for name in ("histogram_f", "histogram_b", "memory_f", "memory_b"):
            np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=0, atol=ATOL, err_msg=name)

    same()
    for step in range(3):
        fg, bg = _pixels(10 + step, (64, 5)), _pixels(20 + step, (80,))
        mask = np.random.default_rng(30 + step).random((64, 5)) > 0.5
        for h in (j, t):
            h.AddForegroundColors(fg, mask)
            h.AddBackgroundColors(bg)
        same()
        assert j.InitializeHistograms() if step == 0 else j.UpdateHistograms()
        assert t.InitializeHistograms() if step == 0 else t.UpdateHistograms()
        same()
    # An empty update keeps the histograms (learning rate < 1); clearing zeroes memory.
    assert j.UpdateHistograms() and t.UpdateHistograms()
    assert j.ClearMemory() and t.ClearMemory()
    same()
    px = _pixels(40, (50,))
    for g, w in zip(t.GetProbabilities(px), j.GetProbabilities(px)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_color_histograms_refuse_bad_bins_and_need_set_up():
    t = TColorHistograms("h", 12, device="cpu")
    assert not t.SetUp()
    assert not TColorHistograms("h", device="cpu").ClearMemory()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TColorHistograms("h")
