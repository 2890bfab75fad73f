"""ColorHistograms component (port of m3t_tpu/color_histograms.py).

Histograms and memories are (n_bins**3,) float32 tensors on the device the object was
made for; building and updating go through :mod:`m3t_tpu_torch.ops.histogram`.
Shareable across modalities like the reference (color_histograms.h:17-28).
"""

from __future__ import annotations

import torch

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.ops import histogram as hist_ops
from m3t_tpu_torch.utils import yaml_io

_VALID_N_BINS = (2, 4, 8, 16, 32, 64)


class ColorHistograms:
    def __init__(self, name: str, n_bins: int = 16, learning_rate_f: float = 0.2,
                 learning_rate_b: float = 0.2, metafile_path: str | None = None,
                 device="cuda"):
        self.name = name
        self.metafile_path = metafile_path
        self.device = resolve_device(device)
        self.n_bins = int(n_bins)
        self.learning_rate_f = float(learning_rate_f)
        self.learning_rate_b = float(learning_rate_b)
        self.histogram_f = None
        self.histogram_b = None
        self.memory_f = None
        self.memory_b = None
        self.set_up = False

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            fs = yaml_io.open_yaml_file_storage(self.metafile_path)
            self.n_bins = int(yaml_io.read_optional(fs, "n_bins", self.n_bins))
            self.learning_rate_f = float(
                yaml_io.read_optional(fs, "learning_rate_f", self.learning_rate_f))
            self.learning_rate_b = float(
                yaml_io.read_optional(fs, "learning_rate_b", self.learning_rate_b))
        if self.n_bins not in _VALID_N_BINS:
            print(f"n_bins = {self.n_bins} in histogram {self.name} not valid. "
                  f"Has to be of value 2, 4, 8, 16, 32, or 64")
            return False
        n = self.n_bins ** 3
        self.histogram_f = torch.full((n,), 1.0 / n, dtype=torch.float32,
                                      device=self.device)
        self.histogram_b = torch.full((n,), 1.0 / n, dtype=torch.float32,
                                      device=self.device)
        self.memory_f = torch.zeros((n,), dtype=torch.float32, device=self.device)
        self.memory_b = torch.zeros((n,), dtype=torch.float32, device=self.device)
        self.set_up = True
        return True

    def ClearMemory(self) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up color histogram {self.name} first")
            return False
        self.memory_f = torch.zeros_like(self.memory_f)
        self.memory_b = torch.zeros_like(self.memory_b)
        return True

    def _pixels(self, pixels):
        return torch.as_tensor(pixels, device=self.device)

    def AddForegroundColors(self, pixels, mask=True) -> None:  # noqa: N802
        self.memory_f = hist_ops.add_colors(self.memory_f, self._pixels(pixels), mask,
                                            self.n_bins)

    def AddBackgroundColors(self, pixels, mask=True) -> None:  # noqa: N802
        self.memory_b = hist_ops.add_colors(self.memory_b, self._pixels(pixels), mask,
                                            self.n_bins)

    def InitializeHistograms(self) -> bool:  # noqa: N802
        """Learning rate 1 build + memory clear (color_histograms.cpp:72-82)."""
        if not self.set_up:
            print(f"Set up color histogram {self.name} first")
            return False
        self.histogram_f = hist_ops.calculate_histogram(self.histogram_f, self.memory_f, 1.0)
        self.histogram_b = hist_ops.calculate_histogram(self.histogram_b, self.memory_b, 1.0)
        return self.ClearMemory()

    def UpdateHistograms(self) -> bool:  # noqa: N802
        """Online adaptation at the configured learning rates (cpp:84-93)."""
        if not self.set_up:
            print(f"Set up color histogram {self.name} first")
            return False
        self.histogram_f = hist_ops.calculate_histogram(
            self.histogram_f, self.memory_f, self.learning_rate_f)
        self.histogram_b = hist_ops.calculate_histogram(
            self.histogram_b, self.memory_b, self.learning_rate_b)
        return self.ClearMemory()

    def GetProbabilities(self, pixel_color):  # noqa: N802
        return hist_ops.lookup_probabilities(self.histogram_f, self.histogram_b,
                                             self._pixels(pixel_color), self.n_bins)
