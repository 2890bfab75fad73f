"""The device a run uses, what it may not have loaded, and the chip's published peaks."""

from __future__ import annotations

import subprocess
import sys

# NVIDIA H100 SXM data sheet, dense rates: device memory 3.35 TB/s, float32 outside the
# tensor cores 67 TFLOP/s (both at the 700 W power limit).
PEAKS = {"NVIDIA H100": {"bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12}}
FORBIDDEN = ("jax", "jaxlib", "flax", "m3t_tpu")


class NoDevice(RuntimeError):
    pass


def require_cards(n: int):
    """The first card, or NoDevice when fewer than ``n`` cards are visible."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"{torch.cuda.device_count()} cards visible, the cell asks for {n}")
    return torch.device("cuda", 0)


def peaks(kind: str) -> dict | None:
    """The published peaks of a card, or None for a device without them."""
    for prefix, rates in PEAKS.items():
        if kind.startswith(prefix):
            return rates
    return None


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def power_limit_w(index: int = 0) -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout.strip()
        return float(out)
    except (OSError, subprocess.SubprocessError, ValueError):
        return None


def record(device, count: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": device.type, "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device)),
            "power_limit_w": power_limit_w(device.index or 0)}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX
    package's."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))
