"""Run a YAML-configured tracker (port of examples/run_generated_tracker.py; reference
M3T/examples/run_generated_tracker.cpp).

The generator builds every object that holds tensors on ``--device`` (the card unless
``--device cpu`` is given); the tracker serves through the fused cycle where its
metafile sets ``use_fused_cycle``.

Usage: python -m m3t_tpu_torch.examples.run_generated_tracker <config.yaml> [--detect]
       [--track] [--max-iterations N] [--device cuda]
"""

import argparse

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.generator import GenerateConfiguredTracker


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--detect", action="store_true", default=True)
    parser.add_argument("--track", action="store_true", default=True)
    parser.add_argument("--max-iterations", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    tracker = GenerateConfiguredTracker(args.config, device=args.device)
    if not tracker.SetUp():
        print("Tracker setup failed")
        return 1
    ok = tracker.RunTrackerProcess(
        execute_detection=args.detect, start_tracking=args.track,
        max_iterations=args.max_iterations)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
