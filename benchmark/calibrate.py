"""Readings that the limits of ``correct`` are set from (not run by the benchmark's runs).

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,.. [--control-seeds 21,..]
                                   [--no-warm-up]

For each seed, in one process: the cell's set-up (its warm-up too, so that the states
compared are those a run compares, unless ``--no-warm-up``) and its window's steps up to
the last checkpoint, then the comparison with the plain reference, by the program
(``program``) and, for each control seed, by the control: the reference computed with
TF32 matmuls in the program's place (``control``).  One JSON line per run on standard
output: the seed, the side, each number compared, the gaps of each checkpoint, the
failures and the seconds it took.  The lower reading of a number is the largest over the
program's seeds; the upper the smallest over the control's (PERF.md).
"""

import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path[0] = str(Path(__file__).resolve().parents[1])


def readings(workload: str, seed: int, control: bool, device=None,
             warm_up: bool = True) -> dict:
    """One run's numbers: program (or control) against the reference."""
    import torch

    from benchmark.harness import device as devices
    from benchmark.harness import spec

    cell = spec.cell(workload)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    if not warm_up:
        traffic["warmup_s"] = 0
    card = device or devices.require_cards(cell["chips"])
    module = spec.load_module("drivers", cell["driver"])
    side = (lambda d: module.reference_side(d, tf32=True)) if control else None
    begin = time.perf_counter()
    driver = module.Driver(cell, config, traffic, seed, card, side)
    driver.setup()
    driver.open_window()
    for _ in range(max(driver.checkpoints) + 1):
        driver.step(False)
    attempted, failed = driver.outcome()
    driver.free()
    out = driver.readings()
    by_checkpoint = driver.by_checkpoint
    del driver
    if card.type == "cuda":
        torch.cuda.empty_cache()
    return {"workload": workload, "seed": seed, "side": "control" if control else "program",
            **out, "by_checkpoint": by_checkpoint, "attempted": attempted, "failed": failed,
            "seconds": time.perf_counter() - begin}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--no-warm-up", action="store_true")
    args = parser.parse_args(argv)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        print(json.dumps(readings(args.workload, seed, control,
                                  warm_up=not args.no_warm_up)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
