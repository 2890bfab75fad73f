"""Run one cell of BENCHMARK.json on this machine's cards and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (``setup_s``: from the start of this process to the first timed step) builds the
cell's inputs from the seed, loads the models, starts the tracks and warms up every
shape the window uses, graphs captured.  The window then runs closed-loop steps for
``--seconds``.  With ``--trace 1`` a stretch of steps after the window is profiled and
the result carries the per-layer metrics instead of the end-to-end ones; the window of
a traced run marks the device's stream with CUDA events.  After the window
the program's state is freed and the plain reference recomputes the sampled steps; the
numbers compared, each beside its limit, end standard error and the result line.

Exit codes: 0 with a result line; 2 without the cards the cell asks for; 1 on any other
fault, also when a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if __name__ == "__main__":
    # Run as a script, the benchmark's own directory is first on the path; the
    # repository root is where ``benchmark`` and the program are found.
    sys.path[0] = str(REPO)
# Libraries that would load JAX by themselves are kept from doing so.
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


class Run:
    """What the metric readers read: the window's steps, set-up, the trace and the
    kernels' work."""

    def __init__(self, driver, setup_s, step_s, trace=None, work=None, peaks=None,
                 device_split=None):
        self.driver, self.setup_s, self.step_s = driver, setup_s, step_s
        self.window_s = sum(step_s)
        self.trace, self.work, self.peaks = trace, work, peaks
        # (cycle seconds, marked seconds) of the untraced window by the device's clock.
        self.device_split = device_split


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def window(driver, seconds: float, traffic: dict, traced: bool):
    """Closed-loop steps for ``seconds`` (and at least until the last checkpoint has
    passed): each step's host seconds, and with ``traced`` the reduction of a profiled
    stretch of ``trace_steps`` more steps at the end.  The stretch comes last because the
    profiler slows every later graph launch."""
    import torch

    from benchmark.harness import trace

    least = max(max(driver.checkpoints) + 1, 2)
    profiler, first, step_s = None, None, []
    driver.open_window()
    driver.time_device(traced)
    now = begin = time.perf_counter()
    while now - begin < seconds or len(step_s) < least or (
            traced and (first is None or len(step_s) < first + traffic["trace_steps"])):
        if traced and first is None and now - begin >= seconds and len(step_s) >= least:
            first = len(step_s)
            driver.mark("step")
            split = driver.device_split()
            driver.time_device(False)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
        with trace.step_range(profiler is not None):
            driver.step(profiler is not None)
        end = time.perf_counter()
        step_s.append(end - now)
        now = end
    if profiler is None:
        return step_s, None, None
    profiler.__exit__(None, None, None)
    return step_s, trace.reduce(profiler.events()), split


def _thirds(values):
    n = max(len(values) // 3, 1)
    return [values[:n], values[n:-n] or values, values[-n:]]


def measure(args, out=sys.stdout, card=None, side=None) -> int:
    """One run; ``card`` and ``side`` (tests only) put a device in place of the cards
    and something in the program's place."""
    from benchmark.harness import check, device, spec

    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    config, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    if card is None:
        try:
            card = device.require_cards(cell["chips"])
        except device.NoDevice as err:
            print(f"run: {err}", file=sys.stderr)
            return 2
    driver = spec.load_module("drivers", cell["driver"]).Driver(
        cell, config, traffic, args.seed, card, side)
    with contextlib.redirect_stdout(sys.stderr):
        driver.setup()
        device.synchronize(card)
        setup_s = time.perf_counter() - T0
        step_s, reduced, split = window(driver, args.seconds, traffic, bool(args.trace))
        print(f"window: {len(step_s)} steps in {sum(step_s):.6f} s; step ms by thirds "
              f"{[round(sum(t) / len(t) * 1e3, 4) for t in _thirds(step_s)]}; quartiles "
              f"{[round(q * 1e3, 4) for q in statistics.quantiles(step_s, n=4)]}; "
              f"set-up {setup_s:.3f} s", file=sys.stderr)
        record = device.record(card, cell["chips"])
        work = driver.kernel_work() if args.trace else None
        attempted, failed = driver.outcome()
        driver.free()
        readings = driver.readings()
    found = device.forbidden_modules()
    if found:
        print(f"run: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 1
    print("readings: " + json.dumps(readings), file=sys.stderr)
    correct, compared = check.verdict(readings, cell["limits"])
    run = Run(driver, setup_s, step_s, reduced, work, device.peaks(record["kind"]), split)
    metrics = {}
    for metric in spec.metrics(bench, args.workload, bool(args.trace)):
        value = spec.load_module("metrics", metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": record}
    if reduced is not None:
        record.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
        result["breakdown"] = reduced.breakdown()
    result["compared"] = compared
    for name, pair in compared.items():
        print(f"compared {name}: {pair['value']!r} limit {pair['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    return measure(parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
