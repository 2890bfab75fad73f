"""What the drivers share: the closed loop's bookkeeping, failures and checkpoints.

A driver module (``drivers/<driver>.py``) defines ``Driver(cell, config, traffic, seed,
device, side=None)`` with ``setup()``, ``step(traced)``, ``kernel_work()``, ``free()``,
and for ``readings()`` its ``reference()`` (a side with ``start(*start_inputs())`` and
``cycle(*frame_inputs(frame), state)``), and ``program_side``/``reference_side``.
Its ``side`` is what computes a step: the program, or (the ``side`` argument, a function
of the driver) the control or a fault put in its place.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import check
from benchmark.traffic import generator

# RBOT's translation limit (examples/rbot_evaluator.h:39): a body-frame whose pose is
# this far from the truth, or not finite, is a lost track.
LOST_M = 0.05


class ClosedLoop:
    """Steps that each wait for the previous one's poses on the host."""

    units_per_step = 1

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, device,
                 side=None):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.side_factory = side       # driver -> side, in place of the program
        self.seed, self.device = seed, device
        self.t = 0                     # steps since the start, warm-up included
        self.window_start = None       # self.t when the window opened
        self.positions = []            # per window step: (frame, (N, NL, 3) positions)
        self.snapshots = []            # per checkpoint: (frame, state in, state out)
        self.checkpoints = set(generator.checkpoints(traffic, seed))
        self.graph_capture_s = 0.0
        self.marks = None              # [(name, CUDA event)] while the device is timed

    def warm_up(self) -> None:
        """``warmup_steps`` steps (every graph captured), then steps until ``warmup_s``
        seconds of them have passed: the card runs a cycle's kernels up to a tenth
        slower for the first seconds of sustained load (5-20 s on the H100), so the
        window opens on the steady rate."""
        begin = time.perf_counter()
        for _ in range(self.traffic["warmup_steps"]):
            self.step(False)
        while time.perf_counter() - begin < self.traffic["warmup_s"]:
            self.step(False)

    def open_window(self) -> None:
        self.window_start = self.t
        self.positions = []

    def time_device(self, on: bool) -> None:
        """Start (or stop) marking the device's stream: each step's start and the
        cycle's start and end, by CUDA events (on a card only)."""
        self.marks = [] if on and self.device.type == "cuda" else None

    def mark(self, name: str) -> None:
        if self.marks is not None:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((name, event))

    def device_split(self) -> tuple[float, float] | None:
        """(seconds the device spent in the cycles, seconds from the first marked step's
        start to the last mark), both read off the device's own clock, or None."""
        if not self.marks:
            return None
        self.marks[-1][1].synchronize()
        begin = self.marks[0][1]
        span = begin.elapsed_time(self.marks[-1][1]) * 1e-3
        inside, opened = 0.0, None
        for name, event in self.marks:
            if name == "cycle":
                opened = event
            elif name == "cycle_end" and opened is not None:
                inside += opened.elapsed_time(event) * 1e-3
                opened = None
        return inside, span

    def window_step(self) -> int | None:
        """The index of the step about to run within the window, or None before it."""
        return None if self.window_start is None else self.t - self.window_start

    def frame(self, t: int) -> int:
        return generator.pingpong(t, self.traffic["ring_frames"])

    def record(self, frame: int, positions, state_in, state_out, index) -> None:
        if index is None:
            return
        self.positions.append((frame, np.asarray(positions, np.float64)))
        if index in self.checkpoints:
            self.snapshots.append((frame, state_in, state_out))

    def outcome(self, truth) -> tuple[int, int]:
        """(attempted, failed) body-frames of the window: failed where a position is not
        finite or LOST_M or more from the truth of its frame."""
        attempted = failed = 0
        for frame, positions in self.positions:
            err = np.linalg.norm(positions - truth[frame], axis=-1)
            attempted += err.size
            failed += int((~np.isfinite(err) | (err >= LOST_M)).sum())
        return attempted, failed

    def read_capture_s(self) -> None:
        from m3t_tpu_torch import graphs

        self.graph_capture_s = sum(g.warmup_s + g.capture_s for g in graphs.captured())

    def free_program(self) -> None:
        import torch

        from m3t_tpu_torch import graphs

        graphs.clear_graphs()
        torch.cuda.empty_cache()

    def readings(self) -> dict:
        """The gaps to the reference: the histograms of the start, and at every
        checkpoint the pose and histograms that the step made from its input state, by
        body: the widest over the checkpoints' bodies (of the pose's entries, of its
        translation, of its x and y translation, of the histograms' bins), and the median
        of each body's widest.  States are (pose, histogram_f, histogram_b) in that
        order.  Each checkpoint's gaps stay in ``by_checkpoint``."""
        import torch

        ref = self.reference()
        want = ref.start(*self.start_inputs())
        start = torch.maximum(check.gaps(self.start[1], want[1]),
                              check.gaps(self.start[2], want[2]))
        if not self.snapshots:
            raise RuntimeError("the window ended before its first checkpoint")
        pose, trans, xy, hist = [], [], [], []
        for frame, state_in, state_out in self.snapshots:
            want = ref.cycle(*self.frame_inputs(frame), tuple(state_in))
            out = torch.as_tensor(state_out[0])
            pose.append(check.gaps(out, want[0]))
            trans.append(check.gaps(out[:, :3, 3], want[0][:, :3, 3]))
            xy.append(check.gaps(out[:, :2, 3], want[0][:, :2, 3]))
            hist.append(torch.maximum(check.gaps(state_out[1], want[1]),
                                      check.gaps(state_out[2], want[2])))
        pose, trans, xy, hist = (torch.cat(x).cpu() for x in (pose, trans, xy, hist))
        self.by_checkpoint = dict(pose=pose.tolist(), trans=trans.tolist(),
                                  hist=hist.tolist())
        return dict(start_hist_gap=float(start.max()), pose_gap=float(pose.max()),
                    trans_gap=float(trans.max()), xy_gap=float(xy.max()),
                    hist_gap=float(hist.max()), pose_gap_median=check.median(pose),
                    trans_gap_median=check.median(trans),
                    hist_gap_median=check.median(hist))
