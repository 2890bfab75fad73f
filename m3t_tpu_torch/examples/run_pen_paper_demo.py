"""AR drawing demo with a custom Publisher (port of examples/run_pen_paper_demo.py;
reference M3T/examples/run_pen_paper_demo.cpp:11-62, the only Publisher example).

Tracks a "pen" body and draws its projected tip trajectory onto the camera image —
demonstrating the Publisher extension point called at the end of every cycle.  The
tracker is generated on ``--device`` (the card unless ``--device cpu`` is given); the
tip is projected in host numpy float32.  The drawing is shown only where OpenCV imports
and a window can open.

Usage: python -m m3t_tpu_torch.examples.run_pen_paper_demo <config.yaml> [--tip 0 0 0.1]
       [--max-iterations N] [--device cuda]
"""

import argparse
import os
import sys

import numpy as np

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.publisher import Publisher


def can_open_window() -> bool:
    """Whether a window can open: on Linux only with a display server to draw on
    (OpenCV's Qt backend aborts the process, not raises, when it finds none)."""
    if not sys.platform.startswith("linux"):
        return True
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


class DrawingPublisher(Publisher):
    """Projects a body-frame tip point each cycle and accumulates the trajectory."""

    def __init__(self, name: str, body, camera, tip_f_body):
        super().__init__(name)
        self.body = body
        self.camera = camera
        self.tip_f_body = np.asarray(tip_f_body, np.float32)
        self.trajectory: list[tuple[int, int]] = []

    def UpdatePublisher(self, iteration: int) -> bool:  # noqa: N802
        pose = (np.asarray(self.camera.world2camera_pose, np.float32)
                @ np.asarray(self.body.body2world_pose, np.float32))
        tip = pose[:3, :3] @ self.tip_f_body + pose[:3, 3]
        if tip[2] <= 0:
            return True
        intr = self.camera.intrinsics
        u = int(tip[0] * intr.fu / tip[2] + intr.ppu + 0.5)
        v = int(tip[1] * intr.fv / tip[2] + intr.ppv + 0.5)
        if 0 <= u < intr.width and 0 <= v < intr.height:
            self.trajectory.append((u, v))
        self._draw()
        return True

    def _draw(self) -> None:
        if not can_open_window():
            return  # headless
        try:
            import cv2
        except ImportError:
            return  # no OpenCV to show the drawing with
        canvas = np.asarray(self.camera.image).copy()
        for i in range(1, len(self.trajectory)):
            cv2.line(canvas, self.trajectory[i - 1], self.trajectory[i], (0, 0, 255), 2)
        try:
            cv2.imshow("pen & paper", canvas)
            cv2.waitKey(1)
        except cv2.error:
            pass  # OpenCV built without a GUI backend


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("config")
    parser.add_argument("--tip", nargs=3, type=float, default=[0.0, 0.0, 0.1])
    parser.add_argument("--max-iterations", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    from m3t_tpu_torch.generator import GenerateConfiguredTracker

    tracker = GenerateConfiguredTracker(args.config, device=args.device)
    if not tracker.SetUp():
        return 1
    body = tracker.body_ptrs[0]
    camera = tracker.camera_ptrs[0]
    publisher = DrawingPublisher("drawing_publisher", body, camera, args.tip)
    tracker.AddPublisher(publisher)
    ok = tracker.RunTrackerProcess(execute_detection=True, start_tracking=True,
                                   max_iterations=args.max_iterations)
    print(f"trajectory points: {len(publisher.trajectory)}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
