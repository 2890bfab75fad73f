"""Record a camera sequence to disk (port of examples/record_camera_sequence.py;
reference M3T/examples/record_camera_sequence.cpp).

Frames are saved as PNG files by the port's writer (``utils/png.py``) next to a loader
metafile, so that ``run_on_recorded_sequence --camera-metafile`` replays them.  Nothing
here runs on a card: as in the JAX script, ``--device`` is the index of the video
device that ``cv2.VideoCapture`` opens.

Usage: python -m m3t_tpu_torch.examples.record_camera_sequence <output_dir> [--device N]
       [--n-frames N] [--fps 30]
"""

import argparse
import os
import time

from m3t_tpu_torch.hardware_camera import OpenCVColorCamera


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("output_dir")
    parser.add_argument("--device", type=int, default=0)
    parser.add_argument("--n-frames", type=int, default=300)
    parser.add_argument("--fps", type=float, default=30.0)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    camera = OpenCVColorCamera("color_camera", args.device)
    if not camera.SetUp():
        return 1
    camera.StartSavingImages(args.output_dir)

    # Write a loader metafile so the recording replays directly.
    intr = camera.intrinsics
    with open(os.path.join(args.output_dir, "color_camera.yaml"), "w") as f:
        f.write(f"""%YAML:1.2
load_directory: "."
intrinsics:
  f_u: {intr.fu}
  f_v: {intr.fv}
  pp_x: {intr.ppu}
  pp_y: {intr.ppv}
  width: {intr.width}
  height: {intr.height}
image_name_pre: "color_camera_image_"
load_index: 0
n_leading_zeros: 0
image_name_post: ""
load_image_type: "png"
""")

    period = 1.0 / args.fps
    for i in range(args.n_frames):
        begin = time.monotonic()
        if not camera.UpdateImage(True):
            break
        elapsed = time.monotonic() - begin
        if elapsed < period:
            time.sleep(period - elapsed)
    print(f"Recorded {camera.save_index} frames to {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
