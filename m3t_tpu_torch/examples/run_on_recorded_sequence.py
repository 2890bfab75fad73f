"""Track a body over a recorded colour sequence (port of
examples/run_on_recorded_sequence.py; reference M3T/examples/run_on_recorded_sequence.cpp).

The frames are PNG files read by the port's reader (``camera.LoaderColorCamera``); the
region modality holds its tensors on ``--device`` (the card unless ``--device cpu`` is
given) and the tracker serves through the fused cycle unless ``--host-path`` is given.

Usage: python -m m3t_tpu_torch.examples.run_on_recorded_sequence <sequence_dir>
       <body.obj> <detector.yaml> <external_dir> [--camera-metafile camera.yaml]
       [--n-frames N] [--viewer] [--host-path] [--n-divides 4] [--n-points 200]
       [--model-image-size 2000] [--device cuda]
"""

import argparse

import numpy as np

from m3t_tpu_torch.body import Body
from m3t_tpu_torch.camera import LoaderColorCamera
from m3t_tpu_torch.common import Intrinsics, resolve_device
from m3t_tpu_torch.detector import StaticDetector
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.optimizer import Optimizer
from m3t_tpu_torch.region_modality import RegionModality
from m3t_tpu_torch.region_model import RegionModel
from m3t_tpu_torch.renderer_geometry import RendererGeometry
from m3t_tpu_torch.tracker import Tracker
from m3t_tpu_torch.viewer import NormalColorViewer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("sequence_dir")
    parser.add_argument("geometry_path")
    parser.add_argument("detector_metafile")
    parser.add_argument("external_dir")
    parser.add_argument("--camera-metafile", default=None)
    parser.add_argument("--n-frames", type=int, default=None)
    parser.add_argument("--viewer", action="store_true")
    parser.add_argument("--host-path", action="store_true",
                        help="force the per-modality object-graph loop")
    parser.add_argument("--n-divides", type=int, default=4,
                        help="sparse viewpoint model subdivisions (model.h:161)")
    parser.add_argument("--n-points", type=int, default=200)
    parser.add_argument("--model-image-size", type=int, default=2000)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def build_tracker(args: argparse.Namespace):
    """(tracker, body): the graph that ``args`` describe, not yet set up."""
    if args.camera_metafile:
        camera = LoaderColorCamera("camera", metafile_path=args.camera_metafile)
    else:
        camera = LoaderColorCamera(
            "camera", load_directory=args.sequence_dir,
            intrinsics=Intrinsics(615.0, 615.0, 320.0, 240.0, 640, 480),
            image_name_pre="color_camera_image_")
    body = Body("body", geometry_path=args.geometry_path,
                geometry_unit_in_meter=1.0)

    model = RegionModel("body_region_model", body,
                        f"{args.external_dir}/body_region_model.npz",
                        n_divides=args.n_divides, n_points=args.n_points,
                        image_size=args.model_image_size)
    modality = RegionModality("body_region_modality", body, camera, model,
                              device=args.device)
    link = Link("body_link", body)
    link.AddModality(modality)
    optimizer = Optimizer("body_optimizer", link)
    detector = StaticDetector("body_detector", optimizer,
                              metafile_path=args.detector_metafile)

    # Serve through the fused cycle on the card by default (fused_serve.py);
    # --host-path forces the per-modality object-graph loop.
    tracker = Tracker("tracker", use_fused_cycle=not args.host_path)
    tracker.AddOptimizer(optimizer)
    tracker.AddDetector(detector)
    if args.viewer:
        rg = RendererGeometry("rg", device=args.device)
        rg.AddBody(body)
        tracker.AddViewer(NormalColorViewer("viewer", camera, rg))
    return tracker, body


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    tracker, body = build_tracker(args)
    if not tracker.SetUp():
        return 1
    ok = tracker.RunTrackerProcess(execute_detection=True, start_tracking=True,
                                   max_iterations=args.n_frames)
    print("final body2world_pose:\n", np.asarray(body.body2world_pose))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
