"""Live tracking from a camera (port of examples/run_on_camera_sequence.py; reference
M3T/examples/run_on_camera_sequence.cpp).

Uses an attached Azure Kinect / RealSense / generic webcam. Keyboard control in the
viewer window mirrors the reference (d = detect, x = detect+track, t = track, s = stop,
q = quit — tracker.cpp:378-389).  The region modality and the viewer's renderer hold
their tensors on ``--device`` (the card unless ``--device cpu`` is given); the camera
SDKs and ``cv2`` are imported only when the camera opens.

Usage: python -m m3t_tpu_torch.examples.run_on_camera_sequence <body.obj> <detector.yaml>
       <external_dir> [--backend opencv|kinect|realsense] [--unit 1.0] [--device cuda]
"""

import argparse

from m3t_tpu_torch.body import Body
from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.detector import ManualDetector
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.optimizer import Optimizer
from m3t_tpu_torch.region_modality import RegionModality
from m3t_tpu_torch.region_model import RegionModel
from m3t_tpu_torch.renderer_geometry import RendererGeometry
from m3t_tpu_torch.tracker import Tracker
from m3t_tpu_torch.viewer import NormalColorViewer


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("geometry_path")
    parser.add_argument("detector_metafile")
    parser.add_argument("external_dir")
    parser.add_argument("--backend", default="opencv",
                        choices=["opencv", "kinect", "realsense"])
    parser.add_argument("--unit", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def build_tracker(args: argparse.Namespace) -> Tracker:
    """The live graph that ``args`` describe, not yet set up."""
    if args.backend == "kinect":
        from m3t_tpu_torch.hardware_camera import AzureKinectColorCamera

        camera = AzureKinectColorCamera("camera")
    elif args.backend == "realsense":
        from m3t_tpu_torch.hardware_camera import RealSenseColorCamera

        camera = RealSenseColorCamera("camera")
    else:
        from m3t_tpu_torch.hardware_camera import OpenCVColorCamera

        camera = OpenCVColorCamera("camera")

    body = Body("body", geometry_path=args.geometry_path,
                geometry_unit_in_meter=args.unit)
    model = RegionModel("body_region_model", body,
                        f"{args.external_dir}/body_region_model.npz")
    modality = RegionModality("body_region_modality", body, camera, model,
                              device=args.device)
    link = Link("body_link", body)
    link.AddModality(modality)
    optimizer = Optimizer("body_optimizer", link)
    detector = ManualDetector("body_detector", optimizer, camera,
                              metafile_path=args.detector_metafile)
    rg = RendererGeometry("renderer_geometry", device=args.device)
    rg.AddBody(body)
    viewer = NormalColorViewer("viewer", camera, rg)

    # Serve through the fused cycle on the card when the graph is expressible
    # (fused_serve.py); the 33 ms budget check stays in the tracker.
    tracker = Tracker("tracker", use_fused_cycle=True)
    tracker.AddOptimizer(optimizer)
    tracker.AddDetector(detector)
    tracker.AddViewer(viewer)
    return tracker


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)
    tracker = build_tracker(args)
    if not tracker.SetUp():
        return 1
    return 0 if tracker.RunTrackerProcess(execute_detection=True,
                                          start_tracking=True) else 1


if __name__ == "__main__":
    raise SystemExit(main())
