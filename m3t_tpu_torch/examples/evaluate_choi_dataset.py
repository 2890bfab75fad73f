"""Evaluate on the Choi RGB-D dataset (port of examples/evaluate_choi_dataset.py;
reference M3T/examples/evaluate_choi_dataset.cpp).

Usage: python -m m3t_tpu_torch.examples.evaluate_choi_dataset <dataset_dir> <external_dir>
       [--bodies kinect_box milk ...] [--save results.json] [--device cuda]
"""

import argparse
import json

from m3t_tpu_torch.eval.choi_evaluator import ChoiEvaluator

ALL_BODIES = ["kinect_box", "milk", "orange_juice", "tide"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--bodies", nargs="+", default=ALL_BODIES)
    parser.add_argument("--save", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    evaluator = ChoiEvaluator("choi_evaluator", args.dataset_dir, args.external_dir,
                              body_names=args.bodies, device=args.device)

    # Reference Choi configuration (evaluate_choi_dataset.cpp:19-49).
    def region_modality_setter(m):
        m.n_lines_max = 200
        m.scales = [2, 1]
        m.standard_deviations = [5.0]

    def depth_modality_setter(m):
        m.n_points_max = 200
        m.use_depth_scaling = False
        m.stride_length = 0.005
        m.considered_distances = [0.01]
        m.standard_deviations = [0.01, 0.001]

    evaluator.region_modality_setter = region_modality_setter
    evaluator.depth_modality_setter = depth_modality_setter
    results = evaluator.Evaluate()
    if args.save:
        with open(args.save, "w") as f:
            json.dump(results, f, indent=2, default=float)
    for body, r in results.get("per_body", {}).items():
        print(f"{body}: rmse_x = {r.get('rmse_x', 0.0):.3f} mm, "
              f"rmse_alpha = {r.get('rmse_alpha', 0.0):.3f} deg")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
