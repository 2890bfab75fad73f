"""Choi parameter study (port of examples/parameter_study_choi_dataset.py; reference
M3T/examples/parameter_study_choi_dataset.cpp).

Grid values are the published Choi evaluation configuration
(parameter_study_choi_dataset.cpp:23-60); extend any list to sweep.  The evaluator
runs on ``--device`` (the card unless ``--device cpu`` is given).

Usage: python -m m3t_tpu_torch.examples.parameter_study_choi_dataset <dataset_dir> \
           <external_dir> [--bodies kinect_box milk ...] [--device cuda]
"""

import argparse

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.examples.parameter_study_common import make_setter, run_study

BODY_NAMES = ["kinect_box", "milk", "orange_juice", "tide"]

GRIDS = {
    "region_modality": {
        "n_lines_max": [200],
        "min_continuous_distance": [3.0],
        "function_length": [8],
        "distribution_length": [12],
        "function_amplitude": [0.43],
        "function_slope": [0.5],
        "learning_rate": [1.3],
        "scales": [[2, 1]],
        "standard_deviations": [[5.0]],
        "n_histogram_bins": [16],
        "learning_rate_f": [0.2],
        "learning_rate_b": [0.2],
        "unconsidered_line_length": [0.5],
        "max_considered_line_length": [20.0],
        "measured_depth_offset_radius": [0.01],
        "measured_occlusion_radius": [0.01],
        "measured_occlusion_threshold": [0.03],
    },
    "depth_modality": {
        "n_points_max": [200],
        "use_depth_scaling": [False],
        "stride_length": [0.005],
        "considered_distances": [[0.05, 0.02, 0.01]],
        "standard_deviations": [[0.05, 0.03, 0.02]],
        "measured_depth_offset_radius": [0.01],
        "measured_occlusion_radius": [0.01],
        "measured_occlusion_threshold": [0.03],
    },
    "optimizer": {
        "tikhonov_parameter_rotation": [1000.0],
        "tikhonov_parameter_translation": [30000.0],
    },
    "tracker": {
        "n_corr_iterations": [4],
        "n_update_iterations": [2],
    },
}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--bodies", nargs="+", default=BODY_NAMES)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    def evaluate_one(run):
        from m3t_tpu_torch.eval.choi_evaluator import ChoiEvaluator

        evaluator = ChoiEvaluator("study", args.dataset_dir, args.external_dir,
                                  body_names=args.bodies, device=args.device)
        evaluator.region_modality_setter = make_setter(run["region_modality"])
        evaluator.depth_modality_setter = make_setter(run["depth_modality"])
        evaluator.tracker_setter = make_setter(run["tracker"])
        results = evaluator.Evaluate()
        per_body = results["per_body"]
        # Aggregate: mean translational RMSE (mm) over bodies and axes; negate so
        # run_study's max() picks the smallest error.
        import numpy as np

        mean_rmse = float(np.mean([
            [r["rmse_x"], r["rmse_y"], r["rmse_z"]] for r in per_body.values()]))
        return {"neg_mean_rmse_mm": -mean_rmse, "mean_rmse_mm": mean_rmse}

    run_study(GRIDS, evaluate_one, ("neg_mean_rmse_mm", "mean_rmse_mm"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
