"""OPT parameter study (port of examples/parameter_study_opt_dataset.py; reference
M3T/examples/parameter_study_opt_dataset.cpp).

Grid values are the published OPT evaluation configuration
(parameter_study_opt_dataset.cpp:27-60); extend any list to sweep.  The evaluator
runs on ``--device`` (the card unless ``--device cpu`` is given).

Usage: python -m m3t_tpu_torch.examples.parameter_study_opt_dataset <dataset_dir> \
           <external_dir> [--bodies soda jet ...] [--patterns tr_1 zo_1 ...] \
           [--device cuda]
"""

import argparse

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.examples.parameter_study_common import make_setter, run_study

BODY_NAMES = ["soda", "chest", "ironman", "house", "bike", "jet"]
BODY_ORIENTATIONS = ["b", "f", "l", "r"]
MOTION_PATTERNS = ["tr_1", "tr_2", "tr_3", "tr_4", "tr_5",
                   "zo_1", "zo_2", "zo_3", "zo_4", "zo_5",
                   "ir_1", "ir_2", "ir_3", "ir_4", "ir_5",
                   "or_1", "or_2", "or_3", "or_4", "or_5",
                   "fl", "ml", "fm"]

GRIDS = {
    "region_modality": {
        "n_lines_max": [200],
        "min_continuous_distance": [3.0],
        "function_length": [8],
        "distribution_length": [12],
        "function_amplitude": [0.43],
        "function_slope": [0.5],
        "learning_rate": [1.3],
        "scales": [[6, 4, 1]],
        "standard_deviations": [[15.0, 5.0, 1.5]],
        "n_histogram_bins": [16],
        "learning_rate_f": [0.2],
        "learning_rate_b": [0.2],
        "unconsidered_line_length": [0.5],
        "max_considered_line_length": [20.0],
    },
    "depth_modality": {
        "n_points_max": [200],
        "use_depth_scaling": [False],
        "stride_length": [0.005],
        "considered_distances": [[0.05, 0.02, 0.01]],
        "standard_deviations": [[0.05, 0.03, 0.02]],
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
    parser.add_argument("--orientations", nargs="+", default=BODY_ORIENTATIONS)
    parser.add_argument("--patterns", nargs="+", default=MOTION_PATTERNS)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    def evaluate_one(run):
        from m3t_tpu_torch.eval.opt_evaluator import OPTEvaluator

        # The evaluator composes "<body[:2]>_<pattern>_<orientation>" sequence
        # names itself (opt_evaluator.cpp:504-506).
        evaluator = OPTEvaluator("study", args.dataset_dir, args.external_dir,
                                 body_names=args.bodies,
                                 body_orientations=args.orientations,
                                 motion_patterns=args.patterns,
                                 device=args.device)
        evaluator.region_modality_setter = make_setter(run["region_modality"])
        evaluator.depth_modality_setter = make_setter(run["depth_modality"])
        evaluator.tracker_setter = make_setter(run["tracker"])
        return evaluator.Evaluate()

    run_study(GRIDS, evaluate_one, ("auc",))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
