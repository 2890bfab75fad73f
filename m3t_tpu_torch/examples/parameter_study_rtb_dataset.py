"""RTB parameter study (port of examples/parameter_study_rtb_dataset.py; reference
M3T/examples/parameter_study_rtb_dataset.cpp).

Grid values are the published Mb-ICG RTB evaluation configuration
(parameter_study_rtb_dataset.cpp:25-70); extend any list to sweep.  Tracker
objects come from the dataset's generator YAML configs, so the grids are applied
through the evaluator's tracker_setter over the generated object graph.  The
evaluator runs on ``--device`` (the card unless ``--device cpu`` is given).

Usage: python -m m3t_tpu_torch.examples.parameter_study_rtb_dataset <dataset_dir> \
           <external_dir> [--objects gripper ...] [--difficulties test_easy ...] \
           [--mode combined] [--device cuda]
"""

import argparse

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.depth_modality import DepthModality
from m3t_tpu_torch.eval.rtb_evaluator import EvaluationMode, RTBEvaluator
from m3t_tpu_torch.examples.parameter_study_common import run_study
from m3t_tpu_torch.region_modality import RegionModality

OBJECT_NAMES = ["gripper", "medical_pliers", "medical_robot", "picker_robot",
                "robot_fingers", "robot_wrist"]
DIFFICULTY_LEVELS = ["test_easy", "test_medium", "test_hard"]
DEPTH_NAMES = ["depth_ground_truth", "depth_azure_kinect",
               "depth_active_stereo", "depth_stereo"]
SEQUENCE_NUMBERS = list(range(10))

GRIDS = {
    "region_modality": {
        "n_lines_max": [300],
        "use_adaptive_coverage": [True],
        "scales": [[9, 7, 5, 2]],
        "standard_deviations": [[25.0, 15.0, 10.0]],
        "n_histogram_bins": [16],
        "learning_rate_f": [0.2],
        "learning_rate_b": [0.2],
    },
    "depth_modality": {
        "n_points_max": [300],
        "use_adaptive_coverage": [True],
        "use_depth_scaling": [True],
        "stride_length": [0.008],
        "considered_distances": [[0.1, 0.08, 0.05]],
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
    parser.add_argument("--objects", nargs="+", default=OBJECT_NAMES)
    parser.add_argument("--difficulties", nargs="+", default=DIFFICULTY_LEVELS)
    parser.add_argument("--depths", nargs="+", default=DEPTH_NAMES)
    parser.add_argument("--sequences", nargs="+", type=int,
                        default=SEQUENCE_NUMBERS)
    parser.add_argument("--mode", default="combined",
                        choices=[m.name.lower() for m in EvaluationMode])
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    def evaluate_one(run):
        evaluator = RTBEvaluator("study", args.dataset_dir, args.external_dir,
                                 object_names=args.objects,
                                 difficulty_levels=args.difficulties,
                                 depth_names=args.depths,
                                 sequence_numbers=args.sequences,
                                 device=args.device)
        evaluator.evaluation_mode = EvaluationMode[args.mode.upper()]

        def tracker_setter(tracker):
            for key, value in run["tracker"].items():
                setattr(tracker, key, value)
            # The generator built the modalities; apply the grids to each.
            tracker._assemble_derived_object_ptrs()
            for modality in tracker.modality_ptrs:
                if isinstance(modality, RegionModality):
                    for key, value in run["region_modality"].items():
                        setattr(modality, key, value)
                elif isinstance(modality, DepthModality):
                    for key, value in run["depth_modality"].items():
                        setattr(modality, key, value)

        evaluator.tracker_setter = tracker_setter
        return evaluator.Evaluate()

    run_study(GRIDS, evaluate_one, ("add_auc", "adds_auc"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
