"""Evaluate on the RTB robot dataset (port of examples/evaluate_rtb_dataset.py;
reference M3T/examples/evaluate_rtb_dataset.cpp).

Multi-body kinematic structures (Mb-ICG): trackers are built from each object's YAML
tracker_config (generator path), tracked over 6 robots x 3 difficulties x 4 depth
qualities x 10 sequences (Mb-ICG/readme.md:60-66).

Usage: python -m m3t_tpu_torch.examples.evaluate_rtb_dataset <dataset_dir> <external_dir>
       [--objects gripper ...] [--difficulties test_easy ...]
       [--depths depth_ground_truth ...] [--sequences 0 1 ...]
       [--mode combined|independent|projected|constrained] [--save results.json]
       [--device cuda]
"""

import argparse
import json

from m3t_tpu_torch.eval.rtb_evaluator import EvaluationMode, RTBEvaluator

ALL_OBJECTS = ["gripper", "medical_pliers", "medical_robot", "picker",
               "robot_fingers", "robot_wrist"]
ALL_DIFFICULTIES = ["test_easy", "test_medium", "test_hard"]
ALL_DEPTHS = ["depth_ground_truth", "depth_azure_kinect", "depth_active_stereo",
              "depth_stereo"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--objects", nargs="+", default=ALL_OBJECTS)
    parser.add_argument("--difficulties", nargs="+", default=ALL_DIFFICULTIES)
    parser.add_argument("--depths", nargs="+", default=ALL_DEPTHS)
    parser.add_argument("--sequences", nargs="+", type=int, default=list(range(10)))
    parser.add_argument("--mode", default="combined",
                        choices=[m.name.lower() for m in EvaluationMode])
    parser.add_argument("--save", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    evaluator = RTBEvaluator("rtb_evaluator", args.dataset_dir, args.external_dir,
                             object_names=args.objects,
                             difficulty_levels=args.difficulties,
                             depth_names=args.depths, sequence_numbers=args.sequences,
                             device=args.device)
    evaluator.evaluation_mode = EvaluationMode[args.mode.upper()]

    # Reference RTB configuration (evaluate_rtb_dataset.cpp:27-66): tracker-level
    # iteration counts; modality parameters come from each object's tracker_config YAML.
    def tracker_setter(tracker):
        tracker.n_corr_iterations = 6
        tracker.n_update_iterations = 2

    evaluator.tracker_setter = tracker_setter
    results = evaluator.Evaluate()
    if args.save:
        with open(args.save, "w") as f:
            json.dump({f"{k}": v for k, v in results["per_run"].items()}, f,
                      indent=2, default=float)
    print(f"RTB mean ADD AUC: {results.get('add_auc', 0.0):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
