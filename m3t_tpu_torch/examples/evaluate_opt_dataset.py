"""Evaluate on the OPT dataset (port of examples/evaluate_opt_dataset.py; reference
M3T/examples/evaluate_opt_dataset.cpp).

Usage: python -m m3t_tpu_torch.examples.evaluate_opt_dataset <dataset_dir> <external_dir>
       [--bodies soda chest ...] [--orientations b f l r] [--patterns tr_1 ...]
       [--save results.json] [--device cuda]
"""

import argparse

from m3t_tpu_torch.eval.opt_evaluator import (BODY_ORIENTATIONS, MOTION_PATTERNS,
                                              OPTEvaluator)

ALL_BODIES = ["soda", "chest", "ironman", "house", "bike", "jet"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--bodies", nargs="+", default=ALL_BODIES)
    parser.add_argument("--orientations", nargs="+", default=BODY_ORIENTATIONS)
    parser.add_argument("--patterns", nargs="+", default=MOTION_PATTERNS)
    parser.add_argument("--save", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    evaluator = OPTEvaluator("opt_evaluator", args.dataset_dir, args.external_dir,
                             body_names=args.bodies, body_orientations=args.orientations,
                             motion_patterns=args.patterns, device=args.device)

    # Reference OPT configuration (evaluate_opt_dataset.cpp:24-47).
    def region_modality_setter(m):
        m.n_lines_max = 200
        m.scales = [6, 4, 1]
        m.standard_deviations = [15.0, 5.0, 1.5]

    def depth_modality_setter(m):
        m.n_points_max = 200
        m.use_depth_scaling = False
        m.stride_length = 0.005
        m.considered_distances = [0.05, 0.02, 0.01]
        m.standard_deviations = [0.035, 0.035, 0.025]

    evaluator.region_modality_setter = region_modality_setter
    evaluator.depth_modality_setter = depth_modality_setter
    results = evaluator.Evaluate()
    if args.save:
        evaluator.SaveResults(args.save)
    print(f"OPT mean AUC: {results.get('auc', 0.0):.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
