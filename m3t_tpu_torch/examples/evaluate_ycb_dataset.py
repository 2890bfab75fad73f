"""Evaluate on the YCB-Video dataset (port of examples/evaluate_ycb_dataset.py;
reference M3T/examples/evaluate_ycb_dataset.cpp).

Usage: python -m m3t_tpu_torch.examples.evaluate_ycb_dataset <dataset_dir> <external_dir>
       [--sequences 48 59] [--detector cosypose] [--no-depth] [--texture]
       [--no-multi-region] [--refinement] [--device cuda]
"""

import argparse
import os

from m3t_tpu_torch.eval.ycb_evaluator import YCBEvaluator

# Flagship multi-region variant list (evaluate_ycb_dataset.cpp:35-44): sub-body region
# meshes live under <external>/multi_region/<body>/.
MULTI_REGION_BODY_NAMES = [
    "002_master_chef_can", "004_sugar_box", "005_tomato_soup_can",
    "006_mustard_bottle", "007_tuna_fish_can", "008_pudding_box",
    "009_gelatin_box", "010_potted_meat_can", "021_bleach_cleanser",
    "037_scissors", "040_large_marker", "003_cracker_box",
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--sequences", nargs=2, type=int, default=[48, 59])
    parser.add_argument("--detector", default="cosypose")
    parser.add_argument("--no-depth", action="store_true")
    parser.add_argument("--texture", action="store_true")
    parser.add_argument("--no-multi-region", action="store_true",
                        help="disable the multi-region body variants")
    parser.add_argument("--refinement", action="store_true",
                        help="evaluate detector-pose refinement instead of "
                             "tracking (ycb_evaluator.cpp:317-345)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    multi_region_body_names = [] if args.no_multi_region else MULTI_REGION_BODY_NAMES
    sequence_ids = list(range(args.sequences[0], args.sequences[1] + 1))
    # Body lists per sequence come from the dataset's per-sequence index files; users
    # can also pass an explicit mapping when constructing YCBEvaluator.
    sequence2body_names = {}
    for seq in sequence_ids:
        index_path = os.path.join(args.dataset_dir, "data", f"{seq:04d}",
                                  "body_names.txt")
        if os.path.exists(index_path):
            with open(index_path) as f:
                sequence2body_names[seq] = [line.strip() for line in f if line.strip()]
        else:
            sequence2body_names[seq] = []

    evaluator = YCBEvaluator("ycb_evaluator", args.dataset_dir, args.external_dir,
                             sequence_ids, sequence2body_names,
                             detector_folder=args.detector,
                             multi_region_body_names=multi_region_body_names,
                             device=args.device)
    evaluator.use_depth_modality = not args.no_depth
    evaluator.use_texture_modality = args.texture
    evaluator.evaluate_refinement = args.refinement

    # Reference YCB configuration (evaluate_ycb_dataset.cpp:46-117).
    def region_modality_setter(modality):
        modality.n_lines_max = 200
        modality.scales = [7, 4, 2]
        modality.standard_deviations = [25.0, 15.0, 10.0]

    def depth_modality_setter(modality):
        modality.n_points_max = 200
        modality.considered_distances = [0.07, 0.05, 0.04]

    def tracker_setter(tracker):
        tracker.n_corr_iterations = 4
        tracker.n_update_iterations = 2

    evaluator.region_modality_setter = region_modality_setter
    evaluator.depth_modality_setter = depth_modality_setter
    evaluator.tracker_setter = tracker_setter

    results = evaluator.Evaluate()
    print(f"ADD AUC = {results['add_auc']:.4f}, ADD-S AUC = {results['adds_auc']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
