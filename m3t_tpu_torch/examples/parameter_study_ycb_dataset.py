"""YCB-Video parameter study (port of examples/parameter_study_ycb_dataset.py; reference
M3T/examples/parameter_study_ycb_dataset.cpp).

Grid values are the published ICG/ICG+ YCB evaluation configuration
(parameter_study_ycb_dataset.cpp:47-120); extend any list to sweep.  The evaluator
runs on ``--device`` (the card unless ``--device cpu`` is given).

Two faults of the JAX script are kept (ROADMAP Queue C): its fused path (the default)
takes the texture grid alone, the optimizer grid is applied on no path, and every
sequence tracks every body of BODY_NAMES, whose model and pose files must all exist.

Usage: python -m m3t_tpu_torch.examples.parameter_study_ycb_dataset <dataset_dir> \
           <external_dir> [--sequences 48 49 ...] [--use-texture] [--device cuda]
"""

import argparse
import math

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.examples.parameter_study_common import make_setter, run_study

SEQUENCE_IDS = list(range(48, 60))
BODY_NAMES = [
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can", "011_banana",
    "019_pitcher_base", "021_bleach_cleanser", "024_bowl", "025_mug",
    "035_power_drill", "036_wood_block", "037_scissors", "040_large_marker",
    "051_large_clamp", "052_extra_large_clamp", "061_foam_brick"]
MULTI_REGION_BODY_NAMES = [
    "002_master_chef_can", "004_sugar_box", "005_tomato_soup_can",
    "006_mustard_bottle", "007_tuna_fish_can", "008_pudding_box",
    "009_gelatin_box", "010_potted_meat_can", "021_bleach_cleanser",
    "037_scissors", "040_large_marker", "003_cracker_box"]

GRIDS = {
    "region_modality": {
        "n_lines_max": [200],
        "min_continuous_distance": [3.0],
        "function_length": [8],
        "distribution_length": [12],
        "function_amplitude": [0.43],
        "function_slope": [0.5],
        "learning_rate": [1.3],
        "scales": [[7, 4, 2]],
        "standard_deviations": [[25.0, 15.0, 10.0]],
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
        "considered_distances": [[0.07, 0.05, 0.04]],
        "standard_deviations": [[0.05, 0.03, 0.02]],
        "measured_depth_offset_radius": [0.01],
        "measured_occlusion_radius": [0.01],
        "measured_occlusion_threshold": [0.03],
    },
    "texture_modality": {
        "descriptor_type": ["ORB"],
        "focused_image_size": [200],
        "descriptor_distance_threshold": [0.7],
        "tukey_norm_constant": [20.0],
        "standard_deviations": [[10.0, 10.0, 3.0]],
        "max_keyframe_rotation_difference": [10.0 * math.pi / 180.0],
        "max_keyframe_age": [1000],
        "n_keyframes": [1],
        "orb_n_features": [300],
        "daisy_radius": [8.0],
        "freak_pattern_scale": [16.0],
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
    parser.add_argument("--sequences", nargs="+", type=int, default=SEQUENCE_IDS)
    parser.add_argument("--detector", default="cosypose")
    parser.add_argument("--use-texture", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    def evaluate_one(run):
        from m3t_tpu_torch.eval.ycb_evaluator import YCBEvaluator

        # Every body for every sequence, as the JAX script passes them: the evaluator
        # raises for a body whose model or pose file is missing (ROADMAP Queue C).
        sequence2body = {s: BODY_NAMES for s in args.sequences}
        evaluator = YCBEvaluator("study", args.dataset_dir, args.external_dir,
                                 sequence_ids=args.sequences,
                                 sequence2body_names=sequence2body,
                                 detector_folder=args.detector,
                                 device=args.device)
        evaluator.use_texture_modality = args.use_texture
        evaluator.region_modality_setter = make_setter(run["region_modality"])
        evaluator.depth_modality_setter = make_setter(run["depth_modality"])
        evaluator.texture_modality_setter = make_setter(run["texture_modality"])
        evaluator.tracker_setter = make_setter(run["tracker"])
        return evaluator.Evaluate()

    run_study(GRIDS, evaluate_one, ("add_auc", "adds_auc"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
