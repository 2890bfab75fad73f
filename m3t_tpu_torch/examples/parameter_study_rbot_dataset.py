"""RBOT parameter study (port of examples/parameter_study_rbot_dataset.py; reference
M3T/examples/parameter_study_rbot_dataset.cpp).

Grid values below are the published RBOT/SRT3D evaluation configuration
(parameter_study_rbot_dataset.cpp:26-70); extend any list to sweep.  The evaluator runs
on ``--device`` (the card unless ``--device cpu`` is given); ``--fused`` drives its
batched path, whose ``pipeline_config`` is built from the grid field for field.

Usage: python -m m3t_tpu_torch.examples.parameter_study_rbot_dataset <dataset_dir> \
           <external_dir> [--bodies ape duck ...] [--sequences a_regular ...] [--fused] \
           [--device cuda]
"""

import argparse
import math

from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.examples.parameter_study_common import make_setter, run_study

BODY_NAMES = ["ape", "bakingsoda", "benchviseblue", "broccolisoup", "cam",
              "can", "cat", "clown", "cube", "driller", "duck", "eggbox",
              "glue", "iron", "koalacandy", "lamp", "phone", "squirrel"]
SEQUENCE_NAMES = ["a_regular", "b_dynamiclight", "c_noisy", "d_occlusion",
                  "d_occlusion"]
SEQUENCE_OCCLUSIONS = [False, False, False, False, True]

GRIDS = {
    "region_modality": {
        "n_lines_max": [200],
        "min_continuous_distance": [3.0],
        "function_length": [8],
        "distribution_length": [12],
        "function_amplitude": [0.36],
        "function_slope": [0.0],
        "learning_rate": [1.3],
        "scales": [[5, 2, 2, 1]],
        "standard_deviations": [[20.0, 7.0, 3.0, 1.5]],
        "n_histogram_bins": [32],
        "learning_rate_f": [0.2],
        "learning_rate_b": [0.2],
        "unconsidered_line_length": [0.5],
        "max_considered_line_length": [20.0],
        "modeled_occlusion_threshold": [0.03],
    },
    "texture_modality": {
        "descriptor_type": ["ORB"],
        "focused_image_size": [200],
        "descriptor_distance_threshold": [0.7],
        "tukey_norm_constant": [20.0],
        "standard_deviations": [[5.0, 1.0]],
        "max_keyframe_rotation_difference": [10.0 * math.pi / 180.0],
        "max_keyframe_age": [1000],
        "n_keyframes": [1],
        "orb_n_features": [300],
        "orb_scale_factor": [1.2],
        "orb_n_levels": [3],
    },
    "optimizer": {
        "tikhonov_parameter_rotation": [1000.0],
        "tikhonov_parameter_translation": [30000.0],
    },
    "tracker": {
        "n_corr_iterations": [7],
        "n_update_iterations": [2],
    },
}


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--bodies", nargs="+", default=BODY_NAMES)
    parser.add_argument("--sequences", nargs="+", default=SEQUENCE_NAMES)
    parser.add_argument("--use-texture", action="store_true")
    parser.add_argument("--fused", action="store_true",
                        help="drive the card throughput path (batched runs)")
    parser.add_argument("--n-frames", type=int, default=1000)
    parser.add_argument("--quick", action="store_true",
                        help="small sparse-viewpoint models (smoke runs)")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    occlusions = [SEQUENCE_OCCLUSIONS[SEQUENCE_NAMES.index(s)]
                  if s in SEQUENCE_NAMES else False for s in args.sequences]

    def evaluate_one(run):
        from m3t_tpu_torch.eval.rbot_evaluator import RBOTEvaluator

        evaluator = RBOTEvaluator(
            "study", args.dataset_dir, args.external_dir,
            body_names=args.bodies, sequence_names=args.sequences,
            sequence_occlusions=occlusions, n_frames=args.n_frames,
            device=args.device)
        if args.quick:
            def small_model(model):
                model.n_divides = 1
                model.n_points = 100
                model.image_size = 400
            evaluator.region_model_setter = small_model
        evaluator.region_modality_setter = make_setter(run["region_modality"])
        evaluator.texture_modality_setter = make_setter(run["texture_modality"])
        evaluator.use_texture_modality = args.use_texture
        evaluator.use_fused_pipeline = args.fused

        def tracker_setter(tracker):
            make_setter(run["tracker"])(tracker)
        evaluator.tracker_setter = tracker_setter
        if args.fused:
            from m3t_tpu_torch import pipeline
            from m3t_tpu_torch.ops.region_fn import RegionConfig

            r = run["region_modality"]
            evaluator.pipeline_config = pipeline.PipelineConfig(
                cfg=RegionConfig(
                    n_lines_max=r["n_lines_max"],
                    function_length=r["function_length"],
                    distribution_length=r["distribution_length"],
                    function_amplitude=r["function_amplitude"],
                    function_slope=r["function_slope"],
                    learning_rate=r["learning_rate"],
                    min_continuous_distance=r["min_continuous_distance"],
                    n_histogram_bins=r["n_histogram_bins"]),
                scales=tuple(r["scales"]),
                standard_deviations=tuple(r["standard_deviations"]),
                n_corr_iterations=run["tracker"]["n_corr_iterations"],
                n_update_iterations=run["tracker"]["n_update_iterations"],
                tikhonov_rotation=run["optimizer"]["tikhonov_parameter_rotation"],
                tikhonov_translation=run["optimizer"][
                    "tikhonov_parameter_translation"],
                learning_rate_f=r["learning_rate_f"],
                learning_rate_b=r["learning_rate_b"])
        return evaluator.Evaluate()

    run_study(GRIDS, evaluate_one, ("tracking_success",))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
