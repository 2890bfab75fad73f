"""Evaluate on the RBOT dataset (port of examples/evaluate_rbot_dataset.py; reference
M3T/examples/evaluate_rbot_dataset.cpp).

Usage: python -m m3t_tpu_torch.examples.evaluate_rbot_dataset <dataset_dir> <external_dir>
       [--bodies ape bakingsoda ...] [--sequences a_regular ...] [--texture]
       [--model-occlusions] [--region-checking] [--n-frames 1000]
       [--model-divides N] [--model-points N] [--model-image-size N]
       [--save results.json] [--device cuda]

The region models are generated into <external_dir> at the reference's settings
(n_divides 4, 200 points, image_size 2000) unless the --model-* options cut them down.
"""

import argparse

from m3t_tpu_torch.eval.rbot_evaluator import RBOTEvaluator

ALL_BODIES = [
    "ape", "bakingsoda", "benchviseblue", "broccolisoup", "cam", "can", "cat",
    "clown", "cube", "driller", "duck", "eggbox", "glue", "iron", "koalacandy",
    "lamp", "lego", "phone", "squirrel",
]
ALL_SEQUENCES = ["a_regular", "b_dynamiclight", "c_noisy", "d_occlusion"]


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--bodies", nargs="+", default=ALL_BODIES)
    parser.add_argument("--sequences", nargs="+", default=ALL_SEQUENCES)
    parser.add_argument("--texture", action="store_true")
    parser.add_argument("--model-occlusions", action="store_true",
                        help="model the squirrel_small partner's occlusions")
    parser.add_argument("--region-checking", action="store_true")
    parser.add_argument("--n-frames", type=int, default=1000,
                        help="frames per sequence (the dataset's 1000)")
    parser.add_argument("--model-divides", type=int, default=None)
    parser.add_argument("--model-points", type=int, default=None)
    parser.add_argument("--model-image-size", type=int, default=None)
    parser.add_argument("--save", default=None)
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def make_evaluator(args: argparse.Namespace) -> RBOTEvaluator:
    """The evaluator that ``args`` describe, in the reference RBOT configuration."""
    evaluator = RBOTEvaluator("rbot_evaluator", args.dataset_dir, args.external_dir,
                              body_names=args.bodies, sequence_names=args.sequences,
                              n_frames=args.n_frames, device=args.device)
    evaluator.use_texture_modality = args.texture
    evaluator.model_occlusions = args.model_occlusions
    evaluator.use_region_checking = args.region_checking

    # Reference RBOT configuration (evaluate_rbot_dataset.cpp).
    def region_modality_setter(modality):
        modality.n_lines_max = 200

    model_settings = {"n_divides": args.model_divides, "n_points": args.model_points,
                      "image_size": args.model_image_size}

    def region_model_setter(model):
        for name, value in model_settings.items():
            if value is not None:
                setattr(model, name, value)

    evaluator.region_modality_setter = region_modality_setter
    evaluator.region_model_setter = region_model_setter
    return evaluator


def main(argv=None) -> int:
    args = parse_args(argv)
    evaluator = make_evaluator(args)
    results = evaluator.Evaluate()
    if args.save:
        evaluator.SaveResults(args.save)
    print(f"tracking success: {results['tracking_success']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
