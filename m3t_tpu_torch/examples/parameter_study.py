"""Parameter study driver (port of examples/parameter_study.py; reference
M3T/examples/parameter_study_*_dataset.cpp).

Grid-sweeps modality/optimizer parameters over an evaluator and prints a result table.
The evaluators run on ``--device`` (the card unless ``--device cpu`` is given).

Only RBOT is wired, as in the JAX script, and with its fault: the RBOT evaluator runs
its fused path by default, which builds its cycle from ``pipeline_config`` alone and
never calls ``region_modality_setter``, so every row scores the same (ROADMAP Queue C).

Usage: python -m m3t_tpu_torch.examples.parameter_study rbot <dataset_dir> <external_dir> \
           --param scales "[[6,4,2,1],[7,4,2],[5,3,1]]" --bodies ape [--device cuda]
"""

import argparse
import itertools
import json

from m3t_tpu_torch.common import resolve_device


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("dataset", choices=["rbot", "ycb", "opt", "choi"])
    parser.add_argument("dataset_dir")
    parser.add_argument("external_dir")
    parser.add_argument("--bodies", nargs="+", default=["ape"])
    parser.add_argument("--sequences", nargs="+", default=["a_regular"])
    parser.add_argument("--param", nargs=2, action="append", metavar=("NAME", "VALUES"),
                        default=[], help="parameter name + JSON list of values")
    parser.add_argument("--device", default="cuda")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    resolve_device(args.device)

    names = [p[0] for p in args.param]
    value_lists = [json.loads(p[1]) for p in args.param]

    rows = []
    for combo in itertools.product(*value_lists) if value_lists else [()]:
        if args.dataset == "rbot":
            from m3t_tpu_torch.eval.rbot_evaluator import RBOTEvaluator

            evaluator = RBOTEvaluator(
                "study", args.dataset_dir, args.external_dir,
                body_names=args.bodies, sequence_names=args.sequences,
                device=args.device)

            def setter(modality, combo=combo):
                for name, value in zip(names, combo):
                    setattr(modality, name, value)

            evaluator.region_modality_setter = setter
            result = evaluator.Evaluate()
            score = result["tracking_success"]
        else:
            raise NotImplementedError(
                f"parameter study for {args.dataset} not wired yet")
        rows.append((combo, score))
        print(f"{dict(zip(names, combo))} -> {score:.4f}")

    best = max(rows, key=lambda r: r[1])
    print(f"best: {dict(zip(names, best[0]))} -> {best[1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
