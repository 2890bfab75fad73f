"""Shared sweep machinery for the dataset-specific parameter studies (a copy of
examples/parameter_study_common.py, which the port does not import).

Each ``parameter_study_<dataset>_dataset.py`` script mirrors its reference
counterpart (M3T/examples/parameter_study_*_dataset.cpp): a set of per-component
parameter grids (single-element lists = the published evaluation configuration;
add values to sweep) cross-producted over the dataset's evaluator.  This module
provides the cross-product driver and the setter plumbing shared by all five.
"""

from __future__ import annotations

import itertools
import json
import time


def expand_grid(grids: dict) -> list[dict]:
    """grids: {component: {param: [values...]}} -> list of per-run assignments
    [{component: {param: value}}]."""
    flat = [(component, param, values)
            for component, params in grids.items()
            for param, values in params.items()]
    combos = itertools.product(*[values for _, _, values in flat])
    runs = []
    for combo in combos:
        run: dict = {}
        for (component, param, _), value in zip(flat, combo):
            run.setdefault(component, {})[param] = value
        runs.append(run)
    return runs


def make_setter(assignments: dict):
    def setter(obj):
        for param, value in assignments.items():
            setattr(obj, param, value)
    return setter


def describe(run: dict, grids: dict) -> str:
    """Only parameters with more than one grid value (the swept ones)."""
    swept = {}
    for component, params in grids.items():
        for param, values in params.items():
            if len(values) > 1:
                swept[f"{component}.{param}"] = run[component][param]
    return json.dumps(swept) if swept else "(default configuration)"


def run_study(grids: dict, evaluate_one, score_names: tuple) -> list[dict]:
    """Cross-product all grids; evaluate_one(run) -> result dict containing
    ``score_names`` entries.  Prints the reference-style result table."""
    runs = expand_grid(grids)
    print(f"Running {len(runs)} experiment(s)")
    rows = []
    for i, run in enumerate(runs):
        begin = time.perf_counter()
        result = evaluate_one(run)
        elapsed = time.perf_counter() - begin
        row = {"run": run, "elapsed_s": elapsed}
        row.update({k: result[k] for k in score_names})
        rows.append(row)
        scores = ", ".join(f"{k} = {result[k]:.4f}" for k in score_names)
        print(f"[{i + 1}/{len(runs)}] {describe(run, grids)}: {scores} "
              f"({elapsed:.1f} s)")
    best = max(rows, key=lambda r: r[score_names[0]])
    print(f"best {score_names[0]}: {best[score_names[0]]:.4f} "
          f"with {describe(best['run'], grids)}")
    return rows
