"""The per-layer metrics that read the program's tracer (harness/stages.py), on the CPU
at a tiny size: a traced run of the eval cell reports every one of them, an untraced
run none, and a program without the tracer's report leaves them out.

Run from the repository root: ``python -m pytest -q benchmark/tests``.
"""

from __future__ import annotations

import pytest

from benchmark.harness import spec
from benchmark.tests.test_bench_harness import result, tiny  # noqa: F401 (fixture)

CELL = "rbot_region.eval_b512"
STAGES = ("crops", "view", "line_geometry", "lines", "gradient_hessian", "newton_step",
          "histogram_walk", "histogram_blend", "sample_lines", "histogram_count")
NEW = {f"stage_ms.{s}" for s in STAGES} | {"graph_copy_ms", "graph_copy_mb",
                                           "graph_key_host_ms"}


def test_the_new_metrics_are_listed_for_the_eval_cell():
    listed = {m["name"]: m for m in spec.metrics(spec.benchmark(), CELL, True)}
    assert NEW <= set(listed)
    assert all(listed[name]["moves"] == "body_frames_per_s" for name in NEW)


def test_a_traced_run_reports_the_tracer_metrics():
    metrics = result(CELL, trace=1)["metrics"]
    assert NEW <= set(metrics)
    # On the CPU the marks are host timestamps and nothing is copied into a graph.
    assert all(metrics[f"stage_ms.{s}"]["value"] > 0 for s in STAGES)
    assert metrics["graph_copy_ms"]["value"] == 0 == metrics["graph_copy_mb"]["value"]
    assert metrics["graph_key_host_ms"]["value"] > 0
    assert metrics["graph_copy_mb"]["unit"] == "MB"


def test_an_untraced_run_reports_none_of_them():
    assert not NEW & set(result(CELL, trace=0)["metrics"])


def test_a_program_without_the_report_leaves_them_out(monkeypatch):
    """As the parent commit's program: its timing module has no report()."""
    from m3t_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "report")
    assert not NEW & set(result(CELL, trace=1)["metrics"])


@pytest.fixture(autouse=True)
def fresh_tracer():
    from m3t_tpu_torch.utils import timing

    timing.reset()
    yield
    timing.reset()
