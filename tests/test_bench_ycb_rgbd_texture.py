"""The YCB-class RGB-D + texture cell (``ycb_rgbd_texture.eval_s128``) against its plain
reference on the CPU: the configuration's four bodies (two of two region sub-bodies,
each partly hidden by a sphere in front of it) at two sequences on a 96x64 camera, 32
lines and points and 2 x 1 iterations; the numbers the cell compares within its limits,
a multi-region body's slots on one pose, and ``correct`` false under the TF32 control,
a step that leaves its state unchanged, and a program that checks no measured
occlusions, drops the texture terms or ignores ``pose_group``.  Also the rigid region and
the articulated RGB-D cells, which check no measured occlusions: their cycles mark no
``measured_occlusion`` stage and count no measured-occlusion windows.

The program runs through the driver's entry points (``initialize_histograms`` and
``tracking_cycle_rgbd`` over every slot with ``pose_group``, ``depth_n_points`` and
``texture_points``, measured occlusions on both modalities).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import check, spec  # noqa: E402

CELL = "ycb_rgbd_texture.eval_s128"
SEED = 2 ** 31 + 25
SMALL = 96 / 640


def small_config() -> dict:
    """The configuration on a 96x64 camera (the YCB camera scaled by 0.15), 32 lines and
    points, views of one subdivision and 2 x 1 iterations; the crop covers the frame, and
    the histograms' walks (6 px) end inside it."""
    config = spec.config("ycb_rgbd_texture")
    config.update(width=96, height=64, fu=config["fu"] * SMALL, fv=config["fv"] * SMALL,
                  ppu=config["ppu"] * SMALL, ppv=config["ppv"] * SMALL - 4.0,
                  n_lines=32, n_points=32, scales=[2, 1], n_corr_iterations=2,
                  n_update_iterations=1, crop_size=96, max_considered_line_length=6.0,
                  texture_rows=16, texture_valid=12)
    for model in ("region_model", "depth_model"):
        config[model] = dict(config[model], n_divides=1, n_points=32)
    return config


def small_traffic() -> dict:
    traffic = spec.traffic("eval_s128")
    traffic.update(batch=2, warmup_steps=1, warmup_s=0, checkpoints=1, checkpoint_span=2)
    return traffic


def driver_module():
    return spec.load_module("drivers", spec.cell(CELL)["driver"])


def stepped(side=None):
    """A driver of the cell, set up and stepped past its checkpoint."""
    driver = driver_module().Driver(spec.cell(CELL), small_config(), small_traffic(), SEED,
                                    torch.device("cpu"), side)
    driver.setup()
    driver.open_window()
    for _ in range(max(driver.checkpoints) + 1):
        driver.step(False)
    return driver


def verdict(driver):
    return check.verdict(driver.readings(), spec.cell(CELL)["limits"])


@pytest.fixture(scope="module")
def program():
    torch.set_num_threads(4)
    return stepped()


def test_the_program_agrees_with_the_reference(program):
    attempted, failed = program.outcome()
    assert attempted == 2 * 4 and failed == 0
    correct, compared = verdict(program)
    assert correct, compared


def test_a_bodys_slots_share_its_primary_pose_bit_for_bit(program):
    poses = program.state[0]
    group = torch.as_tensor(program.group)
    assert (group != torch.arange(len(group))).sum() == 2 * 2
    assert torch.equal(poses, poses[group])
    assert torch.equal(program.snapshots[0][2][0], program.snapshots[0][2][0][group])


def test_measured_occlusions_drop_lines_and_points(program):
    """On the CPU the cycle runs eagerly: count, at the last state, the lines and points
    that the measured occlusions drop.  Each hidden sub-sphere loses lines, and each
    multi-region body's primary slot loses depth points; the other slots lose none."""
    from m3t_tpu_torch import pipeline

    calls = {}
    original = pipeline._region_terms

    def region_terms(*args, **kwargs):
        with_check = original(*args, **kwargs)
        without = original(*args, **dict(kwargs, measured_occlusion=None))
        calls.setdefault("lines", (with_check.valid.sum(-1) - without.valid.sum(-1)))
        return with_check

    pipeline._region_terms = region_terms
    try:
        frame = program.frame(program.t + 1)
        program.side.cycle(*program.frame_inputs(frame), program.state)
    finally:
        pipeline._region_terms = original
    dropped = calls["lines"].reshape(2, -1)
    layout = program.layout
    hidden = [j for j, (o, k) in enumerate(zip(layout.object, layout.sphere))
              if (o, k) in ((0, 0), (2, 1))]
    assert (dropped[:, hidden] < 0).all()
    assert (dropped[:, [j for j in range(dropped.shape[1]) if j not in hidden]] == 0).all()


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_through_the_harness(trace, monkeypatch):
    """``run.measure`` on the CPU, traced and not: ``correct`` true with nothing failed,
    the cell's end-to-end metrics untraced, and traced the RGB-D cycle's stages and the
    measured-occlusion windows (region lines and depth points, every correspondence
    iteration) from the program's tracer.  This suite's conftest loads JAX, which a run
    refuses, so the refusal is left out here (benchmark/tests runs the cell in a process
    of its own)."""
    import io
    import json

    from benchmark import run
    from benchmark.harness import device

    monkeypatch.setattr(device, "forbidden_modules", lambda: [])

    torch.set_num_threads(4)
    config, traffic = small_config(), small_traffic()
    traffic.update(checkpoint_span=3, checkpoints=2, trace_steps=2)
    load_config, load_traffic = spec.config, spec.traffic
    monkeypatch.setattr(spec, "config", lambda name: dict(config) if name == CELL.split(
        ".")[0] else load_config(name))
    monkeypatch.setattr(spec, "traffic", lambda name: dict(traffic) if name == CELL.split(
        ".")[1] else load_traffic(name))
    out = io.StringIO()
    args = run.parse_args(["--workload", CELL, "--seed", str(SEED), "--seconds", "0.3",
                           "--trace", str(trace)])
    assert run.measure(args, out=out, card=torch.device("cpu")) == 0
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    metrics = line["metrics"]
    if not trace:
        assert set(metrics) == {"body_frames_per_s", "setup_s"}
        return
    for stage in ("measured_occlusion", "depth_correspondences",
                  "texture_gradient_hessian"):
        assert metrics[f"rgbd_stage_ms.{stage}"]["value"] > 0
    slots = traffic["batch"] * config["slots_per_sequence"]
    assert metrics["occlusion_windows"]["value"] == (
        config["n_corr_iterations"] * slots * (config["n_lines"] + config["n_points"]))


def _sides():
    module = driver_module()
    program = module.program_side
    return {
        "control": lambda d: module.reference_side(d, tf32=True),
        "unchanged": lambda d: program(d)._replace(cycle=lambda *a: a[-1]),
        "unmeasured": lambda d: program(d, region_measure_occlusions=False,
                                        depth_measure_occlusions=False),
        "untextured": lambda d: program(d, use_texture=False),
        "ungrouped": lambda d: program(d, grouped=False),
    }


@pytest.mark.parametrize("fault", ["control", "unchanged", "unmeasured", "untextured",
                                   "ungrouped"])
def test_a_fault_is_not_correct(fault):
    torch.set_num_threads(4)
    correct, compared = verdict(stepped(_sides()[fault]))
    assert not correct, compared


# The stage marks of one cycle of the cells without measured occlusions: the rigid region
# cycle at 5 x 2 iterations, and the articulated RGB-D cycle at 5 x 2 with its scenes,
# depth terms and KKT steps.
def _rigid_stages(corr: int, update: int) -> list:
    one = ["view", "line_geometry", "sample_lines", "lines"]
    one += ["gradient_hessian", "newton_step"] * update
    return (["graphs.run", "crops"] + one * corr
            + ["histogram_walk", "histogram_count", "histogram_blend"])


def _kinematic_stages(corr: int, update: int) -> list:
    one = ["scene_render", "view", "line_geometry", "sample_lines", "lines",
           "depth_correspondences"]
    one += ["gradient_hessian", "depth_gradient_hessian", "newton_step", "kinematic_terms",
            "kkt_solve"] * update
    return (["graphs.run", "depth_correspondences", "crops"] + one * corr
            + ["histogram_walk", "histogram_count", "histogram_blend"])


@pytest.mark.parametrize("cell", ["rbot_region.eval_b512", "rtb_kinematic_rgbd.eval_s256"])
def test_cells_without_measured_occlusions_keep_their_stages_and_counters(cell):
    from m3t_tpu_torch.utils import timing

    torch.set_num_threads(4)
    entry = spec.cell(cell)
    config, traffic = spec.config(entry["config"]), spec.traffic(entry["traffic"])
    if cell.startswith("rtb"):
        config.update(width=320, height=240, fu=300.0, fv=300.0, ppu=160.0, ppv=120.0,
                      n_lines=50, n_points=50, body_subdivisions=1)
    traffic.update(batch=2, warmup_steps=0, warmup_s=0, checkpoints=1, checkpoint_span=1)
    driver = spec.load_module("drivers", entry["driver"]).Driver(
        entry, config, traffic, 7, torch.device("cpu"))
    driver.setup()
    timing.reset()
    try:
        with timing.tracing():
            driver.step(False)
        report = timing.report()
    finally:
        timing.reset()
    (interval,) = report.intervals
    names = [name for name, _, _ in interval.stages]
    rigid = cell.startswith("rbot")
    want = (_rigid_stages if rigid else _kinematic_stages)(5, 2)
    assert names == want
    assert "depth.occlusion_windows" not in report.counters
    assert set(report.counters) == (set() if rigid else {
        "kinematics.structures", "kinematics.links", "kinematics.kkt_rows",
        "occlusion.scene_triangles"})
