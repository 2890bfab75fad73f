"""The articulated RGB-D cell (``rtb_kinematic_rgbd.eval_s256``) against its plain
reference on the CPU: the configuration's seven-link structure at S = 2 on a small
camera (320x240, fu 300), one checkpoint, every number the cell compares within the
cell's limits; the same limits fail the reference computed with TF32 matmuls in the
program's place, and a step whose joint state moved by 1 cm.

The program runs through the driver's entry points (``build_kinematic_model`` from the
object graph, ``initialize_kinematic_histograms``, ``tracking_cycle_kinematic`` with
depth frames, the depth model and the links' focused scenes); the lines and points are
cut to 50 and the meshes to 80 faces to keep the CPU's time short.
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

CELL = "rtb_kinematic_rgbd.eval_s256"
SEED = 2 ** 31 + 21


def small_config() -> dict:
    config = spec.config("rtb_kinematic_rgbd")
    config.update(width=320, height=240, fu=300.0, fv=300.0, ppu=160.0, ppv=120.0,
                  n_lines=50, n_points=50, body_subdivisions=1)
    return config


def small_traffic() -> dict:
    traffic = spec.traffic("eval_s256")
    traffic.update(batch=2, warmup_steps=0, warmup_s=0, checkpoints=1, checkpoint_span=1)
    return traffic


def stepped(side=None):
    """A driver of the cell, set up and stepped past its checkpoint."""
    cell = spec.cell(CELL)
    module = spec.load_module("drivers", cell["driver"])
    driver = module.Driver(cell, small_config(), small_traffic(), SEED, torch.device("cpu"),
                           side)
    driver.setup()
    driver.open_window()
    for _ in range(max(driver.checkpoints) + 1):
        driver.step(False)
    return driver, module


@pytest.fixture(scope="module")
def program():
    torch.set_num_threads(4)
    driver, _ = stepped()
    return driver


def test_the_program_agrees_with_the_reference(program):
    attempted, failed = program.outcome()
    assert attempted == 2 * 7 and failed == 0
    correct, compared = check.verdict(program.readings(), spec.cell(CELL)["limits"])
    assert correct, compared


def test_a_joint_state_moved_by_a_centimetre_is_not_correct(program):
    """The first structure's root joint moved 1 cm along x where the step produced it:
    all seven of its links move."""
    frame, state_in, state_out = program.snapshots[0]
    poses = state_out[0].clone()
    poses[:7, 0, 3] += 0.01
    program.snapshots[0] = (frame, state_in, (poses,) + tuple(state_out[1:]))
    try:
        correct, compared = check.verdict(program.readings(), spec.cell(CELL)["limits"])
    finally:
        program.snapshots[0] = (frame, state_in, state_out)
    assert not correct
    assert compared["xy_gap"]["value"] > 0.009


def test_the_tf32_control_is_not_correct():
    torch.set_num_threads(4)
    cell = spec.cell(CELL)
    module = spec.load_module("drivers", cell["driver"])
    driver, _ = stepped(lambda d: module.reference_side(d, tf32=True))
    correct, compared = check.verdict(driver.readings(), cell["limits"])
    assert not correct, compared
