"""Parity tests: the port's parameter studies (m3t_tpu_torch/examples/parameter_study*.py)
against the JAX package's scripts under examples/, on the CPU: parameter_study.py's RBOT
mode and the RBOT and YCB-Video studies here, the OPT, Choi and RTB studies in
tests/test_torch_parameter_studies_datasets.py (two files, so that two test workers
share them).

Each study runs through both packages' main() on the mini datasets of
tests/test_evaluators.py, tests/test_evaluators_extra.py and tests/test_torch_evaluators.py
(3 frames), its evaluator bound to the dataset's intrinsics, to small models and, where a
fused evaluator takes one, to a small pipeline configuration (tests/test_torch_examples.py
helpers): the printed rows agree word for word, every number within 1e-4 (the seconds a
row took aside), and every scored pose within 1e-4.  Two faults of the JAX studies are
shown in both packages (ROADMAP Queue C).
"""

import json

import numpy as np
import pytest

from tests.test_evaluators import _build_mini_rbot, _build_mini_ycb
from tests.test_torch_examples import (N_FRAMES, _assert_same_lines, _assert_same_poses,
                                       _both, _evaluator_patches, _jax_script,
                                       _port_script, _run)

YCB_DEPTH_SCALE = 0.0001


@pytest.fixture(scope="module")
def rbot_dataset(tmp_path_factory):
    """The mini RBOT dataset, shared by the RBOT studies: the models the first study
    generates in it are read from the cache by the next."""
    root = tmp_path_factory.mktemp("rbot")
    intr, n = _build_mini_rbot(root, N_FRAMES)
    return root, intr, n


@pytest.fixture(scope="module")
def ycb_dataset(tmp_path_factory):
    """The mini YCB-Video dataset, shared by the YCB studies."""
    root = tmp_path_factory.mktemp("ycb")
    return root, _build_mini_ycb(root, N_FRAMES, YCB_DEPTH_SCALE)


def _rbot_patches(rbot_dataset):
    _, intr, n = rbot_dataset
    patches, spies = _evaluator_patches("rbot_evaluator", "RBOTEvaluator", intr=intr,
                                        pipeline={}, n_frames=n)
    return patches, spies


def test_parameter_study_rbot_sweeps_nothing_in_both_packages(rbot_dataset, monkeypatch,
                                                               capsys):
    """The reference fault of examples/parameter_study.py (ROADMAP Queue C): the RBOT
    evaluator's fused path, its default, builds its cycle from pipeline_config alone and
    never calls region_modality_setter, so a two-value n_lines_max grid prints the same
    score for both rows, from equal scored poses, in JAX and in the port alike."""
    patches, spies = _rbot_patches(rbot_dataset)
    root = str(rbot_dataset[0])
    argv = ["rbot", root, root, "--bodies", "ball", "--param", "n_lines_max", "[60, 200]"]
    got, want = _both("parameter_study", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    rows = [line for line in got if " -> " in line]
    assert rows[0].startswith("{'n_lines_max': 60} -> ") and len(rows) == 3
    assert rows[0].split(" -> ")[1] == rows[1].split(" -> ")[1]
    _assert_same_poses(spies)
    for spy in spies.values():
        half = len(spy.pairs) // 2
        assert half == N_FRAMES
        for (a, _), (b, _) in zip(spy.pairs[:half], spy.pairs[half:]):
            np.testing.assert_array_equal(a, b)


def _study_grid(name: str, monkeypatch, **changes):
    """The GRIDS of both packages' study <name>, each "component.param" in changes set
    to its list of values (the same in both)."""
    patches = {}
    for pkg in ("jax", "torch"):
        module = (_jax_script(name, monkeypatch) if pkg == "jax" else _port_script(name))
        grid = json.loads(json.dumps(module.GRIDS))
        for key, values in changes.items():
            component, param = key.split(".")
            grid[component][param] = values
        patches[pkg] = (module, "GRIDS", grid)
    assert patches["torch"][2] == patches["jax"][2]
    return patches


# The RBOT grid's published histogram (32 bins per channel), scales and 7x2 iterations
# take JAX 90 s to compile on the CPU: the tier-1 case sweeps the mini dataset's.
RBOT_MINI_GRID = {"region_modality.n_histogram_bins": [16],
                  "region_modality.scales": [[2, 1]],
                  "region_modality.standard_deviations": [[5.0, 1.5]],
                  "tracker.n_corr_iterations": [5]}


@pytest.mark.parametrize("grid", [
    pytest.param(RBOT_MINI_GRID, id="mini grid"),
    pytest.param(dict(RBOT_MINI_GRID, **{"region_modality.n_lines_max": [100, 200]}),
                 id="mini grid swept", marks=pytest.mark.slow),
    pytest.param({}, id="published grid", marks=pytest.mark.slow)])
def test_parameter_study_rbot_dataset_fused_matches_jax(rbot_dataset, monkeypatch, capsys,
                                                         grid):
    """parameter_study_rbot_dataset.py --fused --quick, its pipeline_config built from
    the grid field for field: the same printed rows and scored poses.  Swept over
    n_lines_max, the rows' poses differ: this path takes the grid, unlike
    parameter_study.py's."""
    patches, spies = _rbot_patches(rbot_dataset)
    for pkg, patch in _study_grid("parameter_study_rbot_dataset", monkeypatch,
                                  **grid).items():
        patches[pkg].append(patch)
    root = str(rbot_dataset[0])
    argv = [root, root, "--bodies", "ball", "--sequences", "a_regular",
            "--fused", "--quick", "--n-frames", str(N_FRAMES)]
    got, want = _both("parameter_study_rbot_dataset", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    assert got[-1].startswith("best tracking_success: ")
    _assert_same_poses(spies)
    if "region_modality.n_lines_max" in grid:
        half = len(spies["torch"].pairs) // 2
        assert any(not np.array_equal(a, b) for (a, _), (b, _) in zip(
            spies["torch"].pairs[:half], spies["torch"].pairs[half:]))


def _ycb_patches(ycb_dataset):
    return _evaluator_patches("ycb_evaluator", "YCBEvaluator", intr=ycb_dataset[1],
                              pipeline={"depth": True}, depth_scale=YCB_DEPTH_SCALE)


def test_parameter_study_ycb_dataset_matches_jax(ycb_dataset, monkeypatch, capsys):
    """parameter_study_ycb_dataset.py on the mini YCB-Video dataset (its fused path, the
    default), BODY_NAMES bound to the dataset's one body in both packages."""
    patches, spies = _ycb_patches(ycb_dataset)
    for pkg, (module, _, _) in _study_grid("parameter_study_ycb_dataset",
                                           monkeypatch).items():
        patches[pkg].append((module, "BODY_NAMES", ["ball"]))
    root = ycb_dataset[0]
    argv = [str(root), str(root / "external"), "--sequences", "1"]
    got, want = _both("parameter_study_ycb_dataset", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    assert got[-1].startswith("best add_auc: ")
    _assert_same_poses(spies)


def test_parameter_study_ycb_needs_every_body_in_both_packages(ycb_dataset, monkeypatch,
                                                                capsys):
    """A fault of examples/parameter_study_ycb_dataset.py (ROADMAP Queue C): every
    sequence tracks every one of the 21 BODY_NAMES ("let missing files skip", says its
    comment), so on a dataset without one of their models the study fails at its
    first body, in JAX and in the port alike."""
    patches, _ = _ycb_patches(ycb_dataset)
    root = ycb_dataset[0]
    argv = [str(root), str(root / "external"), "--sequences", "1"]
    errors = {}
    for pkg in ("jax", "torch"):
        with pytest.raises(Exception) as error:
            _run(pkg, "parameter_study_ycb_dataset", argv, monkeypatch, capsys, patches[pkg])
        errors[pkg] = (type(error.value), str(error.value))
    assert errors["torch"] == errors["jax"]
    assert "002_master_chef_can" in errors["torch"][1]
