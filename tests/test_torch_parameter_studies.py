"""Parity tests: the port's parameter studies (m3t_tpu_torch/examples/parameter_study*.py)
against the JAX package's scripts under examples/, on the CPU.

Each study runs through both packages' main() on the mini datasets of
tests/test_evaluators.py, tests/test_evaluators_extra.py and tests/test_torch_evaluators.py
(3 frames), its evaluator bound to the dataset's intrinsics, to small models and, where a
fused evaluator takes one, to a small pipeline configuration (tests/test_torch_examples.py
helpers): the printed rows agree word for word, every number within 1e-4 (the seconds a
row took aside), and every scored pose within 1e-4.  Two faults of the JAX studies are
shown in both packages (ROADMAP Queue C).
"""

import importlib
import json

import numpy as np
import pytest

from tests.test_evaluators import _build_mini_rbot, _build_mini_ycb
from tests.test_evaluators_extra import _build_mini_rtb
from tests.test_torch_evaluators import MetricSpy, _build_mini_choi, _build_mini_opt
from tests.test_torch_examples import (N_FRAMES, _assert_same_lines, _assert_same_poses,
                                       _both, _evaluator_patches, _jax_script,
                                       _port_script, _run)


def _rbot_patches(tmp_path):
    intr, n = _build_mini_rbot(tmp_path, N_FRAMES)
    patches, spies = _evaluator_patches("rbot_evaluator", "RBOTEvaluator", intr=intr,
                                        pipeline={}, n_frames=n)
    return patches, spies


def test_parameter_study_rbot_sweeps_nothing_in_both_packages(tmp_path, monkeypatch,
                                                               capsys):
    """The reference fault of examples/parameter_study.py (ROADMAP Queue C): the RBOT
    evaluator's fused path, its default, builds its cycle from pipeline_config alone and
    never calls region_modality_setter, so a two-value n_lines_max grid prints the same
    score for both rows, from equal scored poses, in JAX and in the port alike."""
    patches, spies = _rbot_patches(tmp_path)
    argv = ["rbot", str(tmp_path), str(tmp_path), "--bodies", "ball",
            "--param", "n_lines_max", "[60, 200]"]
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
def test_parameter_study_rbot_dataset_fused_matches_jax(tmp_path, monkeypatch, capsys,
                                                         grid):
    """parameter_study_rbot_dataset.py --fused --quick, its pipeline_config built from
    the grid field for field: the same printed rows and scored poses.  Swept over
    n_lines_max, the rows' poses differ: this path takes the grid, unlike
    parameter_study.py's."""
    patches, spies = _rbot_patches(tmp_path)
    for pkg, patch in _study_grid("parameter_study_rbot_dataset", monkeypatch,
                                  **grid).items():
        patches[pkg].append(patch)
    argv = [str(tmp_path), str(tmp_path), "--bodies", "ball", "--sequences", "a_regular",
            "--fused", "--quick", "--n-frames", str(N_FRAMES)]
    got, want = _both("parameter_study_rbot_dataset", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    assert got[-1].startswith("best tracking_success: ")
    _assert_same_poses(spies)
    if "region_modality.n_lines_max" in grid:
        half = len(spies["torch"].pairs) // 2
        assert any(not np.array_equal(a, b) for (a, _), (b, _) in zip(
            spies["torch"].pairs[:half], spies["torch"].pairs[half:]))


def _ycb_dataset(tmp_path):
    depth_scale = 0.0001
    intr = _build_mini_ycb(tmp_path, N_FRAMES, depth_scale)
    return _evaluator_patches("ycb_evaluator", "YCBEvaluator", intr=intr,
                              pipeline={"depth": True}, depth_scale=depth_scale)


def test_parameter_study_ycb_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    """parameter_study_ycb_dataset.py on the mini YCB-Video dataset (its fused path, the
    default), BODY_NAMES bound to the dataset's one body in both packages."""
    patches, spies = _ycb_dataset(tmp_path)
    for pkg, (module, _, _) in _study_grid("parameter_study_ycb_dataset",
                                           monkeypatch).items():
        patches[pkg].append((module, "BODY_NAMES", ["ball"]))
    argv = [str(tmp_path), str(tmp_path / "external"), "--sequences", "1"]
    got, want = _both("parameter_study_ycb_dataset", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    assert got[-1].startswith("best add_auc: ")
    _assert_same_poses(spies)


def test_parameter_study_ycb_needs_every_body_in_both_packages(tmp_path, monkeypatch,
                                                                capsys):
    """A fault of examples/parameter_study_ycb_dataset.py (ROADMAP Queue C): every
    sequence tracks every one of the 21 BODY_NAMES ("let missing files skip", says its
    comment), so on a dataset without one of their models the study fails at its
    first body, in JAX and in the port alike."""
    patches, _ = _ycb_dataset(tmp_path)
    argv = [str(tmp_path), str(tmp_path / "external"), "--sequences", "1"]
    errors = {}
    for pkg in ("jax", "torch"):
        with pytest.raises(Exception) as error:
            _run(pkg, "parameter_study_ycb_dataset", argv, monkeypatch, capsys, patches[pkg])
        errors[pkg] = (type(error.value), str(error.value))
    assert errors["torch"] == errors["jax"]
    assert "002_master_chef_can" in errors["torch"][1]


def test_parameter_study_opt_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    """parameter_study_opt_dataset.py on the mini OPT dataset laid out as the published
    OPT sequences (3D/<body[:2]>_<pattern>_<orientation>/, column-major ground truth in
    3D/poses/), where the depth camera sits at the published depth-to-colour pose, so
    that the tracker serves on the host path in both packages."""
    intr = _build_mini_opt(tmp_path, N_FRAMES)
    (tmp_path / "3D" / "seq1").rename(tmp_path / "3D" / "ba_tr_1_b")
    poses = np.loadtxt(tmp_path / "3D" / "ba_tr_1_b" / "ball.txt").reshape(-1, 12)
    columns = [np.concatenate([p[:9].reshape(3, 3), p[9:, None]], 1).T.reshape(-1)
               for p in poses]
    (tmp_path / "3D" / "poses").mkdir()
    np.savetxt(tmp_path / "3D" / "poses" / "ba_tr_1_b.txt", np.array(columns), fmt="%.9f")
    patches, spies = _evaluator_patches("opt_evaluator", "OPTEvaluator", intr=intr)
    argv = [str(tmp_path), str(tmp_path), "--bodies", "ball", "--orientations", "b",
            "--patterns", "tr_1"]
    got, want = _both("parameter_study_opt_dataset", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    assert "fused cycle unavailable (depth camera extrinsics differ" in got[1]
    assert got[2].startswith("ba_tr_1_b ball: AUC = ")
    _assert_same_poses(spies)


def test_parameter_study_choi_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    """parameter_study_choi_dataset.py on the mini Choi sequence: neg_mean_rmse_mm and
    mean_rmse_mm printed alike."""
    intr = _build_mini_choi(tmp_path, N_FRAMES)
    patches, spies = _evaluator_patches("choi_evaluator", "ChoiEvaluator", intr=intr)
    argv = [str(tmp_path), str(tmp_path), "--bodies", "ball"]
    got, want = _both("parameter_study_choi_dataset", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    assert "mean_rmse_mm = " in got[-2]
    _assert_same_poses(spies)


def test_parameter_study_rtb_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    """parameter_study_rtb_dataset.py on the mini RTB structure (its fused kinematic
    path): the grids reach the generated modalities through tracker_setter."""
    _build_mini_rtb(tmp_path)
    patches = {}
    spies = {}
    for pkg, prefix in (("jax", "m3t_tpu.eval"), ("torch", "m3t_tpu_torch.eval")):
        module = importlib.import_module(f"{prefix}.rtb_evaluator")
        spies[pkg] = MetricSpy(module.metrics)
        patches[pkg] = [(module, "metrics", spies[pkg])]
    argv = [str(tmp_path), str(tmp_path), "--objects", "miniobj", "--difficulties", "easy",
            "--depths", "gt_depth", "--sequences", "0"]
    got, want = _both("parameter_study_rtb_dataset", argv, monkeypatch, capsys, patches)
    _assert_same_lines(got, want)
    assert got[-1].startswith("best add_auc: ")
    _assert_same_poses(spies)
