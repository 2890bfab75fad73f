"""Parity tests: the OPT, Choi and RTB parameter studies of the port
(m3t_tpu_torch/examples/parameter_study_{opt,choi,rtb}_dataset.py) against the JAX
package's scripts under examples/, on the CPU, as tests/test_torch_parameter_studies.py
holds the RBOT and YCB-Video ones: each study through both packages' main() on a mini
dataset (3 frames), its evaluator bound to small models; the printed rows agree word for
word, every number within 1e-4 (the seconds a row took aside), and every scored pose
within 1e-4.
"""

import importlib

import numpy as np

from tests.test_evaluators_extra import _build_mini_rtb
from tests.test_torch_evaluators import MetricSpy, _build_mini_choi, _build_mini_opt
from tests.test_torch_examples import (N_FRAMES, _assert_same_lines, _assert_same_poses,
                                       _both, _evaluator_patches)


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
