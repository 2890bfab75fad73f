"""Parity tests: the port's evaluators (m3t_tpu_torch/eval) against the JAX package's
(m3t_tpu/eval), on the CPU, on the mini datasets of tests/test_evaluators.py and
tests/test_evaluators_extra.py (their dataset functions; the OPT and Choi datasets are built
here as those tests build them inline).

Each case runs the JAX evaluator and then the port's on the same files (the port loads
the model cache files that JAX wrote: the same models in both).  A spy on each
evaluator module's ``metrics`` records every pose that the evaluator scores, frame by
frame and body by body.  Both packages must score the same number of frames with the same
success flags, their scores (tracking success, ADD/ADD-S AUC, OPT AUC, Choi RMSE) must
agree within 1e-4 and every scored pose within 1e-4.

Tier-1 cases take 3 frames at 160x120 (RTB: its dataset's 4 frames at 200x150) in one
mode per evaluator; every other mode, the RBOT occlusion sequence and the YCB
multi-region and refinement cases are marked slow.
"""

import itertools
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import m3t_tpu.body
import m3t_tpu_torch.body
from m3t_tpu import pipeline as jpipeline
from m3t_tpu.eval import metrics as jmetrics
from m3t_tpu.ops.depth_fn import DepthConfig as JDepthConfig
from m3t_tpu.ops.region_fn import RegionConfig as JRegionConfig
from m3t_tpu.utils.obj_loader import save_obj
from m3t_tpu_torch import pipeline as tpipeline
from m3t_tpu_torch.common import Intrinsics as TIntrinsics
from m3t_tpu_torch.ops.depth_fn import DepthConfig as TDepthConfig
from m3t_tpu_torch.ops.region_fn import RegionConfig as TRegionConfig
from tests import fixtures
from tests.test_evaluators import (_build_mini_rbot, _build_mini_rbot_occlusion,
                                   _build_mini_ycb, _build_mini_ycb_multiregion)
from tests.test_evaluators_extra import (_build_mini_rtb, _pose_rows, _small_depth_modality,
                                         _small_model, _small_region_modality)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
N_FRAMES = 3
PACKAGES = {
    "jax": dict(pipeline=jpipeline, region_config=JRegionConfig, depth_config=JDepthConfig,
                prefix="m3t_tpu.eval", kwargs={}),
    "torch": dict(pipeline=tpipeline, region_config=TRegionConfig,
                  depth_config=TDepthConfig, prefix="m3t_tpu_torch.eval",
                  kwargs={"device": "cpu"}),
}


class MetricSpy:
    """Stands in for an evaluator module's ``metrics``: every call passes through, and
    the pose and ground truth of each scoring call are recorded in order."""

    SCORED = {"translation_error": 0, "add_error": 1}  # name -> index of the pose arg

    def __init__(self, module):
        self._module = module
        self.pairs = []

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in self.SCORED:
            return fn
        at = self.SCORED[name]

        def scored(*args, **kwargs):
            self.pairs.append((np.array(args[at], np.float64),
                               np.array(args[at + 1], np.float64)))
            return fn(*args, **kwargs)
        return scored


def _module(pkg: str, name: str):
    import importlib

    return importlib.import_module(f"{PACKAGES[pkg]['prefix']}.{name}")


def _evaluate(pkg: str, module_name: str, make, monkeypatch):
    """Runs make(module, kwargs) -> evaluator's Evaluate() with body ids counted from 1
    in both packages and the module's metrics spied on; returns (results, pairs)."""
    module = _module(pkg, module_name)
    spy = MetricSpy(module.metrics)
    with monkeypatch.context() as patch:
        patch.setattr(module, "metrics", spy)
        for body_module in (m3t_tpu.body, m3t_tpu_torch.body):
            patch.setattr(body_module, "_next_body_id", itertools.count(1))
        results = make(module, PACKAGES[pkg]["kwargs"]).Evaluate()
    return results, spy.pairs


def _both(module_name, make, monkeypatch):
    return {pkg: _evaluate(pkg, module_name, make, monkeypatch) for pkg in ("jax", "torch")}


def _assert_pairs(runs, success=None):
    """The same number of scored poses, the same ground truth, the same success flags
    (success(pose, gt) -> bool, if given) and every pose within ATOL."""
    got, want = runs["torch"][1], runs["jax"][1]
    assert len(got) == len(want) > 0
    for i, ((pose, gt), (jpose, jgt)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gt, jgt)
        if success is not None:
            assert success(pose, gt) == success(jpose, jgt), i
        np.testing.assert_allclose(pose, jpose, rtol=0, atol=ATOL, err_msg=f"pose {i}")


def _assert_scores(got, want, keys):
    for key in keys:
        assert abs(got[key] - want[key]) <= ATOL, (key, got[key], want[key])


def _rbot_success(pose, gt):
    return jmetrics.tracking_success(pose, gt)


def _pipeline_config(pkg, n_lines=100, depth=False, **extra):
    p = PACKAGES[pkg]
    kwargs = dict(cfg=p["region_config"](n_lines_max=n_lines), scales=(2, 1),
                  standard_deviations=(5.0, 1.5), n_corr_iterations=5,
                  n_update_iterations=2, **extra)
    if depth:
        kwargs.update(depth_cfg=p["depth_config"](n_points_max=n_lines),
                      considered_distances=(0.03, 0.02),
                      depth_standard_deviations=(0.05, 0.03),
                      region_measure_occlusions=True, depth_measure_occlusions=True)
    return p["pipeline"].PipelineConfig(**kwargs)


def _port_intrinsics(module, intr):
    return TIntrinsics(*intr) if module.__name__.startswith("m3t_tpu_torch") else intr


# ---------------------------------------------------------------------------------------
# RBOT
# ---------------------------------------------------------------------------------------


def _rbot(tmp_path, monkeypatch, fused: bool, occlusion: bool):
    if occlusion:
        intr, n = _build_mini_rbot_occlusion(tmp_path, N_FRAMES)
    else:
        intr, n = _build_mini_rbot(tmp_path, N_FRAMES)
    sequence = "d_occlusion" if occlusion else "a_regular"

    def make(module, kwargs):
        pkg = "torch" if module.__name__.startswith("m3t_tpu_torch") else "jax"
        ev = module.RBOTEvaluator("eval", str(tmp_path), str(tmp_path), body_names=["ball"],
                                  sequence_names=[sequence], sequence_occlusions=[occlusion],
                                  n_frames=n, **kwargs)
        ev.intrinsics = _port_intrinsics(module, intr)
        ev.region_model_setter = _small_model
        ev.region_modality_setter = _small_region_modality
        ev.use_fused_pipeline = fused
        if occlusion:
            ev.model_occlusions = True
            ev.use_region_checking = True
            ev.n_unoccluded_iterations = 0
        ev.pipeline_config = _pipeline_config(pkg, focused_image_size=128)
        return ev

    runs = _both("rbot_evaluator", make, monkeypatch)
    (got, _), (want, _) = runs["torch"], runs["jax"]
    assert got["per_run"].keys() == want["per_run"].keys()
    for key, run in want["per_run"].items():
        assert got["per_run"][key]["n_frames"] == run["n_frames"] == n
        _assert_scores(got["per_run"][key], run, ("tracking_success",
                                                  "mean_translation_error",
                                                  "mean_rotation_error"))
    _assert_pairs(runs, _rbot_success)
    assert got["tracking_success"] == 1.0


def test_rbot_fused_matches_jax(tmp_path, monkeypatch):
    _rbot(tmp_path, monkeypatch, fused=True, occlusion=False)


@pytest.mark.slow
@pytest.mark.parametrize("fused,occlusion", [(False, False), (True, True), (False, True)])
def test_rbot_modes_match_jax(tmp_path, monkeypatch, fused, occlusion):
    _rbot(tmp_path, monkeypatch, fused=fused, occlusion=occlusion)


def test_rbot_entry_point_runs_on_the_cpu(tmp_path, monkeypatch, capsys):
    """The port's evaluate_rbot_dataset main() with --device cpu on the mini dataset
    (its intrinsics bound in for RBOT's): every frame tracked, as the evaluator does."""
    from m3t_tpu_torch.eval import rbot_evaluator
    from m3t_tpu_torch.examples import evaluate_rbot_dataset

    intr, n = _build_mini_rbot(tmp_path, N_FRAMES)
    monkeypatch.setattr(rbot_evaluator, "RBOT_INTRINSICS", TIntrinsics(*intr))
    save = tmp_path / "results.json"
    assert evaluate_rbot_dataset.main([
        str(tmp_path), str(tmp_path), "--bodies", "ball", "--sequences", "a_regular",
        "--n-frames", str(n), "--model-divides", "1", "--model-points", "100",
        "--model-image-size", "400", "--save", str(save), "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == "tracking success: 1.0000"
    assert save.exists()


# ---------------------------------------------------------------------------------------
# YCB-Video
# ---------------------------------------------------------------------------------------


def _ycb(tmp_path, monkeypatch, fused: bool, multi_region=False, refinement=False):
    depth_scale = 0.0001
    n_lines = 80 if multi_region else 100
    if multi_region:
        intr = _build_mini_ycb_multiregion(tmp_path, N_FRAMES, depth_scale)
        body = "duo"
    else:
        intr = _build_mini_ycb(tmp_path, N_FRAMES, depth_scale)
        body = "ball"

    def small_model(m):
        m.n_divides = 1
        m.n_points = n_lines
        m.image_size = 400

    def region_modality(m):
        m.n_lines_max = n_lines
        m.scales = [2, 1]
        m.standard_deviations = [5.0, 1.5]

    def depth_modality(m):
        m.n_points_max = n_lines
        m.considered_distances = [0.03, 0.02]
        m.standard_deviations = [0.05, 0.03]

    def make(module, kwargs):
        pkg = "torch" if module.__name__.startswith("m3t_tpu_torch") else "jax"
        ev = module.YCBEvaluator("ycb", str(tmp_path), str(tmp_path / "external"),
                                 sequence_ids=[1], sequence2body_names={1: [body]},
                                 multi_region_body_names=[body] if multi_region else None,
                                 **kwargs)
        ev.intrinsics = _port_intrinsics(module, intr)
        ev.depth_scale = depth_scale
        ev.use_fused_pipeline = fused
        ev.evaluate_refinement = refinement
        ev.region_model_setter = small_model
        ev.depth_model_setter = small_model
        ev.region_modality_setter = region_modality
        ev.depth_modality_setter = depth_modality
        ev.pipeline_config = _pipeline_config(pkg, n_lines=n_lines, depth=True)
        return ev

    runs = _both("ycb_evaluator", make, monkeypatch)
    (got, _), (want, _) = runs["torch"], runs["jax"]
    _assert_scores(got, want, ("add_auc", "adds_auc"))
    run, jrun = got["per_sequence"][1][body], want["per_sequence"][1][body]
    assert run["n_keyframes"] == jrun["n_keyframes"] == N_FRAMES
    _assert_scores(run, jrun, ("add_auc", "adds_auc"))
    np.testing.assert_allclose(run["add_curve"], jrun["add_curve"], rtol=0, atol=ATOL)
    np.testing.assert_allclose(run["adds_curve"], jrun["adds_curve"], rtol=0, atol=ATOL)
    _assert_pairs(runs)
    assert run["add_auc"] > 0.85


def test_ycb_fused_matches_jax(tmp_path, monkeypatch):
    _ycb(tmp_path, monkeypatch, fused=True)


@pytest.mark.slow
@pytest.mark.parametrize("fused,multi_region,refinement", [
    (False, False, False), (True, True, False), (False, True, False),
    (False, False, True)])
def test_ycb_modes_match_jax(tmp_path, monkeypatch, fused, multi_region, refinement):
    _ycb(tmp_path, monkeypatch, fused=fused, multi_region=multi_region,
         refinement=refinement)


# ---------------------------------------------------------------------------------------
# RTB
# ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [True, False])
def test_rtb_matches_jax(tmp_path, monkeypatch, fused):
    _, n = _build_mini_rtb(tmp_path)

    def make(module, kwargs):
        ev = module.RTBEvaluator("rtb", str(tmp_path), str(tmp_path),
                                 object_names=["miniobj"], difficulty_levels=["easy"],
                                 depth_names=["gt_depth"], sequence_numbers=[0], **kwargs)
        ev.use_fused_pipeline = fused
        return ev

    runs = _both("rtb_evaluator", make, monkeypatch)
    (got, _), (want, _) = runs["torch"], runs["jax"]
    _assert_scores(got, want, ("add_auc", "adds_auc"))
    key = ("miniobj", "easy", "gt_depth", 0)
    assert got["per_run"][key]["n_frames"] == want["per_run"][key]["n_frames"] == n
    _assert_pairs(runs)
    assert got["add_auc"] > 0.85


@pytest.mark.slow
def test_rtb_external_pose_flow_matches_jax(tmp_path, monkeypatch):
    """save_poses_folder then evaluate_external (tests/test_evaluators_extra.py::
    test_rtb_external_pose_flow) in both packages: the saved poses agree within 1e-4 and
    the external scores and the SaveResults CSV rows agree."""
    _build_mini_rtb(tmp_path)
    kwargs = dict(object_names=["miniobj"], difficulty_levels=["easy"],
                  depth_names=["gt_depth"], sequence_numbers=[0])
    saved, external = {}, {}
    for pkg in ("jax", "torch"):
        module = _module(pkg, "rtb_evaluator")
        tracker_ev = module.RTBEvaluator("t", str(tmp_path), str(tmp_path), **kwargs,
                                         **PACKAGES[pkg]["kwargs"])
        tracker_ev.save_poses_folder = pkg
        tracker_ev.Evaluate()
        saved[pkg] = np.loadtxt(tmp_path / "poses" / pkg / "miniobj" / "easy" / "gt_depth"
                                / "000" / "child.txt")
        ext_ev = module.RTBEvaluator("e", str(tmp_path), str(tmp_path), **kwargs,
                                     **PACKAGES[pkg]["kwargs"])
        ext_ev.evaluate_external = True
        ext_ev.external_results_folder = pkg
        external[pkg] = ext_ev.Evaluate()
        ext_ev.SaveResults(str(tmp_path / f"{pkg}.csv"))
    np.testing.assert_allclose(saved["torch"], saved["jax"], rtol=0, atol=ATOL)
    _assert_scores(external["torch"], external["jax"], ("add_auc", "adds_auc"))
    rows = {pkg: [line.split(",") for line in (tmp_path / f"{pkg}.csv").read_text()
                  .strip().splitlines()] for pkg in ("jax", "torch")}
    assert [r[0] for r in rows["torch"]] == [r[0] for r in rows["jax"]]
    np.testing.assert_allclose(np.array([r[1:3] for r in rows["torch"]], float),
                               np.array([r[1:3] for r in rows["jax"]], float), atol=ATOL)


# ---------------------------------------------------------------------------------------
# OPT and Choi (the serve path: Tracker with use_fused_cycle)
# ---------------------------------------------------------------------------------------


def _synthetic_poses(n_frames, axis, step, distance):
    poses = []
    for i in range(n_frames + 1):
        pose = np.eye(4, dtype=np.float32)
        pose[axis, 3] = step * i
        pose[2, 3] = distance
        poses.append(pose)
    return poses


def _build_mini_opt(tmp_path, n_frames=N_FRAMES):
    """tests/test_evaluators_extra.py::test_opt_evaluator_on_synthetic_mini_dataset's
    dataset: a ball in the generic OPT layout (3D/seq1/color, depth and ball.txt)."""
    body = fixtures.sphere_body("opt_ball", radius=0.06, n_subdiv=2)
    intr = fixtures.test_intrinsics(160, 120)
    model_dir, seq_dir = tmp_path / "Model3D" / "ball", tmp_path / "3D" / "seq1"
    for d in (model_dir, seq_dir / "color", seq_dir / "depth"):
        os.makedirs(d)
    save_obj(str(model_dir / "ball.obj"), body.vertices, body.triangles)
    rng = np.random.default_rng(3)
    poses = _synthetic_poses(n_frames, 0, 0.002, 0.6)
    for i in range(n_frames):
        cv2.imwrite(str(seq_dir / "color" / f"{i + 1:04d}.png"),
                    fixtures.render_synthetic_color_frame(body, intr, poses[i],
                                                          noise_rng=rng))
        cv2.imwrite(str(seq_dir / "depth" / f"{i + 1:04d}.png"),
                    fixtures.render_synthetic_depth_frame(body, intr, poses[i],
                                                          depth_scale=0.001))
    (seq_dir / "ball.txt").write_text(_pose_rows(poses) + "\n")
    return intr


def _build_mini_choi(tmp_path, n_frames=N_FRAMES):
    """tests/test_evaluators_extra.py::test_choi_evaluator_on_synthetic_mini_dataset's
    dataset: a ball in seq_synth_ball_kitchen with poses_gt.txt."""
    body = fixtures.sphere_body("choi_ball", radius=0.06, n_subdiv=2)
    intr = fixtures.test_intrinsics(160, 120)
    seq_dir = tmp_path / "seq_synth_ball_kitchen"
    os.makedirs(tmp_path / "models")
    os.makedirs(seq_dir)
    save_obj(str(tmp_path / "models" / "ball.obj"), body.vertices, body.triangles)
    rng = np.random.default_rng(5)
    poses = _synthetic_poses(n_frames, 1, -0.0015, 0.55)
    for i in range(n_frames):
        cv2.imwrite(str(seq_dir / f"color{i:04d}.png"),
                    fixtures.render_synthetic_color_frame(body, intr, poses[i],
                                                          noise_rng=rng))
        cv2.imwrite(str(seq_dir / f"depth{i:04d}.png"),
                    fixtures.render_synthetic_depth_frame(body, intr, poses[i],
                                                          depth_scale=0.0001))
    (seq_dir / "poses_gt.txt").write_text(_pose_rows(poses) + "\n")
    return intr


def _serve_evaluator(tmp_path, monkeypatch, dataset, fused):
    build, module_name = {"opt": (_build_mini_opt, "opt_evaluator"),
                          "choi": (_build_mini_choi, "choi_evaluator")}[dataset]
    intr = build(tmp_path)

    def make(module, kwargs):
        if dataset == "opt":
            ev = module.OPTEvaluator("opt", str(tmp_path), str(tmp_path),
                                     body_names=["ball"], sequence_names=["seq1"], **kwargs)
        else:
            ev = module.ChoiEvaluator("choi", str(tmp_path), str(tmp_path),
                                      body_names=["ball"], **kwargs)
        ev.intrinsics = _port_intrinsics(module, intr)
        ev.use_fused_pipeline = fused
        ev.region_model_setter = _small_model
        ev.depth_model_setter = _small_model
        ev.region_modality_setter = _small_region_modality
        ev.depth_modality_setter = _small_depth_modality
        return ev

    runs = _both(module_name, make, monkeypatch)
    (got, _), (want, _) = runs["torch"], runs["jax"]
    if dataset == "opt":
        _assert_scores(got, want, ("auc",))
        run, jrun = got["per_run"][("seq1", "ball")], want["per_run"][("seq1", "ball")]
        np.testing.assert_allclose(run["curve"], jrun["curve"], rtol=0, atol=ATOL)
    else:
        run, jrun = got["per_body"]["ball"], want["per_body"]["ball"]
        _assert_scores(run, jrun, ("rmse_x", "rmse_y", "rmse_z", "rmse_alpha", "rmse_beta",
                                   "rmse_gamma"))
    assert run["n_frames"] == jrun["n_frames"] == N_FRAMES
    # Both paths time M3T's four phases: the host path by its synchronized clock, the
    # fused path by the cycle's stage marks; the step's whole time bounds their sum.
    times = run["execution_times"]
    assert times["fused"] is fused
    phases = ("calculate_correspondences", "calculate_gradient_and_hessian",
              "calculate_optimization", "calculate_results")
    assert all(times[p] > 0.0 for p in phases)
    assert sum(times[p] for p in phases) <= times["complete_cycle"]
    _assert_pairs(runs)


@pytest.mark.parametrize("dataset", ["opt", "choi"])
def test_serve_evaluators_fused_match_jax(tmp_path, monkeypatch, dataset):
    _serve_evaluator(tmp_path, monkeypatch, dataset, fused=True)


@pytest.mark.slow
@pytest.mark.parametrize("dataset", ["opt", "choi"])
def test_serve_evaluators_host_match_jax(tmp_path, monkeypatch, dataset):
    _serve_evaluator(tmp_path, monkeypatch, dataset, fused=False)


def test_opt_layout_readers_match_jax(tmp_path):
    """read_opt_gt_poses (column-major rows times the inverse geometry2body pose),
    read_matrix_poses and the published run configurations, in both packages."""
    from m3t_tpu.eval import opt_evaluator as jopt
    from m3t_tpu_torch.eval import opt_evaluator as topt

    rng = np.random.default_rng(11)
    rows = rng.normal(size=(4, 12))
    np.savetxt(tmp_path / "poses.txt", rows)
    g2b = np.eye(4, dtype=np.float32)
    g2b[:3, 3] = jopt.BODY2GEOMETRY2BODY_TRANSLATION["soda"]
    np.testing.assert_array_equal(topt.read_opt_gt_poses(str(tmp_path / "poses.txt"), g2b),
                                  jopt.read_opt_gt_poses(str(tmp_path / "poses.txt"), g2b))
    np.testing.assert_array_equal(topt.read_matrix_poses(str(tmp_path / "poses.txt")),
                                  jopt.read_matrix_poses(str(tmp_path / "poses.txt")))
    args = ("e", str(tmp_path), str(tmp_path), ["soda", "chest"])
    got = topt.OPTEvaluator(*args, device="cpu")
    want = jopt.OPTEvaluator(*args)
    assert got._run_configurations("chest") == want._run_configurations("chest")
    np.testing.assert_array_equal(got._geometry2body_pose("jet"),
                                  want._geometry2body_pose("jet"))


# ---------------------------------------------------------------------------------------
# Imports and the card
# ---------------------------------------------------------------------------------------


def test_eval_and_entry_points_import_neither_jax_nor_cv2():
    code = (
        "import sys\n"
        "import m3t_tpu_torch, m3t_tpu_torch.eval\n"
        "from m3t_tpu_torch.examples import (evaluate_rbot_dataset, evaluate_ycb_dataset,\n"
        "    evaluate_rtb_dataset, evaluate_opt_dataset, evaluate_choi_dataset)\n"
        "from m3t_tpu_torch.eval import (metrics, RBOTEvaluator, YCBEvaluator, OPTEvaluator,\n"
        "    ChoiEvaluator, RTBEvaluator)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'm3t_tpu', 'cv2'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_evaluators_default_to_the_card(tmp_path):
    import torch

    from m3t_tpu_torch import eval as teval

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for make in (lambda: teval.RBOTEvaluator("e", tmp_path, tmp_path, ["b"], ["a"]),
                 lambda: teval.YCBEvaluator("e", tmp_path, tmp_path, [1], {1: ["b"]}),
                 lambda: teval.RTBEvaluator("e", tmp_path, tmp_path, ["o"], ["d"], ["g"], [0]),
                 lambda: teval.OPTEvaluator("e", tmp_path, tmp_path, ["b"]),
                 lambda: teval.ChoiEvaluator("e", tmp_path, tmp_path, ["b"])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()
