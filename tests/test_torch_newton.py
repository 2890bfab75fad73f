"""The rigid cycle's Newton step (``ops/newton.py``): the ``newton_step`` kernel against
its plain twin, the twin against the step computed in float64 from its definition,
``pipeline._solve_and_update``'s group sum, the wrapper's argument checks and its launch
counter.  No JAX.

The tests marked ``cuda`` need a card and skip without one.  Run them there with

    python -m pytest --noconftest -q tests/test_torch_newton.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from m3t_tpu_torch import graphs, pipeline
from m3t_tpu_torch.common import Intrinsics, pose_variation
from m3t_tpu_torch.ops import _cuda, newton
from m3t_tpu_torch.ops.region_fn import RegionConfig
from m3t_tpu_torch.utils import procedural

NPZ = Path(pipeline.__file__).parent / "data" / "bench_sphere_region_model.npz"
ROTATION, TRANSLATION = 1000.0, 30000.0  # PipelineConfig's Tikhonov defaults


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    graphs.clear_graphs()
    yield torch.device("cuda")
    graphs.clear_graphs()


def _float64_step(gradient, hessian, pose):
    """The step in float64 numpy, written from its definition (optimizer.cpp:144-167,
    Rodrigues' formula): theta solves (diag(rotation x 3, translation x 3) - hessian)
    theta = gradient, 0 where any entry is NaN; pose @ [[exp(skew(w)), t], [0, 1]]."""
    g, h, p = (np.asarray(t, np.float64) for t in (gradient, hessian, pose))
    a = np.diag([ROTATION] * 3 + [TRANSLATION] * 3) - h
    out = np.empty_like(p)
    for i in range(len(g)):
        theta = np.zeros(6) if np.isnan(g[i]).any() else np.linalg.solve(a[i], g[i])
        w, angle = theta[:3], np.linalg.norm(theta[:3])
        k = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
        rotation = np.eye(3)
        if angle > 0.0:
            rotation += np.sin(angle) / angle * k + (1.0 - np.cos(angle)) / angle**2 * k @ k
        variation = np.eye(4)
        variation[:3, :3], variation[:3, 3] = rotation, theta[3:]
        out[i] = p[i] @ variation
    return out


def _systems(b: int, seed: int, kind: str = "random"):
    """(gradient, hessian, pose) of b bodies: well-conditioned symmetric Hessians (minus
    a Gram matrix, as the modalities' terms are) and gradients that move the pose by
    about 0.1 rad and 1 cm; ``kind`` "nan" puts a NaN into body 0's gradient, "taylor"
    scales body 0's gradient so that its |theta| stays under 1e-6."""
    rng = np.random.default_rng(seed)
    m = rng.normal(0.0, 30.0, (b, 6, 6))
    hessian = -(m @ m.transpose(0, 2, 1))
    gradient = rng.normal(0.0, 100.0, (b, 6)) * np.array([10, 10, 10, 3, 3, 3])
    if kind == "nan":
        gradient[0, 4] = np.nan
    elif kind == "taylor":
        gradient[0] *= 1e-7
    twist = rng.normal(0.0, 0.5, (b, 6)).astype(np.float32)
    pose = pose_variation(torch.as_tensor(twist))
    pose[:, 2, 3] += 0.6
    return (torch.as_tensor(gradient.astype(np.float32)),
            torch.as_tensor(hessian.astype(np.float32)), pose.contiguous())


# ---------------------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "nan", "taylor"])
def test_plain_step_matches_float64_step(kind):
    """On CPU tensors newton_step (its plain twin) is the step computed in float64 from
    its definition, every pose entry within 1e-5, also where a body's |theta| is under 1e-6
    (so3_exp's Taylor branch); a NaN leaves its body's pose as it was."""
    gradient, hessian, pose = _systems(16, 3, kind)
    got = newton.newton_step(gradient, hessian, pose, ROTATION, TRANSLATION)
    np.testing.assert_allclose(got.numpy(), _float64_step(gradient, hessian, pose),
                               rtol=0.0, atol=1e-5)
    if kind == "nan":
        assert torch.equal(got[0], pose[0])


@pytest.mark.parametrize("grouped", [False, True])
def test_solve_and_update_ties_group_slots(grouped):
    """pipeline._solve_and_update passes its configuration's Tikhonov weights to
    newton_step; with a pose_group every slot of a group takes one identical pose, the
    step of the group's summed terms, and different groups differ."""
    gradient, hessian, pose = _systems(6, 4)
    pcfg = pipeline.PipelineConfig(tikhonov_rotation=ROTATION,
                                   tikhonov_translation=TRANSLATION)
    if not grouped:
        got = pipeline._solve_and_update(pcfg, gradient, hessian, pose)
        assert torch.equal(got, newton.newton_step(gradient, hessian, pose, ROTATION,
                                                   TRANSLATION))
        return
    group = torch.tensor([0, 0, 0, 3, 4, 4], dtype=torch.int32)
    pose = pose[group.long()].contiguous()
    got = pipeline._solve_and_update(pcfg, gradient, hessian, pose, group=group)
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    assert torch.equal(got[4], got[5])
    assert not torch.equal(got[0], got[3]) and not torch.equal(got[3], got[4])
    for slots in ([0, 1, 2], [3], [4, 5]):
        want = _float64_step(gradient[slots].double().sum(0, keepdim=True),
                             hessian[slots].double().sum(0, keepdim=True), pose[slots[:1]])
        np.testing.assert_allclose(got[slots[0]].numpy(), want[0], rtol=0.0, atol=1e-5)


def _bad_inputs():
    g, h, p = _systems(3, 5)
    return {
        "float64 gradient": (g.double(), h, p),
        "float64 hessian": (g, h.double(), p),
        "float64 pose": (g, h, p.double()),
        "gradient (B, 5)": (g[:, :5], h, p),
        "hessian (B, 6, 5)": (g, h[:, :, :5], p),
        "hessian of another batch": (g, h[:2], p),
        "pose (B, 3, 4)": (g, h, p[:, :3]),
        "non-contiguous gradient": (torch.zeros(6, 3).t(), h, p),
        "non-contiguous hessian": (g, h.transpose(1, 2), p),
        "non-contiguous pose": (g, h, p.transpose(1, 2)),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_rejects_inputs(case):
    """The wrapper raises on what the kernel does not take, on the CPU as on the card."""
    launches = newton.newton_step.launches
    with pytest.raises(ValueError):
        newton.newton_step(*_bad_inputs()[case], ROTATION, TRANSLATION)
    assert newton.newton_step.launches == launches


def test_kernel_counters_list_newton_step():
    """Graph replays add the kernel's captured launches to its counter; the CPU twin
    counts none."""
    assert newton.newton_step in _cuda.wrappers()
    launches = newton.newton_step.launches
    newton.newton_step(*_systems(4, 6), ROTATION, TRANSLATION)
    assert newton.newton_step.launches == launches


def _scene(device, n_bodies=4, group=False):
    """A 320x240 view of the committed sphere model at jittered poses, at the eval
    configuration's 5 x 2 iterations.  With ``group``, slots (0, 1) and (2, 3) share a
    pose and each slot of a pair sees a frame of its own noise."""
    pcfg = pipeline.PipelineConfig(cfg=RegionConfig(n_lines_max=200, n_histogram_bins=16),
                                   n_corr_iterations=5, n_update_iterations=2)
    intr_t = Intrinsics(300.0, 300.0, 159.5, 119.5, 320, 240)
    rng = np.random.default_rng(11)
    pose0 = np.eye(4, dtype=np.float32)
    pose0[2, 3] = 0.5
    frames = [procedural.render_synthetic_color_frame(
        procedural.sphere_triangles(0.06, 2), intr_t, pose0, noise_rng=rng)
        for _ in range(2 if group else 1)]
    images = torch.as_tensor(np.stack([frames[i % len(frames)] for i in range(n_bodies)]),
                             device=device)
    poses = np.tile(pose0, (n_bodies, 1, 1))
    poses[:, :2, 3] += rng.uniform(-0.01, 0.01, (n_bodies, 2)).astype(np.float32)
    if group:
        poses[1::2] = poses[0::2]
    model = pipeline.RegionModelArrays.from_npz(str(NPZ), 200, device=device)
    intr = (intr_t.fu, intr_t.fv, intr_t.ppu, intr_t.ppv)
    return pcfg, intr, model.expand(n_bodies), images, torch.as_tensor(poses, device=device)


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_grouped_cycle_gives_a_group_one_pose(request, device):
    """A tracking_cycle with pose_group gives every slot of a group the identical pose,
    though the slots see frames of different noise (ungrouped, they part)."""
    if device == "cuda":
        request.getfixturevalue("cuda_device")
    pcfg, intr, model, images, poses = _scene(torch.device(device), group=True)
    state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
    group = torch.tensor([0, 0, 2, 2], dtype=torch.int32, device=device)
    grouped = pipeline.tracking_cycle(pcfg, intr, images, model, state, pose_group=group)
    pose = grouped.body2camera_pose
    assert torch.equal(pose[0], pose[1]) and torch.equal(pose[2], pose[3])
    assert not torch.equal(pose[0], pose[2])
    free = pipeline.tracking_cycle(pcfg, intr, images, model, state).body2camera_pose
    assert not torch.equal(free[0], free[1])


# ---------------------------------------------------------------------------------------
# On the card (marker "cuda")
# ---------------------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 7, 512])
@pytest.mark.parametrize("kind", ["random", "nan", "taylor"])
def test_kernel_matches_plain_on_card(cuda_device, b, kind):
    """The kernel against its plain twin on the card, every pose entry within 1e-6: 20
    random batches, or one whose body 0 has a NaN (its pose unchanged) or a |theta|
    under 1e-6 (so3_exp's Taylor branch)."""
    for seed in range(20 if kind == "random" else 1):
        gradient, hessian, pose = (t.to(cuda_device) for t in _systems(b, seed, kind))
        launches = newton.newton_step.launches
        got = newton.newton_step(gradient, hessian, pose, ROTATION, TRANSLATION)
        want = newton.newton_step_plain(gradient, hessian, pose, ROTATION, TRANSLATION)
        torch.cuda.synchronize()
        assert newton.newton_step.launches == launches + 1
        assert got.shape == (b, 4, 4)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
        if kind == "nan":
            assert torch.equal(got[0], pose[0])
        if kind == "taylor":
            a = -hessian[:1] + torch.diag(torch.tensor([ROTATION] * 3 + [TRANSLATION] * 3,
                                                       device=cuda_device))
            theta = newton._ldlt_solve_6x6(a, gradient[:1]).abs().max()
            assert 0.0 < float(theta) < 1e-6


@pytest.mark.cuda
def test_graphed_cycle_counts_ten_launches_per_replay(cuda_device):
    """A graphed tracking_cycle at 5 x 2 iterations launches the kernel once per Newton
    step: 10 in its capturing call, 10 in each replay, as its eager twin."""
    pcfg, intr, model, images, poses = _scene(cuda_device)
    state = pipeline.initialize_histograms(pcfg, intr, images, model, poses)
    steps = pcfg.n_corr_iterations * pcfg.n_update_iterations
    with graphs.disable_graphs():
        launches = newton.newton_step.launches
        eager = pipeline.tracking_cycle(pcfg, intr, images, model, state)
        assert newton.newton_step.launches == launches + steps
    for _ in range(3):
        launches = newton.newton_step.launches
        graphed = pipeline.tracking_cycle(pcfg, intr, images, model, state)
        assert newton.newton_step.launches == launches + steps
        assert torch.equal(graphed.body2camera_pose, eager.body2camera_pose)
    (info,) = graphs.captured()
    assert info.replays == 2 and info.launches["newton_step"] == steps
