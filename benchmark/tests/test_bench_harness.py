"""The benchmark's harness on the CPU at tiny sizes: every driver end to end through the
run's own code, the result line, the files found by name, the kernels' work against hand
counts, the imports, and ``correct`` against the control and the faults.

Run from the repository root: ``python -m pytest -q benchmark/tests`` (the ``cuda`` case
runs where a card is visible).
"""

from __future__ import annotations

import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import run
from benchmark.harness import roofline, spec

REPO = Path(__file__).resolve().parents[2]
CELLS = ("rbot_region.eval_b512", "rbot_region.live_b1")
CPU = torch.device("cpu")
# The live loop's cell is held back from BENCHMARK.json while the program's fused cycle
# departs from M3T's pixel probabilities (PERF.md, Open questions); its files stay, and
# its driver stays under test through this entry.
HELD_BACK = {"name": "rbot_region.live_b1", "config": "rbot_region", "traffic": "live_b1",
             "chips": 1, "why": "held back"}


def with_held_back(bench: dict) -> dict:
    if HELD_BACK["name"] not in {w["name"] for w in bench["workloads"]}:
        bench["workloads"].append(dict(HELD_BACK))
    return bench


@pytest.fixture(autouse=True)
def tiny(monkeypatch):
    """Every traffic mix at a batch of two (one body for the live loop), a short warm-up,
    two checkpoints and a two-step traced stretch."""
    load = spec.traffic

    def small(name):
        mix = load(name)
        mix.update(batch=1 if mix["batch"] == 1 else 2, warmup_steps=1, warmup_s=0,
                   checkpoints=2,
                   checkpoint_span=3, trace_steps=2)
        return mix

    monkeypatch.setattr(spec, "traffic", small)
    listed = spec.benchmark
    monkeypatch.setattr(spec, "benchmark", lambda: with_held_back(listed()))
    torch.set_num_threads(4)


def result(cell: str, trace: int = 0, side=None, seconds: float = 0.5) -> dict:
    out = io.StringIO()
    args = run.parse_args(["--workload", cell, "--seed", str(2 ** 31 + 17), "--seconds",
                           str(seconds), "--trace", str(trace)])
    assert run.measure(args, out=out, card=CPU, side=side) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(cell, trace):
    line = result(cell, trace)
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert all(pair["value"] <= pair["limit"] for pair in line["compared"].values())
    want = {m["name"] for m in spec.metrics(spec.benchmark(), cell, bool(trace))}
    # On the CPU no device metric is read; the host-clock ones are.
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_new_files_are_found_by_name(tmp_path, monkeypatch):
    """A configuration, a traffic mix, a cell and a per-layer metric added as files."""
    root = tmp_path / "benchmark"
    for kind in ("configs", "traffic", "workloads", "drivers", "metrics"):
        shutil.copytree(spec.ROOT / kind, root / kind)
    config = json.loads((root / "configs" / "rbot_region.json").read_text())
    config.update(name="rbot_region_wide", n_lines=120)
    (root / "configs" / "rbot_region_wide.json").write_text(json.dumps(config))
    mix = json.loads((root / "traffic" / "eval_b512.json").read_text())
    (root / "traffic" / "eval_b3.json").write_text(json.dumps(dict(mix, batch=3)))
    cell = json.loads((root / "workloads" / "rbot_region.eval_b512.json").read_text())
    cell.update(config="rbot_region_wide", traffic="eval_b3")
    (root / "workloads" / "rbot_region_wide.eval_b3.json").write_text(json.dumps(cell))
    (root / "metrics" / "window_steps.py").write_text(
        "def read(run):\n    return len(run.step_s)\n")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [{"name": "rbot_region_wide.eval_b3", "config": "rbot_region_wide",
                           "traffic": "eval_b3", "chips": 1, "why": "test"}]
    bench["end_to_end"].append({"name": "window_steps", "unit": "steps", "better": "higher",
                                "bound": 0.1, "source": "host_clock"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "ROOT", root)
    monkeypatch.setattr(spec, "REPO", tmp_path)
    line = result("rbot_region_wide.eval_b3")
    assert line["correct"] is True
    assert line["metrics"]["window_steps"]["value"] >= 1


def test_sample_lines_work_matches_hand_count():
    """Two bodies, three lines, kp = 4 samples, a 5x5 crop: params read on 5 of 8 rows,
    the distinct crop words the staircases touch, the samples written and the tables."""
    b, lp, kp, c = 2, 3, 4, 5
    params = torch.zeros((b, 8, lp))
    params[:, roofline.ROW_UDOM] = 1.0      # walk along u
    params[:, roofline.ROW_DIR] = 1.0
    params[:, roofline.ROW_R0] = torch.tensor([0.0, 1.0, 1.0])   # lines 1 and 2 overlap
    table = torch.zeros((b, 64))
    n_bytes, n_ops = roofline.sample_lines_work(params, torch.zeros((b, c, c)), table, kp)
    # Per body: line 0 touches (row 0, cols 0..3), lines 1 and 2 (row 0, cols 1..4):
    # 5 distinct words, 10 over both bodies.
    assert n_bytes == b * 5 * lp * 4 + 10 * 4 + b * kp * lp * 4 + b * 64 * 4
    assert n_ops == 10 * b * kp * lp
    n_bytes, _ = roofline.sample_lines_work(params, torch.zeros((b, c, c)), None, kp, "bins")
    assert n_bytes == b * 5 * lp * 4 + 10 * 4 + b * kp * lp * 4


def test_sampled_words_follow_the_slope():
    """A line along v with slope 0.5 across it, from (row 1, col 0.25): rows 1..4 and
    columns floor(0.25 + 0.5 k)."""
    params = torch.zeros((1, 8, 1))
    params[0, roofline.ROW_R0] = 1.0
    params[0, roofline.ROW_S0] = 0.25
    params[0, roofline.ROW_STEP] = 0.5
    params[0, roofline.ROW_DIR] = 1.0
    words = roofline.sampled_words(params, 5, 4)[0, :, 0].tolist()
    assert words == [1 * 5 + 0, 2 * 5 + 0, 3 * 5 + 1, 4 * 5 + 1]


def test_sphere_model_matches_a_rendered_one():
    """The closed-form model against the port's model of the sphere rendered at n_divides
    2 (800 px): the same views, and each rendered contour point near the circle, its
    normal near the circle's, its foreground about as long.  The rendered body is a
    polyhedron of 320 faces, so its contour strays from the sphere's by up to 1 cm along
    the view (measured: 9.8 mm), 2 mm across it, 17 degrees in its normal and 5 % in its
    foreground."""
    import numpy as np

    from benchmark.harness import models

    with np.load(REPO / "m3t_tpu_torch" / "data" / "bench_sphere_region_model.npz") as f:
        rendered = {k: f[k] for k in f.files}
    config = spec.config("rbot_region")
    closed = models.sphere_region_model(
        dict(config, region_model=dict(config["region_model"], n_divides=2)))
    match = np.argmax(rendered["orientations"] @ closed["orientations"].T, axis=1)
    assert np.allclose(rendered["orientations"], closed["orientations"][match], atol=1e-6)
    r, d = config["body_radius"], config["region_model"]["sphere_radius"]
    to_camera = -closed["orientations"][match][:, None]
    centers, normals = rendered["centers"], rendered["normals"]
    height = (centers * to_camera).sum(-1)
    radial = centers - height[..., None] * to_camera
    rho = np.linalg.norm(radial, axis=-1)
    assert np.abs(height - r * r / d).max() < 1.2e-2
    assert np.abs(rho - r * np.sqrt(1 - (r / d) ** 2)).max() < 2.5e-3
    cosine = (normals * radial).sum(-1) / rho
    assert cosine.min() > np.cos(np.radians(20.0))
    assert np.abs(rendered["foreground_distances"] / closed["foreground_distances"][match]
                  - 1.0).max() < 0.06
    assert (rendered["background_distances"] == closed["background_distances"][match]).all()


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_reference_loads_neither_jax_nor_the_program():
    loaded = _loaded("import benchmark.reference.region")
    assert not loaded & {"jax", "jaxlib", "flax", "m3t_tpu", "m3t_tpu_torch"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_loads_no_jax(cell):
    code = ("import io, torch\nfrom benchmark import run\nfrom benchmark.harness import spec\n"
            "from benchmark.tests.test_bench_harness import with_held_back\n"
            "listed = spec.benchmark\n"
            "spec.benchmark = lambda: with_held_back(listed())\n"
            "load = spec.traffic\n"
            "def small(n):\n    m = load(n)\n"
            "    m.update(batch=1 if m['batch'] == 1 else 2, warmup_steps=1, warmup_s=0,"
            " checkpoints=1,"
            " checkpoint_span=1)\n    return m\n"
            "spec.traffic = small\n"
            f"a = run.parse_args(['--workload', '{cell}', '--seed', '5', '--seconds', '0.2'])\n"
            "assert run.measure(a, out=io.StringIO(), card=torch.device('cpu')) == 0")
    loaded = _loaded(code)
    assert "m3t_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "m3t_tpu"}


def _module(cell):
    return spec.load_module("drivers", spec.cell(cell)["driver"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    """The reference with TF32 matmuls in the program's place."""
    module = _module(cell)
    line = result(cell, side=lambda d: module.reference_side(d, tf32=True))
    assert line["correct"] is False


def _unchanged(cell):
    """A step that returns its state unchanged."""
    if cell.endswith("live_b1"):
        return lambda d: (lambda pcfg, intr, images, model, state, **kw: state)
    program = _module(cell).program_side
    return lambda d: program(d)._replace(cycle=lambda *a: a[-1])


def _altered(cell):
    """The first body's x translation moved by 10 cm where the step produces it."""
    module = _module(cell)
    program = module.program_side

    def nudge(state):
        field = state[0].clone()
        field.reshape(-1, 4, 4)[0, 0, 3] += 0.1
        return type(state)(field, *state[1:])

    if cell.endswith("live_b1"):
        return lambda d: (lambda *a, **kw: nudge(program(d)(*a, **kw)))

    def side(d):
        own = program(d)
        return own._replace(cycle=lambda *a: nudge(own.cycle(*a)))
    return side


def _half(cell):
    """The second half of the batch left out: its state passes through unchanged."""
    module = _module(cell)
    program = module.program_side

    def side(d):
        own = program(d)

        def step(*a):
            state = a[-1]
            out = own.cycle(*a)
            half = state[0].shape[0] // 2
            return type(out)(*(torch.cat([o[:half], s[half:]]) for o, s in zip(out, state)))
        return own._replace(cycle=step)
    return side


FAULTS = [(cell, fault) for cell in CELLS for fault in ("unchanged", "altered", "half")
          if not (fault == "half" and cell.endswith("live_b1"))]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(cell, fault):
    side = {"unchanged": _unchanged, "altered": _altered, "half": _half}[fault](cell)
    assert result(cell, side=side)["correct"] is False


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", str(2 ** 31 + 3), "--seconds", "2", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
