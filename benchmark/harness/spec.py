"""The benchmark's files, found by name.

``BENCHMARK.json`` (the repository root) lists the cells and metrics.  Each cell
``<cell>`` has ``workloads/<cell>.json`` (its configuration, driver, traffic mix, chips,
why and the limits of its comparison), each configuration ``configs/<config>.json``,
each traffic mix ``traffic/<traffic>.json``, each driver ``drivers/<driver>.py`` and each
per-layer metric ``metrics/<metric>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
REPO = ROOT.parent


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    return json.loads(path.read_text())


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's file, checked against its entry in BENCHMARK.json."""
    bench = benchmark() if bench is None else bench
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    spec = _json("workloads", name)
    for key in ("config", "traffic", "chips"):
        if spec[key] != entries[name][key]:
            raise ValueError(f"workloads/{name}.json: {key} {spec[key]!r} differs from "
                             f"BENCHMARK.json's {entries[name][key]!r}")
    return spec


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = ROOT / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"benchmark.{kind}.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: end-to-end untraced, per-layer traced;
    a metric with a ``workloads`` list only in those cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]
