"""``BENCHMARK.json`` and the files it names, found by name:

* a configuration: the ``file`` its entry gives (``configs/<config>.json``);
* a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names the driver,
  ``harness/drivers/<kind>.py``;
* a per-layer metric: ``metrics/<metric>.py``, a module with
  ``read(ctx) -> float | None``.

No table lists them: adding a file under its folder and an entry in
``BENCHMARK.json`` is all a new cell, mix or metric needs.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(manifest["configs"], name, "configuration")
    return json.loads((root / entry["file"]).read_text())


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad traffic name {name!r}")
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def _load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(
        f"bench_{tag}_" + re.sub(r"\W", "_", path.stem), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(kind: str, bench_dir: Path = BENCH_DIR):
    """The driver module of a traffic ``kind``."""
    if not NAME.match(kind):
        raise ValueError(f"bad driver name {kind!r}")
    return _load_module(bench_dir / "harness" / "drivers" / f"{kind}.py", "driver")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read`` function of ``metrics/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"bad metric name {name!r}")
    return _load_module(bench_dir / "metrics" / f"{name}.py", "metric").read


def cell_metrics(manifest: dict, cell: dict, section: str) -> list:
    """The entries of ``section`` ('end_to_end' or 'per_layer') that the
    cell reports: those with no ``workloads`` key, and those whose
    ``workloads`` name it."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell["name"] in m["workloads"]]
