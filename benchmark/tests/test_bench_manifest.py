"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

import json
import re

import pytest

from harness import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    return mf.load_manifest()


def test_keys_and_limits(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    assert 1 <= len(manifest["paths"]) <= 16 and len(manifest["command"]) <= 32
    for w in manifest["command"]:
        assert LINE.match(w) and not w.startswith("/") and ".." not in w
    assert len(json.dumps(manifest)) <= 64 * 1024
    assert 1 <= len(manifest["configs"]) <= 24 and 1 <= len(manifest["workloads"]) <= 24
    assert 1 <= len(manifest["end_to_end"]) <= 16 and 1 <= len(manifest["per_layer"]) <= 128


def test_names_units_and_lines(manifest):
    names = {}
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in manifest[section]]
        assert len(seen) == len(set(seen)), section
        names[section] = set(seen)
        for e in manifest[section]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and section != "end_to_end" and section != "per_layer" or (
                        key == "layer" and key in e):
                    assert LINE.match(e[key]), (e["name"], key)
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/configs/") and len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names["configs"] and NAME.match(w["traffic"])
        assert w["chips"] == 1
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= names["workloads"]


def test_every_cell_reports_what_it_must(manifest):
    for cell in manifest["workloads"]:
        e2e = [m["name"] for m in mf.cell_metrics(manifest, cell, "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = mf.cell_metrics(manifest, cell, "per_layer")
        assert layer and all(m["moves"] in e2e for m in layer)


def test_every_named_file_is_found(manifest):
    for cell in manifest["workloads"]:
        cfg = mf.config(manifest, cell["config"])
        traffic = mf.traffic(cell["traffic"])
        assert callable(mf.driver(traffic["kind"]).run)
        assert cfg["name"] == cell["config"]
    for m in manifest["per_layer"]:
        assert callable(mf.metric_reader(m["name"]))
    used = {c["config"] for c in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}


def test_an_added_file_is_found_without_editing_another(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics" / "new.metric_x.py").write_text(
        "def read(ctx):\n    return None if ctx is None else 41.5\n")
    (tmp_path / "traffic" / "new-mix.json").write_text('{"kind": "pose2vid", "frames": 8}')
    assert mf.metric_reader("new.metric_x", tmp_path)(object()) == 41.5
    assert mf.metric_reader("new.metric_x", tmp_path)(None) is None
    assert mf.traffic("new-mix", tmp_path)["frames"] == 8
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "new-config.json").write_text('{"name": "new-config"}')
    manifest = {"configs": [{"name": "new-config", "file": "configs/new-config.json"}]}
    assert mf.config(manifest, "new-config", tmp_path)["name"] == "new-config"
    with pytest.raises(ValueError):
        mf.traffic("../escape", tmp_path)
