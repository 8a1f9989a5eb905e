"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name: also files added in a copy, without an edit."""
import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
M = harness.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert M["paths"] == ["perfbench"]
    assert len(M["command"]) <= 32 and not any(
        w.startswith("/") or ".." in w for w in M["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_texts(kind):
    entries = M[kind]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        for key in ("why", "layer", "source"):
            if key in e and kind in ("configs", "workloads", "per_layer"):
                v = e[key]
                assert 1 <= len(v) <= 200 and "\n" not in v and "\t" not in v
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_metric_rules():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                               "device_trace")
    for c in CELLS:
        cell = harness.cell(M, c)
        reported = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in reported
    layers = {}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])


@pytest.mark.parametrize("name", CELLS)
def test_every_file_of_a_cell_is_found_by_name(name):
    cell = harness.cell(M, name)
    gen = harness.load_module("traffic", cell["mix"]["generator"])
    for fn in ("setup", "window", "traced_slice", "failures", "release",
               "check", "answers"):
        assert callable(getattr(gen, fn))
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
    assert set(cell["mix"]["limits"])


def test_files_added_in_a_copy_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "perfbench")
    man = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    here = root / "perfbench"
    cfg = json.loads((here / "configs" / "cifar-kwlarge-ode.json").read_text())
    (here / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "workloads" / "solve-b512.json").read_text())
    mix["batch"] = 1024
    (here / "workloads" / "solve-b1024.json").write_text(json.dumps(mix))
    (here / "metrics" / "new_metric.py").write_text("def read(ctx):\n    return 7.0\n")
    man["configs"].append({"name": "new-config", "source": "x",
                           "file": "perfbench/configs/new-config.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "new-cell", "config": "new-config",
                             "traffic": "solve-b1024", "chips": 1, "why": "x"})
    man["end_to_end"][0]["workloads"].append("new-cell")
    man["per_layer"].append({"name": "new_metric", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "x", "moves": "solve_images_per_s",
                             "workloads": ["new-cell"]})
    cell = harness.cell(man, "new-cell", here=here)
    assert cell["mix"]["batch"] == 1024
    assert cell["config"] == cfg
    assert [m["name"] for m in cell["per_layer"]] == ["new_metric"]
    assert harness.load_module("metrics", "new_metric", here=here).read(None) == 7.0
    assert harness.load_module("traffic", "solve", here=here).setup
