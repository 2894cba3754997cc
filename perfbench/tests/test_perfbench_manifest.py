"""``BENCHMARK.json`` and the files it names: the import guard, the
characters of names and units, which cell reports what, and a cell added as
data alone."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from perfbench.lib import common

BENCH = common.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _py_files(sub=""):
    for d, _, files in os.walk(os.path.join(common.ROOT, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_nothing_imports_jax_or_the_jax_package():
    for path in _py_files():
        assert not set(_top_imports(path)) & set(common.FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in _py_files("reference"):
        assert "oryon_tpu_torch" not in set(_top_imports(path)), path


def test_jax_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "oryon_tpu_torch_fake", object())
    assert "oryon_tpu" not in common.jax_modules()
    monkeypatch.setitem(sys.modules, "oryon_tpu.fake", object())
    assert "oryon_tpu" in common.jax_modules()


def test_names_and_units_use_the_allowed_characters():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_entries_have_exactly_their_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    for section, keys in KEYS.items():
        for entry in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(entry) <= keys | extra, (section, entry["name"])
            assert all(0 < len(entry[k]) <= 200 and "\n" not in entry[k] and "\t" not in entry[k]
                       for k in ("why", "layer", "source") if k in entry), entry["name"]


def test_every_named_file_is_there():
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.exists(
            os.path.join(common.CHECKOUT, c["file"]))
    for w in BENCH["workloads"]:
        cell = common.load_cell(w["name"])
        assert cell["workload"]["config"] == w["config"]
        assert cell["workload"]["traffic"] == w["traffic"]
        assert os.path.exists(os.path.join(common.ROOT, "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(common.ROOT, "traffic",
                                           f"{cell['workload']['generator']}.py"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["per_layer"]:
        assert hasattr(common.layer_reader(m["name"]), "read")


def test_a_cell_reporting_a_layer_metric_reports_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells), (m["name"], cell)
    for cell in cells:
        names = [m["name"] for m in common.cell_metrics(cell, "end_to_end", BENCH)]
        assert "setup_s" in names and len(names) >= 2
        assert common.cell_metrics(cell, "per_layer", BENCH)


def test_a_workload_file_alone_adds_a_cell(tmp_path):
    shutil.copytree(common.ROOT, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(common.CHECKOUT, "BENCHMARK.json"), tmp_path)
    wl = json.load(open(tmp_path / "perfbench" / "workloads" / "serve-int8-b8.json"))
    mix = json.load(open(tmp_path / "perfbench" / "traffic" / f"{wl['traffic']}.json"))
    mix["batch"], wl["traffic"] = 4, "closed-b4"
    json.dump(mix, open(tmp_path / "perfbench" / "traffic" / "closed-b4.json", "w"))
    json.dump(wl, open(tmp_path / "perfbench" / "workloads" / "serve-int8-b4.json", "w"))

    def run(cell):
        return subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                               "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
                              text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))

    found, missing = run("serve-int8-b4"), run("serve-int8-b16")
    assert common.load_cell("serve-int8-b8")["workload"]["batch"] == 8
    assert found.returncode != 0 and found.stdout == ""
    assert "no CUDA card" in found.stderr          # found by name, stopped by the card check
    assert "no workload 'serve-int8-b16'" in missing.stderr
