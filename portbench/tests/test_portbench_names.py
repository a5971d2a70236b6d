"""The harness finds every cell, configuration, mix and metric by name
and refuses an unknown one."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness
from portbench.reference.check import NUMBERS
from portbench.reference.model import param_spec

SPEC = harness.benchmark_spec()


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_cell_found_with_its_parts(name):
    cell = harness.load_cell(name)
    entry = next(w for w in SPEC["workloads"] if w["name"] == name)
    assert cell.spec["config"] == entry["config"]
    assert cell.spec["traffic"] == entry["traffic"]
    assert cell.chips == entry["chips"]
    assert set(cell.spec["limits"]) <= set(NUMBERS)
    harness.load_module("loops", cell.spec["loop"])
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert cell.per_layer
    param_spec(cell.config["config"]["pointcloud_model"])


@pytest.mark.parametrize("metric", [m["name"] for m in
                                    SPEC["end_to_end"] + SPEC["per_layer"]])
def test_metric_reader_found(metric):
    assert callable(harness.load_module("metrics", metric).read)


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_entry(config):
    with open(os.path.join(harness.ROOT, config["file"])) as f:
        data = json.load(f)
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]


@pytest.mark.parametrize("kind", ["workloads", "traffic", "configs"])
def test_unknown_name_refused(kind):
    with pytest.raises(KeyError):
        harness.load_json(kind, "nope")
    with pytest.raises(KeyError):
        harness.load_cell("nope.train")
    for code in ("metrics", "loops"):
        with pytest.raises(KeyError):
            harness.load_module(code, "nope")


def test_names_and_files_are_well_formed():
    pat = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert pat.match(entry["name"]), entry["name"]
    for root, _, files in os.walk(os.path.join(harness.ROOT, "portbench")):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), harness.ROOT)
            if "__pycache__" not in rel:
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_run_refuses_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        SPEC["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=harness.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0 and r.stdout.strip() == ""
