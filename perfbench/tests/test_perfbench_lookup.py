"""Every entry of BENCHMARK.json finds its files by name, and the file
keeps to the benchmark's schema."""

import importlib
import json
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_bounds():
    entries = (BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
               + BENCH["per_layer"])
    names = [e["name"] for e in entries]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    from perfbench import harness

    c = harness.Cell(cell)
    assert c.config["model"] and c.traffic and c.limits
    driver = c.driver()
    assert callable(driver.run) and callable(driver.control)
    # each cell reports setup_s, another end-to-end metric and a layer's
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    assert set(config["reduced"]) <= set(data["assumed"])


@pytest.mark.parametrize("metric", METRICS)
def test_reader_found_by_name(metric):
    from perfbench import harness

    assert callable(harness.load_reader(metric).read)


def test_reader_shared_by_a_split_quantity():
    from perfbench import harness

    assert harness.load_reader("mfu.md").__file__.endswith("mfu.py")
    assert harness.load_reader("roofline.q_tier.md").__file__.endswith(
        "roofline.q_tier.md.py")
    with pytest.raises(harness.Refused):
        harness.load_reader("no_such_metric.md")


@pytest.mark.parametrize("group", ["embedding", "q_tier", "edge_mlp_pre"])
def test_work_group_found_by_name(group):
    mod = importlib.import_module(f"perfbench.work.{group}")
    assert callable(mod.count)
