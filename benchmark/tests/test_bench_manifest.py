"""The manifest against the benchmark's contract: names and units, the
files each cell's names lead to, and the per-layer metrics' readers."""

import os
import re

import pytest

from benchmark import common

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = common.manifest()


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(MAN["command"]) <= 32 and all(_one_line(w)
                                             for w in MAN["command"])
    for path in MAN["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) \
        <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section in ("configs", "workloads",
                                        "per_layer"):
                assert _one_line(e[key]), (e["name"], key)
    for c in MAN["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for wk in MAN["workloads"]:
        assert NAME.match(wk["config"]) and NAME.match(wk["traffic"])


def test_metric_sources_and_bounds():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("name", [w["name"] for w in MAN["workloads"]])
def test_cell_files_found_by_name(name):
    w = common.cell(name)
    assert w["chips"] in (1, 4)
    assert w["config_entry"]["file"].startswith(MAN["paths"][0] + "/")
    assert w["conf"]["name"] == w["config"]
    assert callable(common.reference_module(w["config_entry"]["file"]).run)
    assert os.path.exists(common.traffic_path(w["traffic"]))
    __import__(f"benchmark.drivers.{w['traffic_mix']['driver']}")
    assert any(not k.startswith("_") for k in w["limits"])
    reported = [m["name"] for m in w["end_to_end"]]
    assert "setup_s" in reported and len(reported) >= 2
    assert w["per_layer"]
    for m in w["per_layer"]:
        reader = common.metric_reader(m["name"])
        assert reader.read({}) is None
        # each metric's end-to-end metric is one this cell reports
        assert m["moves"] in reported


def test_config_files_are_distinct():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in MAN["configs"]:
        assert _one_line(c["source"])
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
