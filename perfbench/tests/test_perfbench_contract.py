"""``BENCHMARK.json`` against the benchmark's contract, and every file it
names found by name."""
from __future__ import annotations

import json
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "proj",
               "head_size", "expansion", "experts_per_tok", "ffn", "kv_channels")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    assert all(one_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128


def test_command_names_only_files_under_paths(bench):
    cmd = bench["command"]
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w == p or w.startswith(p + "/")
                       for p in bench["paths"]), w
            assert (ROOT / w).exists()


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        names.append(m["name"])
    assert len(set(bench["configs"][i]["name"]
                   for i in range(len(bench["configs"])))) == \
        len(bench["configs"])
    cells = [w["name"] for w in bench["workloads"]]
    assert len(set(cells)) == len(cells)
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_end_to_end_bounds_and_sources(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


def test_configs_found_and_reduced_names_no_width(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.exists() and c["file"].startswith(
            tuple(p + "/" for p in bench["paths"]))
        raw = json.loads(path.read_text())
        assert raw["source"] == c["source"]
        assert sorted(raw["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            low = key.lower()
            assert not low.endswith(("_dim", "_rank"))
            assert not any(w in low for w in WIDTH_WORDS), key
            assert key in raw, key
        assert (BENCH / "reference" / f"{raw['reference']}.py").exists()
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files)


def test_every_cell_finds_its_files(bench):
    from yardstick.harness import Cell
    for w in bench["workloads"]:
        cell = Cell.load(bench, w["name"])
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").exists()
        assert cell.own["limits"], w["name"]
        assert (BENCH / "configs" / f"{w['config']}.json").exists()


def test_four_chip_cells_within_share(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_per_layer_moves_a_metric_every_cell_reports(bench):
    from run import cell_metrics
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        for cell in m.get("workloads", cells):
            assert cell in cells
            reported = {e["name"] for e in cell_metrics(bench, cell)[0]}
            assert m["moves"] in reported, (m["name"], cell)
    for cell in cells:
        e, layer = cell_metrics(bench, cell)
        names = {x["name"] for x in e}
        assert "setup_s" in names and len(names) >= 2 and layer


def test_layer_names_agree_within_a_layer(bench):
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_files_under_paths_are_named_from_name_characters(bench):
    for p in bench["paths"]:
        for f in (ROOT / p).rglob("*"):
            if f.is_file() and "__pycache__" not in f.parts:
                rel = f.relative_to(ROOT).as_posix()
                assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
