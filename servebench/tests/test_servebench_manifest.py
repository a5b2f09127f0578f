"""BENCHMARK.json against the contract's shape, and every cell's files found by name."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "servebench/run.py"]
    assert bench["paths"] == ["servebench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text(bench):
    every = bench["configs"] + bench["workloads"] + bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in every]
    assert len(names) == len(set(names))
    for x in every:
        assert NAME.match(x["name"]), x["name"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for x in bench["configs"] + bench["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]


@pytest.mark.parametrize("key", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries_have_just_their_keys(bench, key):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"},
    }[key]
    for entry in bench[key]:
        assert set(entry) <= allowed, entry["name"]


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_reports_what_it_must(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    # setup_s is reported in every cell, those that later entries add too: it lists none
    assert all("workloads" not in m for m in bench["end_to_end"] if m["name"] == "setup_s")
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in wl for name, wl in e2e.items() if name != "setup_s")
        assert any(cell in m.get("workloads", cells) for m in bench["per_layer"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in e2e[m["moves"]], (m["name"], cell)


def test_layers_are_named_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    for layer in layers:
        assert 1 <= len(layer) <= 200 and "\n" not in layer


def test_cells_find_their_files_by_name(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4)
        c = configs[w["config"]]
        used.add(c["name"])
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("servebench/configs/")
        mix = os.path.join(ROOT, "servebench", "traffic", f"{w['traffic']}.json")
        with open(mix) as f:
            mix = json.load(f)
        assert mix["loop"] in ("open", "backlog")
        # a slot holds the longest prompt's power-of-two bucket and the longest output
        bucket = 1 << (mix["prompt"][1] - 1).bit_length()
        assert bucket + mix["output"][1] <= mix["max_seq"]
    assert used == set(configs)
    assert len({c["file"] for c in configs.values()}) == len(configs)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(pairs) // 4)


def test_every_metric_has_a_reader(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        path = os.path.join(ROOT, "servebench", "metrics", f"{m['name']}.py")
        with open(path) as f:
            assert "def read(run)" in f.read(), path


def test_configs_state_their_checks_and_precisions(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["check"] and all(v > 0 for v in cfg["check"].values())
        assert set(cfg["reference"]) == {"served", "control"}
        for key in c["reduced"]:
            assert key in cfg["model"] and cfg["model"][key] != cfg["published"][key]
            assert not key.endswith(("_dim", "_rank")) and key not in (
                "d_model", "d_ff", "num_heads", "num_kv_heads", "experts_per_token")
        for key, value in cfg["published"].items():
            if key not in c["reduced"]:
                assert cfg["model"][key] == value, (c["name"], key)


def test_every_config_states_a_kind_with_its_two_files(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        kind = cfg["kind"]
        assert NAME.match(kind) and "." not in kind, (c["name"], kind)
        for part in ("reference", "counts"):
            assert os.path.isfile(os.path.join(ROOT, "servebench", part, f"{kind}.py")), (
                c["name"], part)


def test_load_cell_and_readers():
    from servebench import run

    for cell in ("mixtral-8x7b.chat", "minitron-4b.decode"):
        spec = run.load_cell(cell)
        assert spec["cell"]["name"] == cell
        names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
        assert "setup_s" in names and "tokens_per_s" in names
        for n in names:
            assert callable(run.reader(n))
