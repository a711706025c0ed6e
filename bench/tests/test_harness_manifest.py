"""``BENCHMARK.json`` against the benchmark's contract: names, units and
keys; every cell resolves to its files; every metric has its reader and
moves an end-to-end metric that all its cells report."""
import importlib
import json
import re

import pytest

from bench import generate, harness

MAN = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves",
              "workloads"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                    r"proj|head|expan|experts_per_tok|d_model|d_ff|inner")
CELLS = [w["name"] for w in MAN["workloads"]]


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(MAN) == KEYS
    assert len(harness.ROOT.joinpath("BENCHMARK.json").read_bytes()) \
        <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(MAN["command"]) <= 32
    assert all(text(w) for w in MAN["command"])
    named = [w for w in MAN["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in MAN["paths"])
               for w in named)
    rs = MAN["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells (14 runs each, 90 s twice a cell to
    # compile, 1200 s spare) fits in 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    names += [c["name"] for c in MAN["configs"]] + CELLS
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    for c in MAN["configs"]:
        assert set(c) == CONFIG_KEYS and text(c["why"]) and \
            text(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTHS.search(k)
                   for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == CELL_KEYS and text(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == E2E_KEYS
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert set(m) == LAYER_KEYS and text(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup


def test_shares_are_percent():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w = harness.find_cell(MAN, cell)
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg == generate.load("configs", w["config"])
    assert entry["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
    for key in entry["reduced"]:
        assert key in cfg and key in cfg["source_values"]
    traffic = generate.load("traffic", w["traffic"])
    limits = generate.load("limits", cell)
    assert limits and set(limits) <= {"loss_gap", "grad_gap", "change_gap"}
    family = importlib.import_module(f"bench.families.{cfg['family']}")
    assert callable(family.Session.step)
    assert traffic["kind"] in ("graph_fullbatch", "token_stream")
    if "graph" in traffic:
        gen = generate.module("graphs", traffic["graph"]["generator"])
        assert callable(gen.pattern)


def test_every_config_is_used_and_files_differ():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_it_must(cell):
    e2e = harness.cell_metrics(MAN, cell, traced=False)
    layer = harness.cell_metrics(MAN, cell, traced=True)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in layer:
        assert m["moves"] in names


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert harness.reports(moved, cell)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_reader():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
