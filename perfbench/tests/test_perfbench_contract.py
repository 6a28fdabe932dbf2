"""``BENCHMARK.json`` keeps to the benchmark's contract: names and units
of the allowed characters, every per-layer metric's end-to-end metric
reported in each of its cells, a reader for every metric and the files
of every cell, and a run length that fits the full check."""

import json
import re

import _perfbench_paths  # noqa: F401
import pytest

from perfbench.harness import bench

B = json.loads((bench.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = {w["name"]: w for w in B["workloads"]}
E2E = {m["name"]: m for m in B["end_to_end"]}
LAYER = {m["name"]: m for m in B["per_layer"]}
WIDTH = re.compile(r"(_dim|_rank|hidden|intermediate|head|size|expert"
                   r"|experts_per_tok|state|latent|proj|factor)")


def _reports(cell, metric):
    return "workloads" not in metric or cell in metric["workloads"]


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((bench.ROOT / "BENCHMARK.json").read_bytes()) < 64 * 1024
    assert 1 <= len(B["paths"]) <= 16 and 1 <= len(B["command"]) <= 32
    assert 1 <= len(B["configs"]) <= 24 and 1 <= len(B["workloads"]) <= 24
    assert 1 <= len(B["end_to_end"]) <= 16
    assert 1 <= len(B["per_layer"]) <= 128
    rs = B["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_stays_in_its_paths():
    for word in B["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word.split("/")
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in B["paths"])
            assert (bench.ROOT / word).is_file()


def test_names_units_and_texts():
    for entry in B["configs"] + B["workloads"] + B["end_to_end"] + B[
            "per_layer"]:
        assert NAME.match(entry["name"]), entry["name"]
    for m in B["end_to_end"] + B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in B["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\t" not in w["why"]
        assert w["chips"] == 1
    for m in B["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
    for c in B["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(WIDTH.search(k) for k in c["reduced"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in B[group]]
        assert len(names) == len(set(names))


def test_end_to_end_bounds():
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_reports_enough(cell):
    e2e = [m for m in B["end_to_end"] if _reports(cell, m)]
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = [m for m in B["per_layer"] if cell in m.get("workloads", [])]
    assert layer
    for m in layer:
        assert _reports(cell, E2E[m["moves"]]), (cell, m["name"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_every_cell_has_its_files(cell):
    c = bench.Cell(cell)
    assert c.mix["kind"] in ("serve", "score")
    assert set(c.limits) <= {"mean_gap", "tokens_checked", "nll_mean_sq"}
    cfg = [x for x in B["configs"] if x["name"] == c.entry["config"]][0]
    assert cfg["file"] == f"perfbench/configs/{cfg['name']}.json"
    assert c.config["reduced"] == cfg["reduced"]


def test_every_metric_has_a_reader():
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_per_layer_names_a_layer_and_a_moved_metric():
    for m in B["per_layer"]:
        assert m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["workloads"] and all(w in CELLS for w in m["workloads"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
