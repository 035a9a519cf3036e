"""Every cell, configuration, traffic mix and per-layer metric is found by
name from files of its own, and a cell added as files alone is found."""

import json
import shutil

import harness
import pytest

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_loads_by_name(cell):
    ctx = harness.load_cell(cell)
    assert ctx["config"]["name"] == ctx["cell"]["config"]
    assert hasattr(ctx["runner"], "run")
    assert any(m["name"] == "setup_s" for m in ctx["end_to_end"])
    assert len(ctx["end_to_end"]) >= 2 and ctx["per_layer"]


@pytest.mark.parametrize("name", PER_LAYER)
def test_every_per_layer_metric_has_its_reader(name):
    assert callable(harness.metric_reader(name))


@pytest.mark.parametrize("path", sorted((harness.BENCH / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_configuration_files_keep_the_record_but_for_reduced(path):
    cfg = harness.load_json(path)
    record = cfg["record"].split(",")[0]
    lines = (harness.ROOT / record).read_text().splitlines()
    rec = json.loads(lines[-1] if "last" in cfg["record"] else lines[0])
    changed = {k for k, v in rec.items() if cfg.get(k) != v}
    assert changed == set(cfg["reduced"])
    assert all(cfg["reduced"][k]["record"] == rec[k] for k in changed)
    # What the record does not give is assumed, with its value.
    assert not set(cfg["assumed"]) & set(rec)
    assert all("value" in a and a["why"] for a in cfg["assumed"].values())
    entry = [c for c in SPEC["configs"] if harness.ROOT / c["file"] == path]
    assert all(set(e["reduced"]) == set(cfg["reduced"]) for e in entry)


def test_a_cell_added_as_files_alone_is_found(tmp_path):
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "selfplay.flagship.opening", "config": "copenhagen_r4ab_puct",
                              "traffic": "selfplay_opening", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    shutil.copytree(harness.BENCH / "configs", tmp_path / "benchmark" / "configs")
    shutil.copytree(harness.BENCH / "traffic", tmp_path / "traffic")
    mix = json.loads((tmp_path / "traffic" / "selfplay_midgame.json").read_text())
    mix["start_ply_max"] = 0
    (tmp_path / "traffic" / "selfplay_opening.json").write_text(json.dumps(mix))
    ctx = harness.load_cell("selfplay.flagship.opening", tmp_path / "BENCHMARK.json", tmp_path)
    assert ctx["traffic"]["start_ply_max"] == 0
    assert ctx["config"]["name"] == "copenhagen_r4ab_puct"


def test_sub_seeds_take_large_seeds_and_differ_by_use():
    a, b = harness.sub_seed(2**33 + 5, "weights"), harness.sub_seed(2**33 + 5, "start")
    assert a != b and 0 <= a < 2**63 and harness.sub_seed(2**33 + 5, "weights") == a
