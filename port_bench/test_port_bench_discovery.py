"""The benchmark finds every cell, configuration, traffic mix and metric
by name, and a new one is picked up from files alone."""
import json
import shutil

import pytest

from port_bench import harness, program
from port_bench.harness import ROOT, Cell, load_json
from port_bench.reference.spec import param_spec
from port_bench.testing import TINY_CONFIG, cell_names

BENCH = load_json(ROOT / "BENCHMARK.json")
CELLS = cell_names()


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = Cell(name)
    assert cell.traffic["mode"] in ("train", "infer")
    assert cell.limits, f"{name} has no limits file under port_bench/cells"
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for metric in cell.end_to_end + cell.per_layer:
        assert callable(harness.reader(metric).read)
        assert metric in cell.units


def test_every_metric_has_a_reader_and_moves_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert callable(harness.reader(m["name"]).read)
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert m["moves"] in Cell(w).end_to_end


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_file_is_the_ports_configuration(config):
    from repro_torch.configs import get_config

    cfg = load_json(ROOT / config["file"])
    assert cfg["name"] == config["name"]
    assert program.port_config(cfg) == get_config(cfg["program"])


@pytest.mark.parametrize("family", ["vit", "lm"])
def test_parameter_table_matches_the_ports_tree(family):
    """At a tiny size, the benchmark's table of leaves has the paths and
    shapes of the port's own init, in its order."""
    import torch

    from repro_torch.models import lm_init, vit_init
    from repro_torch.optim import tree_leaves

    config = [c for c in BENCH["configs"]
              if load_json(ROOT / c["file"])["family"] == family][0]
    cfg = dict(load_json(ROOT / config["file"]), **TINY_CONFIG[family])
    pcfg = program.port_config(cfg)
    gen = torch.Generator().manual_seed(0)
    ours = program.params_tree(param_spec(cfg), torch.zeros(
        sum(torch.Size(s).numel() for _, s, _ in param_spec(cfg))))
    if family == "vit":
        theirs = vit_init(gen, pcfg, num_classes=cfg["num_classes"])
    else:
        theirs = lm_init(gen, pcfg)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(ours) == shapes(theirs)
    assert [t.shape for t in tree_leaves(ours)] == \
        [t.shape for t in tree_leaves(theirs)]


def test_a_cell_added_as_files_is_picked_up(tmp_path):
    """A new workload entry and a new traffic file in a copy of the
    benchmark: the harness's files are not edited."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "vit-b16-128e.infer-b8", "config": "soft-moe-b16-128e",
        "traffic": "vit-infer-b8", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "port_bench" / "traffic" / "vit-infer-b8.json").write_text(
        json.dumps({"mode": "infer", "batch": 8, "ring": 4}))
    cell = Cell("vit-b16-128e.infer-b8", root=tmp_path)
    assert cell.traffic["batch"] == 8
    assert cell.config["name"] == "soft-moe-b16-128e"
    assert cell.end_to_end == ["setup_s"]
    assert cell.per_layer == []


def test_benchmark_json_keeps_the_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
