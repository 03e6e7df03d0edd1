"""Whole runs on the CPU at a tiny size: what a run imports, the result
line, the reference against the port, and the control and each planted
fault coming out not correct."""
import json
import os
import subprocess
import sys

import pytest

from port_bench import compare, faults
from port_bench.calibrate import control_numbers
from port_bench.harness import FORBIDDEN, ROOT, Cell
from port_bench.testing import cell_names, tiny, tiny_run

CELLS = cell_names()

_IMPORTS = """
import json, sys
from port_bench.testing import tiny_run
tiny_run(sys.argv[1], trace=True)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax_and_no_jax_package(name):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", _IMPORTS, name], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_result_line_schema(name, trace):
    res = tiny_run(name, trace=trace)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    cell = Cell(name)
    wanted = cell.per_layer if trace else cell.end_to_end
    for metric, body in res["metrics"].items():
        assert metric in wanted
        assert body["unit"] == cell.units[metric]
    if not trace:  # host-clock metrics exist on the CPU too
        assert set(res["metrics"]) == set(cell.end_to_end)
    else:  # device metrics come only from a card's trace
        assert res["metrics"] == {} and "busy_s" not in res["device"]
    for check in res["checks"].values():
        assert set(check) == {"value", "limit"}
    json.dumps(res)


@pytest.mark.parametrize("name", CELLS)
def test_reference_meets_the_ports_cpu_path(name):
    """The port in f32 on the CPU (its kernels' plain versions) against
    the plain reference: rounding apart, the same."""
    res = tiny_run(name)
    assert res["correct"], res["checks"]
    for check in res["checks"].values():
        assert check["value"] < 1e-4


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference in float8 in the program's place fails the cell's
    limits."""
    cell = Cell(name)
    cfg, tr = tiny(cell)
    ok, checks = compare.judge(control_numbers(cfg, tr, 2**31 + 3, "cpu"),
                               cell.limits)
    assert not ok, checks


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in faults.for_mode(Cell(name).traffic["mode"],
                                 Cell(name).config["family"])])
def test_each_fault_is_not_correct(name, fault):
    cell = Cell(name)
    with faults.for_mode(cell.traffic["mode"], cell.config["family"])[fault]():
        res = tiny_run(name)
    assert not res["correct"], res["checks"]
