"""The readers of the program's spans (``metrics/optimizer_host_ms.py``
and the three beside it) on hand-made step records, and their entries in
``BENCHMARK.json``."""
import sys

import pytest

from port_bench import harness, testing  # noqa: F401  (testing: src/)
from port_bench.harness import ROOT, Cell, load_json
from port_bench.metrics import (optimizer_device_ms, optimizer_host_ms,
                                softmoe_host_ms, telemetry_device_ms)

from repro_torch import tracing

BENCH = load_json(ROOT / "BENCHMARK.json")
SPAN_METRICS = [m for m in BENCH["per_layer"]
                if m["source"] == "program_span"]
CARD_TRACE = {"window_s": 1.0, "busy_s": 0.5}


class Rec:
    """A step record as the readers see it."""

    def __init__(self, host=None, device=None):
        self._host, self._device = host or {}, device or {}

    def host_ms(self):
        return dict(self._host)

    def device_ms(self):
        return dict(self._device)


def _ctx(steps, traced, trace=CARD_TRACE):
    return {"trace": trace, "window": {"steps": steps, "seconds": 1.0},
            "steps_traced": traced}


@pytest.fixture
def records(monkeypatch):
    """Plants step records in a fresh ring; returns the planting call."""
    ring = tracing.deque(maxlen=1024)
    monkeypatch.setattr(tracing, "RECORDS", ring)
    return ring.extend


def test_host_over_the_untraced_tail_device_over_the_traced_steps(records):
    # a set-up step and two traced steps (slow: under the profiler, and
    # with device intervals), then three untraced steps
    host = [900.0, 500.0, 600.0, 3.0, 1.0, 2.0]
    records([Rec(host={"optim/adamw": h, "soft_moe/routing_fwd": h / 2,
                       "soft_moe/dispatch_bwd": h / 4},
                 device={"optim/adamw": 2 * h, "soft_moe/telemetry": h,
                         "lm/logit_probes": 1.0} if h >= 500 else None)
             for h in host])
    ctx = _ctx(steps=5, traced=2)
    assert optimizer_host_ms.read(ctx) == 2.0
    assert optimizer_device_ms.read(ctx) == 1100.0
    assert softmoe_host_ms.read(ctx) == 2.0 * 0.75
    assert telemetry_device_ms.read(ctx) == 551.0
    # a ring shorter than the window holds no traced step
    assert optimizer_device_ms.read(_ctx(steps=9, traced=2)) is None
    assert optimizer_host_ms.read(_ctx(steps=9, traced=6)) == 2.0


def test_nothing_to_read_gives_none(records, monkeypatch):
    records([Rec(host={"optim/adamw": 1.0}) for _ in range(4)])
    readers = (optimizer_host_ms, optimizer_device_ms, softmoe_host_ms,
               telemetry_device_ms)
    # a CPU run: no card's trace
    assert all(r.read(_ctx(4, 1, trace=None)) is None for r in readers)
    # every step of the window traced
    assert all(r.read(_ctx(2, 2)) is None for r in readers)
    # records without a device interval or a Soft-MoE span
    assert optimizer_host_ms.read(_ctx(4, 1)) == 1.0
    for r in readers[1:]:
        assert r.read(_ctx(4, 1)) is None
    # a program without step records (the module is missing)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    assert all(r.read(_ctx(4, 1)) is None for r in readers)


def test_every_span_metric_has_a_reader_and_cells_that_report_its_moves():
    names = {m["name"] for m in SPAN_METRICS}
    assert names == {
        "optimizer_host_ms.vit_train", "optimizer_device_ms.vit_train",
        "optimizer_device_ms.lm_train", "softmoe_host_ms.vit_train",
        "softmoe_host_ms.vit_infer", "telemetry_device_ms.lm_train"}
    layers = {m["layer"] for m in BENCH["per_layer"]
              if m["source"] != "program_span"}
    for m in SPAN_METRICS:
        assert callable(harness.reader(m["name"]).read)
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["layer"] in layers
        assert m["workloads"]
        for w in m["workloads"]:
            cell = Cell(w)
            assert m["moves"] in cell.end_to_end
            assert m["name"] in cell.per_layer
