"""The port's spans (``repro_torch/tracing.py``) on the CPU: what a
profile sees of them, the step record a train step leaves, the ring's
bound, and that neither a span nor a profiler changes a value."""
import dataclasses
import json

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import reduced, soft_moe_vit
from repro_torch.models import vit_init
from repro_torch.models.vit import vit_loss
from repro_torch.optim import OptimizerConfig, tree_leaves
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def _tiny_vit():
    """Two layers, the second a Soft-MoE layer, under remat."""
    cfg = dataclasses.replace(reduced(soft_moe_vit("s", 32, 8)),
                              num_layers=2, dtype="float32", remat=True)
    assert cfg.moe_layer_indices() == (1,)
    return cfg


def _loss(cfg):
    return lambda p, b: vit_loss(p, cfg, b, use_kernel=True)


def _batches(cfg, n, seed=1):
    gen = torch.Generator().manual_seed(seed)
    fe = cfg.frontend
    return [{"patches": torch.randn(2, fe.num_embeds, fe.embed_dim,
                                    generator=gen),
             "labels": torch.randint(0, 10, (2,), generator=gen)}
            for _ in range(n)]


def _two_steps(cfg):
    state = init_train_state(torch.Generator().manual_seed(0),
                             lambda g: vit_init(g, cfg, num_classes=10))
    step = make_train_step(_loss(cfg), OptimizerConfig(warmup_steps=1,
                                                       total_steps=10))
    out = []
    for batch in _batches(cfg, 2):
        state, metrics = step(state, batch)
        out.append(metrics)
    return state, out


def test_span_is_a_cpu_op_nested_under_its_parent(tmp_path):
    @tracing.span("test/inner")
    def inner(x):
        return x.sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("test/outer"):
            inner(torch.ones(4))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("name", "").startswith("test/")]
    by_name = {e["name"]: e for e in events}
    assert sorted(by_name) == ["test/inner", "test/outer"]
    assert len(events) == 2  # no mirror of either
    assert {e["cat"] for e in events} == {"cpu_op"}
    outer, inner_ev = by_name["test/outer"], by_name["test/inner"]
    assert outer["ts"] <= inner_ev["ts"]
    assert inner_ev["ts"] + inner_ev["dur"] <= outer["ts"] + outer["dur"]


def test_no_range_is_opened_without_a_profiler(monkeypatch):
    opened = []

    class Range:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tracing, "_Range", Range)
    with tracing.span("test/quiet", root=True):
        pass
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("test/loud"):
            pass
    assert opened == ["test/loud"]


def test_a_train_step_leaves_one_record_a_step(monkeypatch):
    cfg = _tiny_vit()
    monkeypatch.setattr(tracing, "RECORDS", tracing.deque(maxlen=1024))
    _two_steps(cfg)
    assert len(tracing.RECORDS) == 2
    for rec in tracing.step_records(2):
        assert rec.calls == {
            "train/step": 1, "vit/apply": 1,
            "train/forward": 1, "train/backward": 1,
            "optim/adamw": 1, "optim/clip": 1, "optim/update": 1,
            # the forward and the backward's remat recompute
            "soft_moe/routing_fwd": 2, "soft_moe/combine_apply": 2,
            "soft_moe/experts": 2,
            "soft_moe/dispatch_bwd": 1, "soft_moe/combine_bwd": 1,
        }
        host = rec.host_ms()
        assert all(v > 0 for v in host.values())
        assert host["train/step"] >= (host["train/forward"]
                                      + host["train/backward"]
                                      + host["optim/adamw"])
        assert host["optim/adamw"] >= host["optim/clip"] + \
            host["optim/update"]
        assert rec.device_ms() == {}  # no device interval on the CPU


def test_the_ring_keeps_only_capacity_records(monkeypatch):
    ring = tracing.deque(maxlen=3)
    monkeypatch.setattr(tracing, "RECORDS", ring)
    for i in range(5):
        with tracing.span("test/root", root=True):
            with tracing.span("test/root", root=True):  # nested: no record
                pass
    assert len(ring) == 3
    assert all(r.calls == {"test/root": 2} for r in ring)
    assert tracing.step_records(2) == list(ring)[1:]
    assert tracing.step_records(9) == list(ring)


def test_a_profiler_changes_no_value():
    cfg = _tiny_vit()
    state, metrics = _two_steps(cfg)
    with profile(activities=[ProfilerActivity.CPU]):
        p_state, p_metrics = _two_steps(cfg)
    for a, b in zip(tree_leaves(state), tree_leaves(p_state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for m, pm in zip(metrics, p_metrics):
        assert m.keys() == pm.keys()
        for k in m:
            assert torch.equal(m[k], pm[k]), k


def test_the_trainer_logs_the_last_steps_spans(tmp_path):
    cfg = _tiny_vit()
    batches = _batches(cfg, 2)

    class Feed:
        def batch(self, step):
            return batches[step]

    trainer = Trainer(
        TrainerConfig(total_steps=2, checkpoint_every=100, log_every=1,
                      checkpoint_dir=str(tmp_path)),
        _loss(cfg), lambda g: vit_init(g, cfg, num_classes=10),
        OptimizerConfig(warmup_steps=1, total_steps=10), Feed())
    trainer.run(torch.Generator().manual_seed(0))
    assert len(trainer.metrics_history) == 2
    for m in trainer.metrics_history:
        spans = {k for k in m if k.startswith("span_")}
        assert {"span_train/step_ms", "span_optim/adamw_ms",
                "span_soft_moe/dispatch_bwd_ms"} <= spans
        assert not any(k.endswith("_device_ms") for k in spans)  # CPU
        assert 0 < m["span_train/step_ms"] <= m["step_time"] * 1e3


def test_device_intervals_only_while_a_profiler_records(monkeypatch):
    """Device spans' event pairs, with fake events: made only while a
    profile records and a step record is open; ``device_ms()`` waits
    for the events and sums by name."""
    class Event:
        def synchronize(self):
            self.done = True

        def elapsed_time(self, end):
            assert self.done and end.done
            return 2.5

    made = []

    def event():
        made.append(Event())
        return made[-1]

    def steps():
        for _ in range(2):
            with tracing.span("test/root", root=True):
                for _ in range(2):
                    with tracing.span("test/dev", device=True):
                        pass
                with tracing.span("test/host"):
                    pass
        return tracing.step_records(2)

    monkeypatch.setattr(tracing, "_event", event)
    with tracing.span("test/dev", device=True):  # no record open
        pass
    assert [r.device_ms() for r in steps()] == [{}, {}] and made == []
    with profile(activities=[ProfilerActivity.CPU]):
        recs = steps()
    assert len(made) == 8
    for rec in recs:
        assert rec.device_ms() == {"test/dev": 5.0}
        assert rec.calls == {"test/root": 1, "test/dev": 2, "test/host": 1}
