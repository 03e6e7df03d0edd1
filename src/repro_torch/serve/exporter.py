"""Prometheus text-format exporter for the serving metrics surface,
counterpart of ``repro/serve/exporter.py`` (host-only Python).

``render_prometheus`` turns one ``ServeMetrics`` (``serve/metrics.py``)
into the text exposition format (version 0.0.4): counters as
``<ns>_<name>_total``, histogram series as cumulative
``<ns>_<name>_bucket{le="..."}`` plus ``_sum``/``_count``, last-value
gauges (plain or labeled: the model-interior telemetry ``<ns>_moe_*`` /
``<ns>_model_*`` stats, ``<ns>_program_efficiency{program="..."}``), and
an optional frozen engine-config info gauge
``<ns>_engine_info{arch="...",...} 1``. ``AsyncServer`` serves it at
``/metrics``.

``parse_prometheus`` is the strict round-trip validator: every line must
match the exposition grammar, histogram buckets must be cumulative
(non-decreasing, ``+Inf`` == ``_count``), and the structured result
reproduces the counters and histograms that were rendered. The
namespace is the reference's, so one scrape config reads both.
"""
from __future__ import annotations

import re
from typing import Dict, Optional

from .metrics import ServeMetrics

NAMESPACE = "repro_serve"
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = rf'{_NAME}="(?:[^"\\\n]|\\\\|\\"|\\n)*"'
_VALUE = r"(?:[+-]?(?:\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)|[+-]?Inf|NaN)"
_COMMENT_RE = re.compile(
    rf"^# (?:HELP {_NAME} [^\n]*|TYPE {_NAME} (?:counter|gauge|histogram|"
    rf"summary|untyped))$"
)
_SAMPLE_RE = re.compile(
    rf"^({_NAME})(\{{{_LABEL}(?:,{_LABEL})*\}})? ({_VALUE})$"
)
_LABEL_RE = re.compile(rf'({_NAME})="((?:[^"\\\n]|\\\\|\\"|\\n)*)"')


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _unescape_label(v: str) -> str:
    return (v.replace("\\n", "\n").replace('\\"', '"')
            .replace("\\\\", "\\"))


def _fmt(v: float) -> str:
    """Shortest float form Prometheus accepts (no trailing zeros)."""
    return format(float(v), ".12g")


def render_prometheus(metrics: ServeMetrics,
                      info: Optional[Dict[str, object]] = None,
                      namespace: str = NAMESPACE) -> str:
    """Text exposition of `metrics` (+ an optional engine-info gauge)."""
    lines = []
    for name, val in sorted(metrics.counters.items()):
        # Counter convention: one `_total` suffix (some counters, e.g.
        # deadline_misses_total, already carry it — don't double up).
        full = f"{namespace}_{name}"
        if not full.endswith("_total"):
            full += "_total"
        lines.append(f"# TYPE {full} counter")
        lines.append(f"{full} {int(val)}")
    for name, hist in sorted(metrics.series.items()):
        full = f"{namespace}_{name}"
        lines.append(f"# TYPE {full} histogram")
        for bound, cum in zip(hist.bounds, hist.cumulative()):
            lines.append(f'{full}_bucket{{le="{_fmt(bound)}"}} {cum}')
        lines.append(f'{full}_bucket{{le="+Inf"}} {hist.count}')
        lines.append(f"{full}_sum {_fmt(hist.sum)}")
        lines.append(f"{full}_count {hist.count}")
    for name, variants in sorted(metrics.gauges.items()):
        full = f"{namespace}_{name}"
        lines.append(f"# TYPE {full} gauge")
        for _, (labels, value) in sorted(variants.items()):
            if labels:
                labelstr = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in sorted(labels.items())
                )
                lines.append(f"{full}{{{labelstr}}} {_fmt(value)}")
            else:
                lines.append(f"{full} {_fmt(value)}")
    if info:
        full = f"{namespace}_engine_info"
        labels = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in sorted(info.items())
        )
        lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full}{{{labels}}} 1")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Strictly parse + validate exposition text.

    Returns ``{"counters": {name: int}, "histograms": {name:
    {"buckets": [(le, cum), ...], "sum": float, "count": int}},
    "gauges": {name: (labels_dict, value)}}`` with the namespace prefix
    kept. Raises ``ValueError`` on any malformed line and
    ``AssertionError`` on broken histogram invariants."""
    counters: Dict[str, int] = {}
    gauges: Dict[str, tuple] = {}
    raw: Dict[str, dict] = {}  # histogram name -> parts
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            raise ValueError(f"line {lineno}: empty line inside body")
        if line.startswith("#"):
            if not _COMMENT_RE.match(line):
                raise ValueError(f"line {lineno}: bad comment {line!r}")
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {lineno}: bad sample {line!r}")
        name, labelstr, value = m.group(1), m.group(2), m.group(3)
        labels = dict(
            (k, _unescape_label(v))
            for k, v in _LABEL_RE.findall(labelstr or "")
        )
        if name.endswith("_total"):
            counters[name] = int(float(value))
        elif name.endswith("_bucket"):
            base = name[: -len("_bucket")]
            le = labels.get("le")
            if le is None:
                raise ValueError(f"line {lineno}: bucket without le")
            bound = float("inf") if le == "+Inf" else float(le)
            raw.setdefault(base, {"buckets": []})["buckets"].append(
                (bound, int(float(value)))
            )
        elif name.endswith("_sum"):
            raw.setdefault(name[: -len("_sum")], {"buckets": []}
                           )["sum"] = float(value)
        elif name.endswith("_count"):
            raw.setdefault(name[: -len("_count")], {"buckets": []}
                           )["count"] = int(float(value))
        else:
            gauges[name] = (labels, float(value))
    histograms: Dict[str, dict] = {}
    for name, parts in raw.items():
        buckets = parts.get("buckets", [])
        assert buckets, f"{name}: histogram without buckets"
        assert "sum" in parts and "count" in parts, (
            f"{name}: histogram missing _sum/_count"
        )
        bounds = [b for b, _ in buckets]
        assert bounds == sorted(bounds), f"{name}: bucket order broken"
        cums = [c for _, c in buckets]
        assert cums == sorted(cums), (
            f"{name}: bucket counts not cumulative: {cums}"
        )
        assert bounds[-1] == float("inf"), f"{name}: missing +Inf bucket"
        assert cums[-1] == parts["count"], (
            f"{name}: +Inf bucket {cums[-1]} != count {parts['count']}"
        )
        histograms[name] = {
            "buckets": buckets,
            "sum": parts["sum"],
            "count": parts["count"],
        }
    return {"counters": counters, "histograms": histograms,
            "gauges": gauges}
