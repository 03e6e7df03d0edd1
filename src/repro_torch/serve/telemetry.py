"""Host-side consumers of the model-interior telemetry tree, counterpart
of ``repro/serve/telemetry.py``.

``lm_apply(telemetry=True)`` returns a tree of per-layer block and MoE
routing-health stats plus per-row logit probes; the train step logs it
through ``flatten_telemetry``, and ``ServeEngine(telemetry=True)``
through ``TelemetryAggregator``:

* ``flatten_telemetry``: one tree -> flat ``{name: float}`` scalars
  (``l<idx>_residual_rms``, ``moe_l<idx>_dispatch_entropy``,
  ``logits_max_abs_logit``, ...). A leaf with a leading axis (per row,
  or per layer of a scanned segment) reduces by name: ``max_*`` to its
  max, nonfinite counts to their sum, the rest to the mean. No name ends
  in a Prometheus-reserved suffix (``_total``, ``_bucket``, ``_sum``,
  ``_count``), so each renders as a gauge.
* ``telemetry_rows``: the per-row view ``{layer: {stat: (B,) array}}``
  that the batch-variance probe compares slot by slot.
* ``TelemetryAggregator``: drains a backend's ``last_telemetry`` stash
  once per engine phase (``prefill`` / ``decode``) and keeps the latest
  flat stats per phase and the current tick's.
* ``batch_variance_probe``: serves one request alone and co-batched and
  reports how far the target row's per-step telemetry moves.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

_RESERVED_SUFFIXES = ("_total", "_bucket", "_sum", "_count")


def _gauge_safe(name: str) -> str:
    """``nonfinite_count`` -> ``nonfinite_count_val``: keep flat stat
    names out of the reserved suffix space."""
    if name.endswith(_RESERVED_SUFFIXES):
        return name + "_val"
    return name


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


def _reduce(name: str, arr: np.ndarray) -> float:
    """Reduce a leaf to one scalar by what the stat means."""
    if arr.ndim == 0:
        return float(arr)
    if name.startswith("max_"):
        return float(arr.max())
    if "nonfinite" in name:
        return float(arr.sum())
    return float(arr.mean())


def flatten_telemetry(tree) -> Dict[str, float]:
    """Telemetry tree (torch or numpy leaves) -> flat host scalars.

    ``tree`` is ``lm_apply``'s telemetry output: ``{"layers": {idx:
    {stat: leaf, "moe": {...}}}, "logits": {...}}``. The per-row ``rows``
    subtrees are skipped here (see ``telemetry_rows``)."""
    flat: Dict[str, float] = {}
    for idx, layer in sorted(tree.get("layers", {}).items()):
        for k, v in layer.items():
            if k == "moe":
                for mk, mv in v.items():
                    if mk == "rows":
                        continue
                    flat[_gauge_safe(f"moe_l{idx}_{mk}")] = _reduce(
                        mk, _host(mv))
            else:
                flat[_gauge_safe(f"l{idx}_{k}")] = _reduce(k, _host(v))
    for k, v in tree.get("logits", {}).items():
        flat[_gauge_safe(f"logits_{k}")] = _reduce(k, _host(v))
    return flat


def telemetry_rows(tree) -> Dict[object, Dict[str, np.ndarray]]:
    """Per-row view: ``{layer_idx: {stat: (B,)}}`` for every MoE layer
    that emitted a ``rows`` subtree, plus ``{"logits": {stat: (B,)}}``."""
    out: Dict[object, Dict[str, np.ndarray]] = {}
    for idx, layer in tree.get("layers", {}).items():
        rows = layer.get("moe", {}).get("rows")
        if rows:
            out[idx] = {k: _host(v) for k, v in rows.items()}
    logits = tree.get("logits")
    if logits:
        out["logits"] = {k: _host(v) for k, v in logits.items()}
    return out


def _to_host(tree):
    """The telemetry tree with numpy leaves: one copy to the host per
    leaf, after the model call."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return _host(tree)


class TelemetryAggregator:
    """Pulls ``(phase, telemetry tree)`` stashes off a backend and keeps
    the latest host-side stats per phase (``latest``, ``latest_rows``)
    and those of the current engine tick (``tick``). The tree moves to
    the host once per drained phase: the cost of turning the feature on,
    never of having it built in."""

    def __init__(self):
        self.latest: Dict[str, Dict[str, float]] = {}
        self.latest_rows: Dict[str, dict] = {}
        self.tick: Dict[str, Dict[str, float]] = {}
        self.drained = 0

    def begin_tick(self):
        self.tick = {}

    def drain(self, backend) -> Optional[str]:
        """Consume the backend's stash (if any); returns the phase."""
        stash = getattr(backend, "last_telemetry", None)
        if stash is None:
            return None
        backend.last_telemetry = None
        phase, tree = stash
        host = _to_host(tree)
        flat = flatten_telemetry(host)
        self.latest[phase] = flat
        self.latest_rows[phase] = telemetry_rows(host)
        self.tick[phase] = flat
        self.drained += 1
        return phase

    def gauges(self) -> Dict[str, float]:
        """Gauge names: ``moe_<phase>_l<idx>_<stat>`` for MoE routing
        health, ``model_<phase>_<stat>`` for the rest."""
        out: Dict[str, float] = {}
        for phase, flat in self.latest.items():
            for k, v in flat.items():
                if k.startswith("moe_"):
                    out[f"moe_{phase}_{k[len('moe_'):]}"] = v
                else:
                    out[f"model_{phase}_{k}"] = v
        return out


# -- batch-variance probe ---------------------------------------------------


def _collect_target_steps(engine, target, fillers,
                          max_ticks: int = 2000) -> List[dict]:
    """Drive the engine to completion, recording the target row's
    per-step decode telemetry: one ``{"layer:stat": value}`` dict per
    decode call the target took part in."""
    for req in [target] + fillers:
        engine.submit(req)
    steps: List[dict] = []
    for _ in range(max_ticks):
        if target.done and not engine.sched.pending():
            break
        entry = engine.sched.entry_for(target)
        in_decode = (entry is not None
                     and entry in engine.sched.decode_entries())
        slot = entry.slot if entry is not None else None
        engine.step()
        # only ticks whose decode call advanced the target row: it was a
        # decode entry before the tick and did not retire in it
        if in_decode and not target.done and \
                "decode" in engine.telemetry.tick:
            rows = engine.telemetry.latest_rows.get("decode", {})
            rec = {}
            for layer, stats in rows.items():
                for k, v in stats.items():
                    if np.ndim(v) >= 1 and np.shape(v)[0] > slot:
                        rec[f"{layer}:{k}"] = float(np.asarray(v)[slot])
            steps.append(rec)
    return steps


def batch_variance_probe(cfg, params, prompt, batch_size: int = 4,
                         max_new_tokens: int = 8, max_len: int = 64,
                         backend: str = "contiguous", **engine_kw) -> dict:
    """How far the serving forward pass depends on the batch's makeup.

    Serves ``prompt`` twice with telemetry on, alone (batch_size=1) and
    beside ``batch_size - 1`` distinct filler requests, and compares the
    target row's per-decode-step telemetry (per-layer MoE routing rows
    and per-row logit probes) step by step. Returns ``{"divergence",
    "per_stat", "steps_compared"}``, ``divergence`` the largest absolute
    per-step difference over all stats.

    Serving routes every arch per row (dense MLPs, Soft MoE's
    per-sequence softmaxes, and the sparse variants' dropless per-row
    routing), and the f32 products whose order a library would pick by
    the row count (the sparse router, MLA's attention and ``w_uv``
    expansion) run the fixed-order kernel
    (``kernels/invariant_matmul.py``), so the probe must read ~0 (< 1e-5)
    on EVERY served arch, on the CPU and on the card, grouped BPR Tokens
    Choice with binding capacity included: a finite reading on a default
    config is a regression. The exception is the SSM archs with random
    weights (mamba2, hymba), whose recurrences amplify rounding: the
    reference's CPU probe reads above 1e-5 there too. The one sanctioned
    way to make it read finite is the ``MoEConfig.batch_coupled=True``
    hatch with ``group_size = batch_size``, a ``capacity_factor`` low
    enough to bind and ``bpr=True``, which proves the instrument alive.
    ``backend`` defaults to ``"contiguous"``, as in the reference.
    ``engine_kw`` goes to ``ServeEngine`` (``device="cpu"`` off the
    card)."""
    from .engine import ServeEngine
    from .scheduler import Request

    def run(n_rows: int, fillers: List[list]) -> List[dict]:
        eng = ServeEngine(cfg, params, batch_size=n_rows, max_len=max_len,
                          backend=backend, telemetry=True, **engine_kw)
        tgt = Request(prompt=list(prompt), max_new_tokens=max_new_tokens)
        fil = [Request(prompt=list(f), max_new_tokens=max_new_tokens)
               for f in fillers]
        return _collect_target_steps(eng, tgt, fil)

    vocab = cfg.vocab_size
    fillers = [[(t * (i + 2) + 1) % vocab for t in prompt]
               for i in range(batch_size - 1)]
    solo = run(1, [])
    cob = run(batch_size, fillers)

    per_stat: Dict[str, float] = {}
    n = min(len(solo), len(cob))
    for a, b in zip(solo[:n], cob[:n]):
        for k in a.keys() & b.keys():
            d = abs(a[k] - b[k])
            if np.isfinite(d):
                per_stat[k] = max(per_stat.get(k, 0.0), d)
    return {
        "divergence": max(per_stat.values(), default=0.0),
        "per_stat": dict(sorted(per_stat.items())),
        "steps_compared": n,
    }
