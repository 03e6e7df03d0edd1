"""Host-side consumers of the model-interior telemetry tree, counterpart
of the host helpers of ``repro/serve/telemetry.py``.

``lm_apply(telemetry=True)`` returns a tree of per-layer block and MoE
routing-health stats plus per-row logit probes; the train step logs it
through ``flatten_telemetry``:

* ``flatten_telemetry``: one tree -> flat ``{name: float}`` scalars
  (``l<idx>_residual_rms``, ``moe_l<idx>_dispatch_entropy``,
  ``logits_max_abs_logit``, ...). A leaf with a leading axis (per row,
  or per layer of a scanned segment) reduces by name: ``max_*`` to its
  max, nonfinite counts to their sum, the rest to the mean. No name ends
  in a Prometheus-reserved suffix (``_total``, ``_bucket``, ``_sum``,
  ``_count``), so each renders as a gauge.
* ``telemetry_rows``: the per-row view ``{layer: {stat: (B,) array}}``.

The engine-side aggregator, the batch-variance probe and
``ServeEngine(telemetry=True)`` are not ported yet.
"""
from __future__ import annotations

from typing import Dict

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
