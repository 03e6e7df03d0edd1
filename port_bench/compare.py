"""The comparison that decides ``correct``: the numbers read from the
program's outputs against the plain reference's, each held to a limit.

Training (both sides' readings of the same three steps from the same
weights and batches):
- ``loss_gap``: the largest |loss - reference loss| / |reference loss|
  of the three steps;
- ``grad_norm_gap``: the first step's gradient as the optimizer took it
  (on the program's side read back from its first moment, mu / (1 - b1)),
  by the worst leaf: |norm - reference norm| over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_norm_gap``: the same of each leaf's change after the three
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone);
- ``telemetry_gap`` (where the step reports telemetry): the first step's
  routing health, residual and logit probes, by the worst element:
  |value - reference| / max(|reference|, 1e-6).

Inference (every answer of the window against the reference's logits of
its input):
- ``logit_err``: the largest |logit - reference logit| of a row over the
  standard deviation of the reference's row;
- ``top1_gap``: the largest (reference's best logit - its logit at the
  program's first class) over that standard deviation.

A reading that is not finite is infinite, so it fails every limit.
"""
from __future__ import annotations

import math

import torch

MOVED_SHARE = 1e-3  # a leaf with less reference gradient than this share
# of the median leaf's moves by round-off alone


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _norm_gap(prog, ref, keep=None):
    prog, ref = prog.double(), ref.double()
    if keep is not None:
        prog, ref = prog[keep], ref[keep]
    floor = torch.clamp(ref, min=float(ref.median()))
    gap = (prog - ref).abs() / floor
    return _finite(float(torch.nan_to_num(gap, nan=math.inf).max()))


def flat_telemetry(tel) -> dict:
    """{leaf name: 1-D f32 tensor}, layers in order. Takes the program's
    tree (layers keyed by index or by segment start with stacked leaves)
    or the reference's (a list of per-layer dicts)."""
    out: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}/")
        else:
            out.setdefault(prefix[:-1], []).append(
                torch.as_tensor(node).detach().float().reshape(-1).cpu())

    layers = tel["layers"]
    if isinstance(layers, dict):
        layers = [layers[k] for k in sorted(layers)]
    for layer in layers:
        walk(layer, "layers/")
    if tel.get("logits") is not None:
        walk(tel["logits"], "logits/")
    return {k: torch.cat(v) for k, v in out.items()}


def moved(grad_norms):
    """Mask of the leaves whose reference gradient is at least
    ``MOVED_SHARE`` of the median leaf's."""
    return grad_norms >= MOVED_SHARE * float(grad_norms.median())


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training cell's numbers from two readouts (``train_readout``'s
    keys)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"]))
    out = {
        "loss_gap": _finite(loss),
        "grad_norm_gap": _norm_gap(prog["grad_norms"], ref["grad_norms"]),
        "update_norm_gap": _norm_gap(prog["change_norms"],
                                     ref["change_norms"],
                                     moved(ref["grad_norms"])),
    }
    if ref.get("telemetry") is not None:
        p, r = flat_telemetry(prog["telemetry"]), flat_telemetry(
            ref["telemetry"])
        worst = 0.0
        for name, rv in r.items():
            pv = p.get(name)
            if pv is None or pv.shape != rv.shape:
                worst = math.inf
                break
            gap = (pv.double() - rv.double()).abs() / torch.clamp(
                rv.double().abs(), min=1e-6)
            worst = max(worst, float(torch.nan_to_num(gap, nan=math.inf)
                                     .max()))
        out["telemetry_gap"] = _finite(worst)
    return out


def infer_numbers(answers, ref_logits) -> dict:
    """answers: [(ring index, logits (B, C), top-5 (B, 5) on the host)];
    ref_logits: the reference's logits of each ring input. A window with
    no answer reads infinite."""
    if not answers:
        return {"logit_err": math.inf, "top1_gap": math.inf}
    err = top1 = 0.0
    stats = []
    for r in ref_logits:
        r = r.double()
        stats.append((r, r.std(dim=-1), r.max(dim=-1).values))
    for idx, logits, top5 in answers:
        r, sd, best = stats[idx]
        e = ((logits.double() - r).abs().amax(dim=-1) / sd).max()
        picked = r.gather(-1, top5[:, :1].to(r.device).long())[:, 0]
        t = ((best - picked) / sd).max()
        err = max(err, float(torch.nan_to_num(e, nan=math.inf)))
        top1 = max(top1, float(torch.nan_to_num(t, nan=math.inf)))
    return {"logit_err": _finite(err), "top1_gap": _finite(top1)}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at most its
    limit; a number with no limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, checks
