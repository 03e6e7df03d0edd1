"""The reference's readings: three training steps, or inference logits.

AdamW here is written from its definition, on the flat buffers: clip the
gradient to a global norm, m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g²,
p -= lr ((m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p), with
the learning-rate schedule of the traffic's optimizer settings (linear
warm-up, inverse square root with a timescale, a linear cool-down tail).
"""
from __future__ import annotations

import math

import torch

from .. import weights
from .model import Precision, f32_matmuls, tree
from .spec import offsets, views


def schedule_lr(opt: dict, step: int) -> float:
    s = float(step)
    warm = min(s / max(opt["warmup_steps"], 1), 1.0)
    if opt["schedule"] == "rsqrt":
        base = math.sqrt(opt["timescale"]) / math.sqrt(max(s,
                                                           opt["timescale"]))
    elif opt["schedule"] == "cosine":
        base = 0.5 * (1 + math.cos(math.pi * min(max(
            s / opt["total_steps"], 0.0), 1.0)))
    elif opt["schedule"] == "linear":
        base = 1.0 - min(max(s / opt["total_steps"], 0.0), 1.0)
    else:
        base = 1.0
    tail = min(max((opt["total_steps"] - s) / max(opt["cooldown_steps"], 1),
                   0.0), 1.0)
    return opt["peak_lr"] * warm * base * tail


def train_readout(model, cfg, spec, opt: dict, seed: int, batches, device,
                  precision: str = "f32", telemetry: bool = False):
    """Three AdamW steps from the seed's weights on ``batches[:3]``, of
    the reference module ``model`` (its ``forward`` and ``loss``).

    Returns {"losses": [3 floats], "grad_norms": (leaves,) of the first
    step's clipped gradient, "change_norms": (leaves,) of the params'
    change after the three steps, "telemetry": the first step's forward
    telemetry or None}, all on the host."""
    prec = Precision(precision)
    b1, b2 = opt["b1"], opt["b2"]
    with f32_matmuls():
        flat = weights.make(spec, seed, device)
        mu, nu = torch.zeros_like(flat), torch.zeros_like(flat)
        out = {"losses": [], "telemetry": None}
        for step in (1, 2, 3):
            batch = batches[step - 1]
            if telemetry and step == 1:
                with torch.no_grad():
                    _, tels, probes = model.forward(
                        cfg, prec, tree(spec, views(spec, flat)),
                        batch["tokens"] if "tokens" in batch
                        else batch["patches"], telemetry=True)
                out["telemetry"] = {"layers": tels, "logits": probes}
            # leaves of their own over the buffer's storage: views of one
            # leaf would each take a whole-buffer gradient in the backward
            leaves = [v.detach().requires_grad_() for v in views(spec, flat)]
            value = model.loss(cfg, prec, tree(spec, leaves), batch)
            grads = torch.autograd.grad(value, leaves)
            del leaves
            out["losses"].append(float(value.detach()))
            with torch.no_grad():
                gnorm = torch.stack([g.square().sum() for g in grads]).sum() \
                    .sqrt()
                scale = torch.clamp(opt["grad_clip_norm"]
                                    / gnorm.clamp(min=1e-9), max=1.0)
                if step == 1:
                    out["grad_norms"] = (torch.stack(
                        [g.norm() for g in grads]) * scale).cpu()
                lr = schedule_lr(opt, step)
                for g, (a, b) in zip(grads, offsets(spec)):
                    g = g.reshape(-1).mul_(scale)
                    m, v, p = mu[a:b], nu[a:b], flat[a:b]
                    m.mul_(b1).add_(g, alpha=1 - b1)
                    v.mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = m / (1 - b1 ** step)
                    upd.div_((v / (1 - b2 ** step)).sqrt_().add_(opt["eps"]))
                    upd.add_(p, alpha=opt["weight_decay"])
                    p.sub_(upd, alpha=lr)
                del grads, g, upd
        del mu, nu
        out["change_norms"] = weights.change_norms(spec, flat, seed).cpu()
    return out


@torch.no_grad()
def infer_logits(model, cfg, spec, seed: int, inputs, device,
                 precision: str = "f32", rows: int = 32):
    """Logits (B, classes) of each input batch, in blocks of ``rows``."""
    prec = Precision(precision)
    with f32_matmuls():
        params = tree(spec, views(spec, weights.make(spec, seed, device)))
        return [torch.cat([model.forward(cfg, prec, params, x[i:i + rows])
                           for i in range(0, x.shape[0], rows)])
                for x in inputs]
