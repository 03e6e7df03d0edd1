"""The plain reference of both configurations' models, in f32.

Plain PyTorch on the flat weights of ``spec.py``: no kernels, no cache,
no batching tricks, and nothing of the program. It follows the model the
port implements, each trait written out here:

- ViT: patches projected and a learned position embedding added;
  pre-norm blocks (LayerNorm, eps 1e-6); attention applies RoPE (theta
  from the configuration, half rotation) to q and k on top of the
  position embedding; MLPs fc1-gelu(tanh)-fc2; the final LayerNorm, mean
  over tokens, and a linear head.
- LM: a token embedding, pre-norm blocks (RMSNorm, eps 1e-6), causal GQA
  with RoPE, the final RMSNorm and the unembedding by the tied table.
- Soft MoE (Puigcerver et al., Algorithm 1 with the Algorithm 2 L2 norm):
  logits = l2norm(X) @ (scale * l2norm(Phi)), with the eps added to the
  norm; dispatch softmax over the tokens, combine softmax over the slots;
  the experts are the MLP of the configuration's style; no auxiliary loss.

``Precision`` routes every matrix product: ``"f32"`` runs it in f32 with
TF32 off; ``"fp8"`` rounds both operands to float8 e4m3 (and the
backward's incoming gradient to e5m2), each tensor scaled by its absolute
maximum, the precision step below the configuration's bf16 compute. That
second form is the control of the comparison.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .spec import param_spec  # noqa: F401  (this family's parameter table)

LN_EPS = 1e-6
L2_EPS = 1e-6


def _fp8(x, dtype=torch.float8_e4m3fn):
    """x rounded to ``dtype`` under a per-tensor scale, back in f32."""
    fmax = torch.finfo(dtype).max
    scale = fmax / x.detach().abs().amax().float().clamp(min=1e-12)
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, torch.float8_e5m2)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


class Precision:
    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def mm(self, a, b):
        """a (..., k) x b (k, n), or batched (n, p, k) x (n, k, q)."""
        if self.name == "f32":
            return torch.matmul(a, b)
        if b.ndim == 2:
            lead = a.shape[:-1]
            return _Fp8Matmul.apply(a.reshape(-1, a.shape[-1]), b).reshape(
                lead + (b.shape[-1],))
        return _Fp8Matmul.apply(a, b)


class f32_matmuls:
    """Context: true f32 products (TF32 off), restored on exit."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def norm(cfg, p, x):
    if cfg["norm"] == "layernorm":
        mu = x.mean(-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(-1, keepdim=True)
        return xc * torch.rsqrt(var + LN_EPS) * p["scale"] + p["bias"]
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) + LN_EPS)
    return x * inv * p["scale"]


def act(cfg, x):
    if cfg["act"] == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def rope(x, theta: float):
    """x (B, S, H, D): rotate the two halves by position."""
    s, dim = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=x.device,
                                       dtype=torch.float32) / dim)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(cfg, prec, p, x):
    b, s, d = x.shape
    h, g, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = prec.mm(x, p["wq"].reshape(d, h * hd)).reshape(b, s, h, hd)
    k = prec.mm(x, p["wk"].reshape(d, g * hd)).reshape(b, s, g, hd)
    v = prec.mm(x, p["wv"].reshape(d, g * hd)).reshape(b, s, g, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    rep = h // g
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)

    def heads(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, s, hd)

    scores = prec.mm(heads(q), heads(k).transpose(1, 2)) / math.sqrt(hd)
    if cfg["causal"]:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    out = prec.mm(torch.softmax(scores, dim=-1), heads(v))
    out = out.reshape(b, h, s, hd).permute(0, 2, 1, 3).reshape(b, s, h * hd)
    return prec.mm(out, p["wo"].reshape(h * hd, d))


def mlp(cfg, prec, p, x):
    up = prec.mm(x, p["w_up"])
    hid = act(cfg, prec.mm(x, p["w_gate"])) * up if "w_gate" in p else \
        act(cfg, up)
    return prec.mm(hid, p["w_down"])


def l2n(x, dim):
    return x / (torch.sqrt((x * x).sum(dim, keepdim=True)) + L2_EPS)


def _entropy(w, dim):
    return -torch.where(w > 0, w * torch.log(w.clamp(min=1e-30)),
                        torch.zeros_like(w)).sum(dim)


def soft_moe(cfg, prec, p, x, telemetry: bool = False):
    """x (B, m, d) -> (y, telemetry dict or None)."""
    b, m, d = x.shape
    n, ps = cfg["num_experts"], cfg["slots_per_expert"]
    s = n * ps
    phi = p["scale"] * l2n(p["phi"].reshape(d, s), 0)
    logits = prec.mm(l2n(x, -1), phi)  # (B, m, S)
    dw = torch.softmax(logits, dim=1)  # over tokens, per slot
    cw = torch.softmax(logits, dim=2)  # over slots, per token
    slots = prec.mm(dw.transpose(1, 2), x)  # (B, S, d)
    xs = slots.reshape(b, n, ps, d).permute(1, 0, 2, 3).reshape(n, b * ps, d)
    ex = p["experts"]
    up = prec.mm(xs, ex["w_up"])
    hid = act(cfg, prec.mm(xs, ex["w_gate"])) * up if "w_gate" in ex else \
        act(cfg, up)
    ys = prec.mm(hid, ex["w_down"])
    ys = ys.reshape(n, b, ps, d).permute(1, 0, 2, 3).reshape(b, s, d)
    y = prec.mm(cw, ys)
    if not telemetry:
        return y, None
    with torch.no_grad():
        dw, cw = dw.detach(), cw.detach()
        dent, imp = _entropy(dw, 1), cw.sum(1)  # (B, S)
        cent, contrib = _entropy(cw, 2), dw.sum(2)  # (B, m)
        imp_e = imp.reshape(b, n, ps).sum(dim=(0, 2))
        tel = {
            "max_combine": cw.max(),
            "max_dispatch": dw.max(),
            "dispatch_entropy": dent.mean(),
            "combine_entropy": cent.mean(),
            "expert_importance_spread": imp_e.max() / imp_e.min().clamp(
                min=1e-9),
            "token_contribution_min": contrib.min(),
            "token_contribution_max": contrib.max(),
            "rows": {"dispatch_entropy": dent.mean(1),
                     "combine_entropy": cent.mean(1),
                     "token_contribution_min": contrib.amin(1)},
        }
    return y, tel


def block(cfg, prec, p, x, is_moe: bool, telemetry: bool = False):
    a = attention(cfg, prec, p["attn"], norm(cfg, p["norm1"], x))
    x = x + a
    xn = norm(cfg, p["norm2"], x)
    if is_moe:
        m_out, moe_tel = soft_moe(cfg, prec, p["moe"], xn, telemetry)
    else:
        m_out, moe_tel = mlp(cfg, prec, p["mlp"], xn), None
    x = x + m_out
    if not telemetry:
        return x, None
    tel = {"residual_rms": x.detach().square().mean().sqrt(),
           "max_attn_out": a.detach().abs().max()}
    if moe_tel is not None:
        tel["moe"] = moe_tel
    return x, tel


def tree(spec, leaves):
    """Nested dicts of ``leaves`` (in table order), layers as a list: the
    layout of ``spec``."""
    root: dict = {}
    for (path, _, _), leaf in zip(spec, leaves):
        node = root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    if "layers" in root:
        root["layers"] = [root["layers"][i] for i in sorted(root["layers"])]
    return root


def forward(cfg, prec, params, inputs, telemetry: bool = False,
            remat: bool = False):
    """ViT: inputs (B, m, patch_dim) -> logits (B, classes). LM: inputs
    (B, S) tokens -> logits (B, S, V). With ``telemetry`` also the
    per-layer telemetry list and, for the LM, the logit probes."""
    moe = set(cfg["moe_layers"])
    if cfg["family"] == "vit":
        pp = params["patch_proj"]
        x = prec.mm(inputs.float(), pp["w"]) + pp["b"] + params["pos_emb"]
    else:
        x = params["embed"]["table"][inputs.long()]
    tels = []
    for i, p in enumerate(params["layers"]):
        if remat and torch.is_grad_enabled():
            x = checkpoint(lambda h, p=p, i=i: block(cfg, prec, p, h,
                                                     i in moe)[0],
                           x, use_reentrant=False)
        else:
            x, t = block(cfg, prec, p, x, i in moe, telemetry)
            tels.append(t)
    x = norm(cfg, params["final_norm"], x)
    if cfg["family"] == "vit":
        logits = prec.mm(x.mean(dim=1), params["head"]["w"]) + \
            params["head"]["b"]
    else:
        table = params.get("unembed", params["embed"])["table"]
        logits = prec.mm(x, table.T)
    if not telemetry:
        return logits
    probes = None
    if cfg["family"] == "lm":
        with torch.no_grad():
            lf = logits.detach()
            ent = (torch.logsumexp(lf, -1)
                   - (torch.softmax(lf, -1) * lf).sum(-1))
            probes = {"max_abs_logit": lf.abs().amax(dim=(1, 2)),
                      "softmax_entropy": ent.mean(1),
                      "nonfinite_count": (~torch.isfinite(lf)).sum(
                          dim=(1, 2)).float()}
    return logits, tels, probes


def loss(cfg, prec, params, batch):
    """Mean cross-entropy: of the labels (ViT), of the next token (LM).
    Each block is recomputed in the backward, so three steps of the f32
    B/16 fit beside its weights, gradient and moments."""
    if cfg["family"] == "vit":
        logits = forward(cfg, prec, params, batch["patches"], remat=True)
        return F.cross_entropy(logits, batch["labels"].long())
    tokens = batch["tokens"]
    logits = forward(cfg, prec, params, tokens, remat=True)
    return F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())
