"""The parameter table of a configuration: every leaf's path, shape and
initial distribution, in one fixed order.

The benchmark makes all weights from this table (``port_bench.weights``),
and the plain reference reads them through it, so both sides see the same
values. Paths follow the layout the port's models take (``models/vit.py``,
``models/lm.py``: dicts of tensors, a list of layers); the reference
defines that layout here on its own, and a CPU test holds it to the
port's ``vit_init`` / ``lm_init`` trees.

An init is ``("normal", std)``, ``("zeros",)`` or ``("ones",)``. Matrices
draw a normal of std 1/sqrt(fan_in), embeddings 0.02; the ViT's head is
random too, so the first step's gradient reaches every layer.
"""
from __future__ import annotations

import math


def _normal(fan_in: int):
    return ("normal", 1.0 / math.sqrt(fan_in))


def _norm(cfg, d):
    if cfg["norm"] == "layernorm":
        return [(("scale",), (d,), ("ones",)), (("bias",), (d,), ("zeros",))]
    return [(("scale",), (d,), ("ones",))]


def _mlp(d, f, style, lead=()):
    leaves = [(("w_up",), lead + (d, f), _normal(d)),
              (("w_down",), lead + (f, d), _normal(f))]
    if style == "gated":
        leaves.append((("w_gate",), lead + (d, f), _normal(d)))
    return leaves


def _prefix(prefix, leaves):
    return [(tuple(prefix) + p, shape, init) for p, shape, init in leaves]


def _block(cfg, is_moe):
    d, h, g, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                   cfg["head_dim"])
    leaves = _prefix(("norm1",), _norm(cfg, d))
    leaves += [
        (("attn", "wq"), (d, h, hd), _normal(d)),
        (("attn", "wk"), (d, g, hd), _normal(d)),
        (("attn", "wv"), (d, g, hd), _normal(d)),
        (("attn", "wo"), (h, hd, d), _normal(h * hd)),
    ]
    leaves += _prefix(("norm2",), _norm(cfg, d))
    if is_moe:
        n, p = cfg["num_experts"], cfg["slots_per_expert"]
        leaves += [(("moe", "phi"), (d, n, p), _normal(d)),
                   (("moe", "scale"), (), ("ones",))]
        leaves += _prefix(("moe", "experts"),
                          _mlp(d, cfg["expert_d_ff"], cfg["mlp_style"], (n,)))
    else:
        leaves += _prefix(("mlp",), _mlp(d, cfg["d_ff"], cfg["mlp_style"]))
    return leaves


def param_spec(cfg: dict):
    """[(path, shape, init)] of every leaf of the configuration."""
    d = cfg["d_model"]
    moe = set(cfg["moe_layers"])
    if cfg["family"] == "vit":
        leaves = [(("patch_proj", "w"), (cfg["patch_dim"], d),
                   _normal(cfg["patch_dim"])),
                  (("patch_proj", "b"), (d,), ("zeros",)),
                  (("pos_emb",), (cfg["num_patches"], d), ("normal", 0.02))]
    else:
        leaves = [(("embed", "table"), (cfg["vocab_size"], d),
                   ("normal", 0.02))]
    for i in range(cfg["num_layers"]):
        leaves += _prefix(("layers", i), _block(cfg, i in moe))
    leaves += _prefix(("final_norm",), _norm(cfg, d))
    if cfg["family"] == "vit":
        leaves += [(("head", "w"), (d, cfg["num_classes"]), _normal(d)),
                   (("head", "b"), (cfg["num_classes"],), ("zeros",))]
    elif not cfg["tie_embeddings"]:
        leaves += [(("unembed", "table"), (cfg["vocab_size"], d),
                    ("normal", 0.02))]
    return leaves


def numel(shape) -> int:
    return math.prod(shape)


def offsets(spec):
    """[(start, end)] of each leaf in the flat buffer, in table order."""
    out, at = [], 0
    for _, shape, _ in spec:
        out.append((at, at + numel(shape)))
        at += numel(shape)
    return out


def views(spec, flat):
    """[view of ``flat``] of each leaf, in table order."""
    return [flat[a:b].view(shape)
            for (_, shape, _), (a, b) in zip(spec, offsets(spec))]
