"""Model zoo of the port: the decoder-only LM and the ViT, plus a uniform
``build_model(cfg)`` entry point returning (init, loss, apply) fns
(counterpart of ``repro/models/__init__.py``). The encoder-decoder family
is not ported: ``build_model`` raises for it."""
from __future__ import annotations

from .lm import lm_apply, lm_init, lm_loss, segment_plan  # noqa: F401
from .vit import vit_apply, vit_features, vit_init, vit_loss  # noqa: F401


def build_model(cfg):
    """Returns ``(init_fn(generator), loss_fn(params, batch), apply_fn)``
    for the ViT and the decoder-only LM, as the JAX function (which passes
    neither ``use_kernel`` nor ``telemetry`` to the losses). The
    encoder-decoder family raises."""
    if cfg.family == "vit":
        return (
            lambda gen: vit_init(gen, cfg),
            lambda p, b: vit_loss(p, cfg, b),
            lambda p, b, **kw: vit_apply(p, cfg, b["patches"], **kw),
        )
    if cfg.encoder_layers > 0:
        raise NotImplementedError(
            f"build_model for the encoder-decoder family ({cfg.name}) is not "
            f"ported yet")
    return (
        lambda gen: lm_init(gen, cfg),
        lambda p, b: lm_loss(p, cfg, b),
        lambda p, b, **kw: lm_apply(p, cfg, b["tokens"],
                                    embeds=b.get("embeds"), **kw),
    )
