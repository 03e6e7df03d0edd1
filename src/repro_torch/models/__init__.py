"""Model zoo of the port: the decoder-only LM, the encoder-decoder and
the ViT, plus a uniform ``build_model(cfg)`` entry point returning
(init, loss, apply) fns (counterpart of ``repro/models/__init__.py``)."""
from __future__ import annotations

from .encdec import (  # noqa: F401
    encdec_apply,
    encdec_init,
    encdec_loss,
    init_encdec_cache,
)
from .lm import init_cache, lm_apply, lm_init, lm_loss, segment_plan  # noqa: F401
from .vit import vit_apply, vit_features, vit_init, vit_loss  # noqa: F401


def build_model(cfg):
    """Returns ``(init_fn(generator), loss_fn(params, batch), apply_fn)``
    for the ViT, the encoder-decoder and the decoder-only LM, as the JAX
    function (which passes neither ``use_kernel`` nor ``telemetry`` to
    the losses)."""
    if cfg.family == "vit":
        return (
            lambda gen: vit_init(gen, cfg),
            lambda p, b: vit_loss(p, cfg, b),
            lambda p, b, **kw: vit_apply(p, cfg, b["patches"], **kw),
        )
    if cfg.encoder_layers > 0:
        return (
            lambda gen: encdec_init(gen, cfg),
            lambda p, b: encdec_loss(p, cfg, b),
            lambda p, b, **kw: encdec_apply(p, cfg, b["tokens"],
                                            b.get("embeds"), **kw),
        )
    return (
        lambda gen: lm_init(gen, cfg),
        lambda p, b: lm_loss(p, cfg, b),
        lambda p, b, **kw: lm_apply(p, cfg, b["tokens"],
                                    embeds=b.get("embeds"), **kw),
    )
