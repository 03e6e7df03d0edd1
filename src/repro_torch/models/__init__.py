"""Model zoo of the port: the decoder-only LM and the ViT, plus a uniform
``build_model(cfg)`` entry point returning (init, loss, apply) fns
(counterpart of ``repro/models/__init__.py``)."""
from __future__ import annotations

from .lm import lm_apply, lm_init, segment_plan  # noqa: F401
from .vit import vit_apply, vit_features, vit_init, vit_loss  # noqa: F401


def build_model(cfg):
    """Returns ``(init_fn(generator), loss_fn(params, batch), apply_fn)``.
    Only the ViT is ported with a loss; the LM's and the encoder-decoder's
    losses raise."""
    if cfg.family == "vit":
        return (
            lambda gen: vit_init(gen, cfg),
            lambda p, b: vit_loss(p, cfg, b),
            lambda p, b, **kw: vit_apply(p, cfg, b["patches"], **kw),
        )
    kind = "encoder-decoder" if cfg.encoder_layers > 0 else "LM"
    raise NotImplementedError(
        f"build_model for the {kind} family ({cfg.name}) is not ported yet: "
        f"only the ViT has a loss in the port")
