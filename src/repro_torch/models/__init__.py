"""Model zoo of the port: the decoder-only LM and the ViT."""
from .lm import lm_apply, lm_init, segment_plan  # noqa: F401
from .vit import vit_apply, vit_features, vit_init, vit_loss  # noqa: F401
