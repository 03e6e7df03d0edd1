"""Model zoo of the port: the decoder-only LM so far."""
from .lm import lm_apply, lm_init, segment_plan  # noqa: F401
