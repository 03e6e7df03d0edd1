"""Data of the port, counterpart of ``repro/data``."""
from .pipeline import SyntheticImages, SyntheticLM  # noqa: F401
