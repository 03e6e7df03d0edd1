"""Data of the port, counterpart of ``repro/data``."""
from .pipeline import SyntheticImages, SyntheticLM, SyntheticSeq2Seq  # noqa: F401
