"""Data of the port, counterpart of ``repro/data``."""
from .pipeline import SyntheticImages  # noqa: F401
