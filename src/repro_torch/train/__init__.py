"""Training of the port, counterpart of ``repro/train``: the train step and
the fault-tolerant trainer (one device; no sharded step yet)."""
from .step import init_train_state, make_train_step  # noqa: F401
from .trainer import StragglerWatchdog, Trainer, TrainerConfig  # noqa: F401
