"""Training of the port, counterpart of ``repro/train``: the train step
(one device, or a mesh of ``torch.distributed`` ranks) and the
fault-tolerant trainer."""
from .step import (  # noqa: F401
    init_train_state,
    jit_train_step,
    make_train_step,
    state_shardings,
)
from .trainer import StragglerWatchdog, Trainer, TrainerConfig  # noqa: F401
