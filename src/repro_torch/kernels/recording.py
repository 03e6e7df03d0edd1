"""Kernel calls as single ops for the op recorder of ``analysis/``.

The contract linter (``repro_torch.analysis``) runs a program once under
a ``TorchDispatchMode`` and checks the shapes of every aten op it saw.
A kernel launch through ctypes is invisible to the dispatcher, so on the
card a kernel wrapper shows only its own allocations. On the CPU the
same wrapper runs its plain version, which forms exactly the tiles the
kernel keeps on chip (the (m, S) logits tile of a Soft-MoE row, the
(B, keys) gather of a paged split). ``kernel_op`` makes the two agree:
while a recorder is active, a decorated wrapper's call is recorded as one
op with the wrapper's tensor inputs and outputs; a CPU call runs its
plain body with the recorder paused, and a card call records its
allocations as the kernel's own (``within``). With no recorder active
the decorator calls the wrapper and nothing else, so results are
bitwise those of the undecorated wrapper.
"""
from __future__ import annotations

import functools
from typing import List

# active recorders, innermost last; each has ``kernel_call(name, fn,
# args, kwargs)``
ACTIVE: List[object] = []


def kernel_op(name: str):
    """Decorate the wrapper of kernel ``name``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not ACTIVE:
                return fn(*args, **kwargs)
            return ACTIVE[-1].kernel_call(name, fn, args, kwargs)

        return wrapper

    return deco
