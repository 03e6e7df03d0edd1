"""Faults planted in the program underneath a whole run, to show that the
comparison catches them (``calibrate.py`` reads them on the card, the
CPU tests see ``correct`` come out false). Each is a context manager that
patches one function of the program and restores it."""
from __future__ import annotations

import contextlib
import importlib


@contextlib.contextmanager
def patched(module: str, attr: str, make):
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def unchanged_state():
    """The step returns its state unchanged: AdamW moves nothing."""

    def make(_orig):
        def adamw_update(grads, opt_state, params, cfg, lr=None):
            return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                            "step": opt_state["step"] + 1}, {}
        return adamw_update

    return patched("repro_torch.train.step", "adamw_update", make)


def half_batch(family: str):
    """The loss leaves out the second half of the batch and takes the mean
    over the rest."""
    module, attr = (("repro_torch.models.vit", "vit_loss") if family == "vit"
                    else ("repro_torch.models.lm", "lm_loss"))

    def make(orig):
        def loss(params, cfg, batch, *args, **kwargs):
            half = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
            return orig(params, cfg, half, *args, **kwargs)
        return loss

    return patched(module, attr, make)


def half_rows():
    """Inference computes the first half of the batch only and answers the
    second half with a copy of it."""

    def make(orig):
        def vit_apply(params, cfg, patches, *args, **kwargs):
            half = patches.shape[0] // 2
            logits, aux = orig(params, cfg, patches[:half], *args, **kwargs)
            return logits.repeat(2, 1)[:patches.shape[0]], aux
        return vit_apply

    return patched("repro_torch.models.vit", "vit_apply", make)


def altered_answer():
    """One row of every batch answers with its logits shifted by a class."""

    def make(orig):
        def vit_apply(params, cfg, patches, *args, **kwargs):
            logits, aux = orig(params, cfg, patches, *args, **kwargs)
            logits = logits.clone()
            logits[0] = logits[0].roll(1)
            return logits, aux
        return vit_apply

    return patched("repro_torch.models.vit", "vit_apply", make)


def for_mode(mode: str, family: str):
    """{fault name: context manager factory} a cell of ``mode`` can have."""
    if mode == "train":
        return {"unchanged_state": unchanged_state,
                "half_batch": lambda: half_batch(family)}
    return {"half_rows": half_rows, "altered_answer": altered_answer}
