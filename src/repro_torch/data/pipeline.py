"""Deterministic synthetic image stream, counterpart of
``repro/data/pipeline.py::SyntheticImages`` (the LM and seq2seq streams
are not ported).

Random patch fields whose label is a fixed random linear readout of the
mean patch: linearly separable, so accuracy rises fast. ``batch(step)``
is a pure function of (seed, step, host), so a restarted job resumes the
stream exactly and the pipeline needs no checkpoint state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..layers.common import resolve_device


@dataclass
class SyntheticImages:
    """The patches come from a ``torch.Generator`` on ``device`` (the card
    unless the caller passes ``"cpu"``), seeded with the JAX stream's
    formula ``(seed * 999_983 + step) * 131 + host_id``; its bits cannot
    match ``jax.random``'s, so the port's patches differ from the JAX
    package's. The readout is drawn by ``np.random.default_rng(seed)`` as
    in JAX, so the labels follow the same rule: given the same patches,
    both packages give the same labels."""

    num_patches: int
    patch_dim: int
    batch_size: int
    num_classes: int = 1000
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        readout = rng.standard_normal((self.patch_dim, self.num_classes))
        self._readout = torch.from_numpy(readout).to(self._device)

    def batch(self, step: int):
        per_host = self.batch_size // self.num_hosts
        gen = torch.Generator(device=self._device).manual_seed(
            (self.seed * 999_983 + step) * 131 + self.host_id)
        patches = torch.randn((per_host, self.num_patches, self.patch_dim),
                              generator=gen, device=self._device)
        feats = patches.mean(dim=1)
        labels = (feats @ self._readout.to(feats.dtype)).argmax(dim=-1)
        return {"patches": patches, "labels": labels.to(torch.int32)}
