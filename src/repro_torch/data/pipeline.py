"""Deterministic synthetic streams, counterpart of
``repro/data/pipeline.py``.

  * SyntheticLM: an order-1 Markov token stream (a random table of
    ``branching`` successors per state), so cross-entropy has a clear floor
    below ln(V).
  * SyntheticImages: random patch fields whose label is a fixed random
    linear readout of the mean patch: linearly separable, so accuracy
    rises fast.
  * SyntheticSeq2Seq: frame embeddings and a uniform token stream, the
    seamless-style stub.

``batch(step)`` is a pure function of (seed, step, host), so a restarted
job resumes the stream exactly and the pipeline needs no checkpoint
state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..layers.common import resolve_device


@dataclass
class SyntheticLM:
    """The transition table is drawn by ``np.random.default_rng(seed)`` as
    in JAX, so it is the JAX stream's table. The start states and the
    successor choices come from a ``torch.Generator`` on ``device`` (the
    card unless the caller passes ``"cpu"``), seeded with the JAX formula
    ``(seed * 1_000_003 + step) * 131 + host_id``; its bits cannot match
    ``jax.random``'s, so the port's tokens differ from the JAX package's,
    but every transition follows the same table."""

    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    branching: int = 4  # tokens reachable from each state
    host_id: int = 0
    num_hosts: int = 1
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)
        rng = np.random.default_rng(self.seed)
        v = min(self.vocab_size, 4096)  # transition table cap
        self._v = v
        self._next = rng.integers(0, v, size=(v, self.branching))
        self._table = torch.from_numpy(self._next).to(self._device)

    def batch(self, step: int):
        per_host = self.batch_size // self.num_hosts
        gen = torch.Generator(device=self._device).manual_seed(
            (self.seed * 1_000_003 + step) * 131 + self.host_id)
        state = torch.randint(0, self._v, (per_host,), generator=gen,
                              device=self._device)
        choices = torch.randint(0, self.branching, (per_host, self.seq_len),
                                generator=gen, device=self._device)
        tokens = []
        for t in range(self.seq_len):  # token t = table[token t-1, choice]
            state = self._table[state, choices[:, t]]
            tokens.append(state)
        return {"tokens": torch.stack(tokens, dim=1).to(torch.int32)}


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


@dataclass
class SyntheticSeq2Seq:
    """Frame embeddings -> token stream (the seamless-style stub). The
    frames (N(0, 1)) and the tokens (uniform over the vocabulary) come from
    a ``torch.Generator`` on ``device`` (the card unless the caller passes
    ``"cpu"``), seeded with the JAX stream's formula ``(seed * 7_368_787 +
    step) * 131 + host_id``; its bits cannot match ``jax.random``'s, so
    the values differ from the JAX package's, but the fields, shapes,
    dtypes and ranges are the same."""

    vocab_size: int
    seq_len: int
    num_frames: int
    frame_dim: int
    batch_size: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    device: str = "cuda"

    def __post_init__(self):
        self._device = resolve_device(self.device)

    def batch(self, step: int):
        per_host = self.batch_size // self.num_hosts
        gen = torch.Generator(device=self._device).manual_seed(
            (self.seed * 7_368_787 + step) * 131 + self.host_id)
        frames = torch.randn((per_host, self.num_frames, self.frame_dim),
                             generator=gen, device=self._device)
        tokens = torch.randint(0, self.vocab_size, (per_host, self.seq_len),
                               generator=gen, device=self._device)
        return {"tokens": tokens.to(torch.int32), "embeds": frames}
