"""The one generator of every traffic mix: a ring of distinct batches.

A traffic file holds parameters only: ``mode`` (train or infer),
``batch``, ``ring`` (distinct batches, cycled through), ``seq_len`` for
tokens, and the step's settings (``optimizer``, ``telemetry``,
``checked_steps``, ``trace_steps``). Every batch is made on the device
from the seed, in set-up, so nothing is generated inside the window, and
every seed gives the same sizes.

The two streams copy the port's ``data/pipeline.py`` (``SyntheticImages``,
``SyntheticLM``), except that the label readout and the Markov table are
drawn on the device from the seed, and all ring rows of the token stream
advance together (one launch a position, not one a position a batch):
- images: N(0, 1) patches; the label of an image is the argmax of a fixed
  random linear readout of its mean patch;
- tokens: an order-1 Markov stream, each state with ``branching``
  successors drawn from a table over the first min(vocab, 4096) ids.
"""
from __future__ import annotations

import torch

from .weights import mix


def make_ring(cfg: dict, traffic: dict, seed: int, device):
    """[batch dict] * ring: {"patches", "labels"} or {"tokens"}."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, 2))
    ring, b = traffic["ring"], traffic["batch"]
    if cfg["family"] == "vit":
        m, pd = cfg["num_patches"], cfg["patch_dim"]
        readout = torch.randn((pd, cfg["num_classes"]), generator=gen,
                              device=device)
        out = []
        for _ in range(ring):
            patches = torch.randn((b, m, pd), generator=gen, device=device)
            batch = {"patches": patches}
            if traffic["mode"] == "train":
                batch["labels"] = (patches.mean(dim=1) @ readout).argmax(
                    dim=-1).to(torch.int32)
            out.append(batch)
        return out
    v = min(cfg["vocab_size"], 4096)
    branching = traffic.get("branching", 4)
    table = torch.randint(0, v, (v, branching), generator=gen, device=device)
    rows, s = ring * b, traffic["seq_len"]
    state = torch.randint(0, v, (rows,), generator=gen, device=device)
    choices = torch.randint(0, branching, (rows, s), generator=gen,
                            device=device)
    tokens = torch.empty((rows, s), dtype=torch.int32, device=device)
    for t in range(s):
        state = table[state, choices[:, t]]
        tokens[:, t] = state
    return [{"tokens": tokens[i * b:(i + 1) * b]} for i in range(ring)]
