"""Seeded weights in one flat f32 buffer, made on the device.

The buffer is filled with standard normals in chunks of ``CHUNK``
elements, each from a ``torch.Generator`` on the device seeded from
(seed, chunk), then scaled (or set to 0 or 1) leaf by leaf as the
parameter table says. Any chunk can be made again on its own, so the
weights a run started from are known without a second copy of them.
"""
from __future__ import annotations

import torch

from .reference.spec import offsets

CHUNK = 1 << 27  # 512 MiB of f32


def mix(seed: int, *salt: int) -> int:
    """A 63-bit generator seed from the run's seed and a salt."""
    h = seed % (1 << 64)
    for s in salt:
        h = (h * 6364136223846793005 + 1442695040888963407 + s) % (1 << 64)
    return h >> 1


def _fill_chunk(spec, out, seed: int, c: int, device):
    """The weights of flat positions [c*CHUNK, c*CHUNK + len(out)) into
    ``out``."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, 1, c))
    out.normal_(generator=gen)
    lo, hi = c * CHUNK, c * CHUNK + out.numel()
    for (_, _, init), (a, b) in zip(spec, offsets(spec)):
        if b <= lo or a >= hi:
            continue
        part = out[max(a, lo) - lo:min(b, hi) - lo]
        if init[0] == "normal":
            part.mul_(init[1])
        elif init[0] == "zeros":
            part.zero_()
        else:
            part.fill_(1.0)


def make(spec, seed: int, device) -> torch.Tensor:
    """The flat f32 buffer of every leaf of ``spec``."""
    total = offsets(spec)[-1][1]
    flat = torch.empty(total, dtype=torch.float32, device=device)
    for c in range(-(-total // CHUNK)):
        _fill_chunk(spec, flat[c * CHUNK:(c + 1) * CHUNK], seed, c, device)
    return flat


def leaf_norms(spec, flat) -> torch.Tensor:
    """Per-leaf L2 norms of a flat buffer, (leaves,) f32."""
    return torch.stack([flat[a:b].norm() for a, b in offsets(spec)])


def change_norms(spec, flat, seed: int) -> torch.Tensor:
    """Per-leaf L2 norms of ``flat`` minus the seed's initial weights,
    (leaves,) f32; the initial weights are made again chunk by chunk."""
    sums = torch.zeros(len(spec), dtype=torch.float32, device=flat.device)
    offs = offsets(spec)
    init = torch.empty(min(CHUNK, flat.numel()), dtype=torch.float32,
                       device=flat.device)
    for c in range(-(-flat.numel() // CHUNK)):
        lo = c * CHUNK
        cur = flat[lo:lo + CHUNK]
        buf = init[:cur.numel()]
        _fill_chunk(spec, buf, seed, c, flat.device)
        buf.sub_(cur).square_()
        hi = lo + cur.numel()
        for i, (a, b) in enumerate(offs):
            if b > lo and a < hi:
                sums[i] += buf[max(a, lo) - lo:min(b, hi) - lo].sum()
    return sums.sqrt()
