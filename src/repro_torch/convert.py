"""Convert the JAX package's LM and ViT parameters into the port's layout.

The JAX ``lm_init`` returns ``{"embed", "segments", "final_norm"[,
"unembed"]}`` and ``vit_init`` returns ``{"patch_proj", "pos_emb",
"segments", "final_norm", "head"}``, where ``segments[i]`` stacks the
layers of one homogeneous run on a leading ``count`` axis (e.g.
``segments[0]["attn"]["wq"]`` is (L, d, H, Dk), and a Soft-MoE segment's
``["moe"]["phi"]`` is (L, d, n, p)). The port keeps one dict per layer
under ``"layers"``; every other entry is carried as it is. This module
takes that pytree with numpy leaves (the caller maps ``np.asarray`` over
it), so it needs neither jax nor the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .layers.common import resolve_device
from .models.lm import segment_plan


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree, cfg, device="cuda"):
    """JAX LM or ViT param pytree (numpy leaves) -> the port's params on
    ``device`` (the card unless the caller passes ``"cpu"``), dtypes kept
    as given."""
    device = resolve_device(device)
    segs = segment_plan(cfg)
    if len(tree["segments"]) != len(segs):
        raise ValueError(f"{len(tree['segments'])} segments in the tree, "
                         f"{len(segs)} in the config's plan")
    layers = [None] * cfg.num_layers
    for seg, (start, count, _) in zip(tree["segments"], segs):
        for j in range(count):
            layers[start + j] = _map(seg, lambda a, j=j: _tensor(a[j], device))
    out = {k: _map(v, lambda a: _tensor(a, device))
           for k, v in tree.items() if k != "segments"}
    out["layers"] = layers
    return out
