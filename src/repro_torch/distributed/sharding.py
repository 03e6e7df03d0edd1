"""Parameter sharding rules: param-path pattern -> logical spec,
counterpart of ``repro/distributed/sharding.py``.

Layout (MaxText-style hybrid):
  * `model` axis — tensor parallelism (attention heads, MLP hidden, vocab)
    and expert parallelism (expert axis of MoE/Soft-MoE stacks, slot axis
    of Phi).
  * `data` axis — data parallelism over the batch, plus FSDP: parameters
    and optimizer moments are additionally sharded over `data` on a
    replicated axis.
  * `pod` axis — pure data parallelism across pods; only gradient
    reduces cross the inter-pod links.

``ShardingOptions``, ``RULES``, ``_stacked`` and ``logical_spec_for`` are
the reference's, verbatim. Rules are regex patterns over the flattened
param path. The reference stacks the layers of a segment under
``segments``/``enc_segments`` and prepends a never-sharded layer axis to
their specs; the port keeps one dict per layer under
``layers``/``enc_layers``, whose paths the same suffix rules match, so a
port layer's spec is the reference's spec of its segment without the
layer axis (the FSDP size test reads the per-layer shape in both).

Where the reference returns a ``NamedSharding`` per leaf,
``tree_shardings`` returns the leaf's ``DTensor`` placements on the
mesh: one ``Shard(dim)`` or ``Replicate()`` per mesh dimension.
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from .api import axis_sizes, logical_to_physical, phys_size, placements


@dataclass(frozen=True)
class ShardingOptions:
    fsdp: bool = True  # shard params/opt-state over `data` too
    expert_parallel: bool = True  # experts over `model`
    tensor_parallel: bool = True  # heads/ffn over `model`
    # Minimum param size (elements) to bother FSDP-sharding.
    fsdp_min_size: int = 2**16


# (pattern, logical spec) — first match wins. "F" marks the axis that FSDP
# additionally shards with `data` (must currently be None or get data axis).
RULES: Tuple[Tuple[str, Tuple], ...] = (
    # embeddings / unembedding: vocab over model, d over data (fsdp)
    (r"(embed|unembed)/table$", ("model", "F")),
    # attention (GQA + MLA q/out)
    (r"attn/wq$", ("F", "model", None)),
    (r"attn/w[kv]$", ("F", "model", None)),
    (r"attn/wo$", ("model", None, "F")),
    (r"attn/b[qkv]$", ("model", None)),
    (r"attn/w_dkv$", ("F", None)),
    (r"attn/w_krope$", ("F", None)),
    (r"attn/w_u[kv]$", ("F", "model", None)),
    (r"cross/wq$", ("F", "model", None)),
    (r"cross/w[kv]$", ("F", "model", None)),
    (r"cross/wo$", ("model", None, "F")),
    # dense MLP: ffn over model
    (r"mlp/w_(gate|up)$", ("F", "model")),
    (r"mlp/w_down$", ("model", "F")),
    # MoE experts: expert axis over model (expert parallelism)
    (r"(moe|mlp)/experts/w_(gate|up)$", ("model", "F", None)),
    (r"(moe|mlp)/experts/w_down$", ("model", "F", None)),
    # shared (always-on) experts: shard their ffn over model instead
    (r"moe/shared/w_(gate|up)$", (None, "F", "model")),
    (r"moe/shared/w_down$", (None, "model", "F")),
    # Soft MoE slot parameters: slots (expert axis) over model
    (r"moe/phi$", ("F", "model", None)),
    (r"moe/scale$", ()),
    (r"moe/router$", ("F", None)),
    # SSM: d_inner (head-aligned) over model
    (r"ssm/w_[zx]$", ("F", "model")),
    (r"ssm/w_[BC]$", ("F", None)),
    (r"ssm/w_dt$", ("F", None)),
    (r"ssm/conv_[wb]$", None),  # packed channel axis: replicate (tiny)
    (r"ssm/(A_log|D|dt_bias)$", None),
    (r"ssm/norm_scale$", ("model",)),
    (r"ssm/w_out$", ("model", "F")),
    # norms / scalars / frontend / vit head
    (r"norm", None),
    (r"frontend/w$", ("F", None)),
    (r"patch_proj/(w|b)$", None),
    (r"pos_emb$", None),
    (r"head/w$", ("F", "model")),
    (r"head/b$", None),
)


def _stacked(path_s: str) -> bool:
    return path_s.startswith(("segments/", "enc_segments/"))


_EXPERT_PAT = re.compile(r"experts/|/phi$|shared/")


def logical_spec_for(path_s: str, ndim: int, shape,
                     opts: ShardingOptions) -> Tuple:
    is_expert = bool(_EXPERT_PAT.search(path_s))
    for pat, spec in RULES:
        if re.search(pat, path_s):
            if spec is None:
                spec = ()
            spec = tuple(spec) + (None,) * (ndim - len(spec))
            out = []
            for ax, name in enumerate(spec[:ndim]):
                if name == "F":
                    name = (
                        "data"
                        if opts.fsdp
                        and _size(shape) >= opts.fsdp_min_size
                        else None
                    )
                if name == "model":
                    enabled = (
                        opts.expert_parallel
                        if is_expert
                        else opts.tensor_parallel
                    )
                    if not enabled:
                        name = None
                out.append(name)
            return tuple(out)
    return (None,) * ndim  # default: replicate


def _size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def map_with_path(fn, tree, *rest, path=""):
    """``fn(path, leaf, *rest_leaves)`` over a tree of dicts and lists,
    keeping its structure; ``path`` joins keys and list indices with
    ``/`` (``layers/3/attn/wq``)."""
    def sub(k):
        return f"{path}/{k}" if path else str(k)

    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, *(r[k] for r in rest), path=sub(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_path(fn, v, *(r[i] for r in rest), path=sub(i))
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def param_specs(params, opts: Optional[ShardingOptions] = None):
    """Tree of logical specs (tuples of logical axis names) for params."""
    opts = opts or ShardingOptions()

    def one(ps, leaf):
        ndim = leaf.ndim
        if _stacked(ps):
            inner = logical_spec_for(ps, ndim - 1, leaf.shape[1:], opts)
            return (None,) + inner
        return logical_spec_for(ps, ndim, leaf.shape, opts)

    return map_with_path(one, params)


def tree_shardings(mesh, params, opts: Optional[ShardingOptions] = None):
    """Tree of DTensor placements, honoring divisibility: any axis whose
    dim is not divisible by its mesh-axis size falls back to replicated
    on that axis (correctness over maximal sharding — e.g. 25 heads on
    16-way model parallelism for hymba)."""
    specs = param_specs(params, opts)
    sizes = axis_sizes(mesh)

    def one(_, leaf, logical):
        fixed = []
        for ax, name in enumerate(logical):
            phys = logical_to_physical(mesh, name)
            if phys is None:  # no axis, or disabled (TP in pure-DP mode)
                fixed.append(None)
                continue
            fixed.append(phys if leaf.shape[ax] % phys_size(sizes, phys) == 0
                         else None)
        return placements(mesh, fixed)

    return map_with_path(one, params, specs)


def batch_sharding(mesh, ndim: int) -> tuple:
    """Inputs: batch over (pod, data); everything else replicated."""
    batch_axes = ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"
    return placements(mesh, (batch_axes,) + (None,) * (ndim - 1))


def distribute_tree(mesh, tree, shardings):
    """Each leaf of ``tree`` onto its placements in ``shardings`` on
    ``mesh``: a plain tensor (the whole array, the same on every rank) is
    cut into this rank's shard without communication; a DTensor is
    redistributed when its placements differ."""
    def one(_, t, pl):
        pl = tuple(pl)
        if isinstance(t, DTensor):
            return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
        return distribute_tensor(t, mesh, pl, src_data_rank=None)

    return map_with_path(one, tree, shardings)


class _MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: the initialisers make
    their tensors on the generator's device, so they allocate nothing."""

    @property
    def device(self):
        return torch.device("meta")


def abstract_params(init_fn, gen=None):
    """Shape/dtype tree of params without allocating (for dry-runs):
    ``init_fn`` runs on ``torch.device("meta")``. ``gen`` is accepted for
    the reference's signature; meta tensors hold no values."""
    del gen
    return init_fn(_MetaGenerator())

