"""Meta-device stand-ins for every (arch × shape) cell, counterpart of
``repro/launch/specs.py``: shapes and dtypes with no storage, plus the
DTensor placements the dry-run (``launch/dryrun.py``) places them with.

Where the reference builds ``ShapeDtypeStruct`` trees and jits the
cell's program with ``NamedSharding`` in-shardings, the port builds
meta tensors (``torch.device("meta")``: shapes and dtypes, nothing
allocated) and places them as ``DTensor``s on the mesh, by the
placements of ``tree_shardings`` and ``state_shardings``. A cell's
``fn`` is the port's own program, run eagerly on those tensors: the
train step under the mesh (``jit_train_step``), the prefill and decode
programs, and the encoder-decoder's decode step.

The serving programs take plain tensors. Under a mesh a serving cell
runs them as the train step runs its model (``train/step.py``):
data-parallel, on this rank's rows of every input and cache leaf, with
the params gathered whole. The ``model`` axis is a storage axis there:
the weights and the cache shard over it by the rules, and each call
gathers them (``_data_parallel``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from ..configs import SHAPES, ShapeConfig
from ..distributed.api import axis_sizes, batch_over_model, placements
from ..distributed.sharding import (
    ShardingOptions,
    abstract_params,
    distribute_tree,
    map_with_path,
    tree_shardings,
)
from ..models import build_model, init_cache
from ..models.encdec import decode_step as ed_decode
from ..models.encdec import encode, init_encdec_cache
from ..optim import OptimizerConfig, tree_map
from ..serve.programs import make_decode_step, make_prefill_step
from ..train.step import (
    init_train_state,
    jit_train_step,
    make_train_step,
    state_shardings,
)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_axes(mesh):
    ba = (("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",))
    if batch_over_model():
        ba = ba + ("model",)
    return ba


def batch_specs(cfg, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    """Training batch stand-ins for one arch."""
    del mesh  # the reference's signature
    b, s = shape.global_batch, shape.seq_len
    out = {}
    if cfg.frontend.kind == "vision" and cfg.family == "vlm":
        # frontend stub embeds occupy part of the sequence budget
        n = cfg.frontend.num_embeds
        out["tokens"] = _meta((b, s - n), torch.int32)
        out["embeds"] = _meta((b, n, cfg.frontend.embed_dim), torch.bfloat16)
    elif cfg.encoder_layers > 0:
        out["tokens"] = _meta((b, s), torch.int32)
        out["embeds"] = _meta(
            (b, cfg.frontend.num_embeds, cfg.frontend.embed_dim),
            torch.bfloat16)
    else:
        out["tokens"] = _meta((b, s), torch.int32)
    return out


def _ba_for(mesh, dim: int):
    """Batch axes, dropped when the batch dim is not divisible (e.g. the
    long_500k shape has global_batch=1: replicate instead)."""
    ba = _batch_axes(mesh)
    sizes = axis_sizes(mesh)
    n = 1
    for a in ba:
        n *= sizes[a]
    return ba if dim % n == 0 else None


def _rows(mesh, leaf) -> tuple:
    """Placements of a leaf split over the batch axes by its first dim,
    replicated in every other (a scalar: replicated)."""
    if leaf.ndim == 0:
        return placements(mesh, ())
    return placements(mesh, (_ba_for(mesh, leaf.shape[0]),)
                      + (None,) * (leaf.ndim - 1))


def batch_shardings(mesh, batch):
    return map_with_path(lambda _, leaf: _rows(mesh, leaf), batch)


# ---------------------------------------------------------------------------
# cache shardings (serving cells)
# ---------------------------------------------------------------------------


def cache_shardings(mesh, cache, cfg):
    """KV caches: batch over (pod,data); kv-heads over model when divisible,
    else the sequence dim over model (context parallelism — the 72B decode
    cache at 32k × 128 batch does not fit per device otherwise)."""
    del cfg  # the reference's signature
    model_size = axis_sizes(mesh)["model"]

    def one(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name == "pos":
            return placements(mesh, (None,) * leaf.ndim)
        ba = _ba_for(mesh, leaf.shape[0])
        if leaf.ndim == 4 and name in ("k", "v"):
            b, s, g, hd = leaf.shape
            if g % model_size == 0:
                return placements(mesh, (ba, None, "model", None))
            if s % model_size == 0:
                return placements(mesh, (ba, "model", None, None))
            return placements(mesh, (ba, None, None, None))
        if name in ("ckv", "krope"):  # (b, s, r)
            b, s, r = leaf.shape
            if s % model_size == 0:
                return placements(mesh, (ba, "model", None))
            return placements(mesh, (ba, None, None))
        if name == "state":  # ssm (b, h, dh, n)
            h = leaf.shape[1]
            if h % model_size == 0:
                return placements(mesh, (ba, "model", None, None))
            return placements(mesh, (ba, None, None, None))
        if name == "conv":  # (b, w-1, C)
            return placements(mesh, (ba, None, None))
        return placements(mesh, (ba,) + (None,) * (leaf.ndim - 1))

    return map_with_path(one, cache)


# ---------------------------------------------------------------------------
# building a cell
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """Everything the dry-run needs to run one (arch × shape × mesh):
    ``fn(*args)`` on the placed meta args; ``in_shardings`` holds each
    argument's placements (the train batch stays a plain tensor, which
    the step cuts into this rank's rows itself). There is nothing to
    donate: the programs update the state and the cache in place."""

    name: str
    fn: Any
    args: tuple
    in_shardings: tuple


def _bf16_params(params):
    return tree_map(lambda x: (x.to(torch.bfloat16) if x.is_floating_point()
                               else x), params)


def _take_rows(mesh, t):
    """This rank's rows of a placed leaf as a plain tensor, whole in every
    other dim: the leaf is redistributed onto ``_rows`` placements (an
    all-gather where a non-batch dim shards over a mesh axis, a local
    slice where the batch dim was replicated)."""
    return t.redistribute(mesh, _rows(mesh, t)).to_local()


def _put_rows(mesh, t, local):
    """Write this rank's updated rows back into placed leaf ``t``."""
    new = DTensor.from_local(local, mesh, _rows(mesh, t), run_check=False,
                             shape=t.shape, stride=t.stride())
    t.to_local().copy_(new.redistribute(mesh, t.placements).to_local())


def _data_parallel(mesh, program):
    """``program(params, *inputs, cache)`` on plain tensors -> the same on
    placed ones: the params gathered whole (``full_tensor``), this rank's
    rows of every input and cache leaf, the updated rows written back
    into the placed cache. Outputs come back placed by rows."""

    def fn(params, *args):
        *inputs, cache = args
        params = tree_map(lambda t: t.full_tensor(), params)
        inputs = [_take_rows(mesh, x) for x in inputs]
        local = map_with_path(lambda _, t: _take_rows(mesh, t), cache)
        out = program(params, *inputs, local)
        map_with_path(lambda _, t, loc: _put_rows(mesh, t, loc), cache,
                      _existing(local, cache))
        outs = out if isinstance(out, tuple) else (out,)
        placed = tuple(DTensor.from_local(o, mesh, _rows(mesh, o),
                                          run_check=False) for o in outs)
        return placed + (cache,)

    return fn


def _existing(local, cache):
    """``local`` cut to the leaves of ``cache`` (the enc-dec decode step
    adds each layer's cross K/V to its cache; those stay on the rank)."""
    if isinstance(cache, dict):
        return {k: _existing(local[k], v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_existing(a, b) for a, b in zip(local, cache)]
    return local


def build_cell(cfg, shape_name: str, mesh,
               opts: ShardingOptions | None = None,
               microbatches: int = 1,
               use_kernel: bool = False,
               zero1: bool = False) -> Cell:
    """One (arch × shape) cell on ``mesh``, its args placed meta tensors.
    ``use_kernel`` raises: the kernels take CPU or CUDA tensors, and the
    cell's tensors live on the meta device."""
    if use_kernel:
        raise ValueError(
            "use_kernel: the port's kernels run on CUDA tensors (their plain "
            "versions on CPU ones); a dry-run cell's tensors are on the meta "
            "device, so it runs the einsum path only")
    shape = SHAPES[shape_name]
    opts = opts or ShardingOptions()
    init_fn, loss_fn, _ = build_model(cfg)
    name = f"{cfg.name}:{shape_name}"

    if shape.mode == "train":
        state = abstract_params(
            lambda g: init_train_state(g, init_fn, zero1=zero1))
        state_sh = state_shardings(mesh, state, opts)
        batch = batch_specs(cfg, shape, mesh)
        step = make_train_step(loss_fn, OptimizerConfig(),
                               microbatches=microbatches)
        return Cell(
            name=name,
            fn=jit_train_step(step, mesh, state_sh),
            args=(distribute_tree(mesh, state, state_sh), batch),
            in_shardings=(state_sh, batch_shardings(mesh, batch)),
        )

    # serving cells: bf16 params, no optimizer state. FSDP is a training
    # layout — at decode it would all-gather the full weights every
    # token; inference shards over `model` only and replicates over data.
    opts = dataclasses.replace(opts, fsdp=False)
    params = _bf16_params(abstract_params(init_fn))
    params_sh = tree_shardings(mesh, params, opts)
    b, s = shape.global_batch, shape.seq_len

    def cell(fn, args, shardings):
        placed = tuple(distribute_tree(mesh, a, sh)
                       for a, sh in zip(args, shardings))
        return Cell(name=name, fn=_data_parallel(mesh, fn), args=placed,
                    in_shardings=shardings)

    if cfg.encoder_layers > 0:
        cache = init_encdec_cache(cfg, b, s, device="meta")
        cache_sh = cache_shardings(mesh, cache, cfg)
        if shape.mode == "prefill":
            # prefill = encode(frames) + decoder prefill, one step
            toks = _meta((b, s), torch.int32)
            frames = _meta(
                (b, cfg.frontend.num_embeds, cfg.frontend.embed_dim),
                torch.bfloat16)

            def prefill(params, tokens, frames, cache):
                enc_out, _ = encode(params, cfg, frames)
                logits, _, _ = ed_decode(
                    params, cfg, tokens, enc_out,
                    positions=torch.arange(s, device=tokens.device),
                    cache=cache, mode="prefill", last_only=True)
                return logits, enc_out

            return cell(prefill, (params, toks, frames, cache),
                        (params_sh, _rows(mesh, toks), _rows(mesh, frames),
                         cache_sh))
        toks = _meta((b, 1), torch.int32)
        pos = _meta((), torch.int32)
        enc_out = _meta((b, cfg.frontend.num_embeds, cfg.d_model),
                        torch.bfloat16)

        def decode(params, tokens, pos, enc_out, cache):
            logits, _, _ = ed_decode(params, cfg, tokens, enc_out,
                                     positions=pos[None], cache=cache,
                                     mode="decode")
            return logits

        return cell(decode, (params, toks, pos, enc_out, cache),
                    (params_sh, _rows(mesh, toks), _rows(mesh, pos),
                     _rows(mesh, enc_out), cache_sh))

    cache = init_cache(cfg, b, s, device="meta")
    cache_sh = cache_shardings(mesh, cache, cfg)
    if shape.mode == "prefill":
        toks = _meta((b, s), torch.int32)
        return cell(make_prefill_step(cfg, s), (params, toks, cache),
                    (params_sh, _rows(mesh, toks), cache_sh))
    # decode: per-row positions (continuous batching — rows at independent
    # offsets; pos<0 rows are inactive no-ops)
    toks = _meta((b, 1), torch.int32)
    pos = _meta((b,), torch.int32)
    return cell(make_decode_step(cfg), (params, toks, pos, cache),
                (params_sh, _rows(mesh, toks), placements(mesh, (None,)),
                 cache_sh))
