"""The device programs the serving backends run, counterpart of
``repro/serve/programs.py``: the contiguous (slot-row) programs over
``init_cache``'s rings and the paged programs over the block pools.

The JAX package jits each program once with one fixed signature and
donates the cache. Here they are plain eager functions that update the
per-layer caches in place; CUDA graphs of them are a later change. Every
program runs ``lm_apply`` in a serving mode. The speculative-decoding
programs are a (B, k+1) decode continuation with logits at every lane
(verify) and the scrub of rejected lanes (rollback), on both layouts.
"""
from __future__ import annotations

import torch

from ..layers.attention import (
    copy_kv_blocks,
    invalidate_kv_positions,
    invalidate_paged_positions,
    reset_block_pos,
)
from ..layers.ssm import reset_ssm_rows
from ..models import lm_apply
from .cache_pool import pool_row


# ---------------------------------------------------------------------------
# contiguous (slot-row) programs
# ---------------------------------------------------------------------------


def make_prefill_step(cfg, max_len: int):
    """Whole-prompt prefill: (params, tokens(B,S), cache) -> logits(B,1,V)
    at the last position, positions ``arange(S)`` shared by every row.
    ``max_len`` is taken for signature parity with the reference."""
    del max_len

    def prefill(params, tokens, cache):
        s = tokens.shape[1]
        return lm_apply(params, cfg, tokens,
                        positions=torch.arange(s, device=tokens.device),
                        cache=cache, mode="prefill", last_only=True)[0]

    return prefill


def make_decode_step(cfg, telemetry: bool = False):
    """(params, tokens(B,1), pos(B,), cache) -> logits(B,1,V), or (logits,
    telem) with ``telemetry``. Per-row positions; rows with pos < 0 are
    inactive and leave their ring and SSM rows as they are."""

    def decode(params, tokens, pos, cache):
        out = lm_apply(params, cfg, tokens, positions=pos[:, None],
                       cache=cache, mode="decode", telemetry=telemetry)
        return (out[0], out[3]) if telemetry else out[0]

    return decode


def make_prefill_chunk_step(cfg, telemetry: bool = False):
    """Chunked prefill into one pool slot: (params, cache, logits_buf,
    slot, tokens(1,C), positions(1,C)) -> logits_buf with row ``slot``
    set to the chunk's last-position logits, or (logits_buf, telem).
    ``mode="decode"`` with S > 1 makes attention read earlier chunks back
    from the ring (and the SSM continue from its state), so chunks
    compose exactly; left-pad tokens carry position -1 and write
    nothing. The model runs on the slot's row view, so its writes land
    in the pool."""

    def prefill_chunk(params, cache, buf, slot, tokens, positions):
        out = lm_apply(params, cfg, tokens, positions=positions,
                       cache=pool_row(cache, slot), mode="decode",
                       last_only=True, telemetry=telemetry)
        buf[slot] = out[0][0, -1].to(buf.dtype)
        return (buf, out[3]) if telemetry else buf

    return prefill_chunk


def make_verify_step(cfg, telemetry: bool = False):
    """Speculative-decoding verify over the contiguous pool: (params,
    tokens(B,S), pos(B,S), cache) -> logits(B,S,V), or (logits, telem).
    A multi-token decode continuation (this call's K/V is written first,
    each lane attends everything causally at or before it) with logits
    at EVERY lane: lane j's logits score the token after lane j. Lanes
    with pos < 0 (inactive rows, unused draft lanes) write nothing."""

    def verify(params, tokens, pos, cache):
        out = lm_apply(params, cfg, tokens, positions=pos, cache=cache,
                       mode="decode", telemetry=telemetry)
        return (out[0], out[3]) if telemetry else out[0]

    return verify


def invalidate_positions_program(cache, positions):
    """Speculative rollback on the contiguous pool: pos -> -1 for a (B, W)
    batch of absolute positions in every attention layer (lanes below 0
    drop), leaving the cache equal to never having written the rejected
    draft lanes."""
    for layer in cache:
        if "attn" in layer:
            invalidate_kv_positions(layer["attn"], positions)
    return cache


# ---------------------------------------------------------------------------
# paged (block-pool) programs
# ---------------------------------------------------------------------------


def _slot_view(cache, slot: int):
    """Batch-1 view of one slot: attention block pools pass whole (rows
    address them through the table), SSM leaves narrow to the slot's row,
    so the in-place SSM update writes that row only."""
    return [{k: ({n: t[slot:slot + 1] for n, t in v.items()}
                 if k == "ssm" else v) for k, v in layer.items()}
            for layer in cache]


def make_prefill_chunk_paged(cfg, telemetry: bool = False):
    """Chunked prefill through a block table: (params, cache, logits_buf,
    slot, table(1,nb), tokens(1,C), positions(1,C)) -> logits_buf, with
    row ``slot`` of the buffer set to the chunk's last-position logits,
    or (logits_buf, telem) with ``telemetry``: ``lm_apply``'s telemetry
    tree of the call. Attention writes scatter into the slot's table
    blocks; SSM layers read and write the slot's row."""

    def prefill_chunk(params, cache, buf, slot, table, tokens, positions):
        out = lm_apply(
            params, cfg, tokens, positions=positions,
            cache=_slot_view(cache, slot),
            mode="decode", last_only=True, block_tables=table,
            telemetry=telemetry,
        )
        buf[slot] = out[0][0, -1].to(buf.dtype)
        return (buf, out[3]) if telemetry else buf

    return prefill_chunk


def make_decode_step_paged(cfg, use_kernel: bool = False,
                           telemetry: bool = False):
    """(params, tokens(B,1), pos(B,), tables(B,nb), cache) ->
    logits(B,1,V), or (logits, telem) with ``telemetry``. Rows with
    pos<0 are inactive; their (all-null) table rows contribute only
    masked-out keys, and their SSM rows stay bitwise as they are.
    ``use_kernel`` routes attention through the paged
    decode-attention kernel, which reads the pool in place; the gather
    path is its oracle. MoE layers run their einsum path, as in the
    reference (its programs never pass the Soft-MoE ``use_kernel``)."""

    def decode(params, tokens, pos, tables, cache):
        out = lm_apply(
            params, cfg, tokens, positions=pos[:, None], cache=cache,
            mode="decode", block_tables=tables, paged_kernel=use_kernel,
            telemetry=telemetry,
        )
        return (out[0], out[3]) if telemetry else out[0]

    return decode


def make_verify_step_paged(cfg, use_kernel: bool = False,
                           telemetry: bool = False):
    """Paged speculative verify: (params, tokens(B,S), pos(B,S),
    tables(B,nb), cache) -> logits(B,S,V), or (logits, telem): the
    contract of `make_verify_step` through the block tables.
    ``use_kernel`` is taken for signature parity with the decode program,
    but S > 1 always gathers, as in the reference: the paged
    decode-attention kernel is single-query."""

    def verify(params, tokens, pos, tables, cache):
        out = lm_apply(
            params, cfg, tokens, positions=pos, cache=cache,
            mode="decode", block_tables=tables, paged_kernel=use_kernel,
            telemetry=telemetry,
        )
        return (out[0], out[3]) if telemetry else out[0]

    return verify


def invalidate_positions_paged_program(cache, positions, tables):
    """Speculative rollback on the paged pool: pos -> -1 through the block
    tables for a (B, W) batch of absolute positions in every attention
    layer."""
    for layer in cache:
        if "attn" in layer:
            invalidate_paged_positions(layer["attn"], positions, tables)
    return cache


def clear_blocks_program(cache, blocks):
    """Invalidate physical blocks (pos -> -1) in every attention layer.
    Freed blocks are cleared at their next allocation."""
    for layer in cache:
        if "attn" in layer:
            reset_block_pos(layer["attn"], blocks)
    return cache


def copy_blocks_program(cache, src, dst):
    """Copy physical blocks src[i] -> dst[i] in every attention layer
    (copy-on-write fork)."""
    for layer in cache:
        if "attn" in layer:
            copy_kv_blocks(layer["attn"], src, dst)
    return cache


def clear_ssm_slot_program(cache, slot: int):
    """Zero one slot's SSM rows at admission (attention needs no clear
    here: blocks are invalidated one by one as they are allocated)."""
    for layer in cache:
        if "ssm" in layer:
            reset_ssm_rows(layer["ssm"], slot)
    return cache
