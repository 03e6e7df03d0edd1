"""Attention variants: GQA (optional QKV bias, sliding window) and MLA
(DeepSeek-V2 multi-head latent attention with a compressed KV cache),
over no cache, a contiguous ring cache or a paged KV pool, counterpart
of ``repro/layers/attention.py``.

Three execution modes share one code path:
  * train/eval: full sequence, no cache.
  * contiguous serving: a per-row ring (``init_kv_cache``) of ``length``
    slots, ``min(length, window)`` on sliding-window layers; position p
    of row b lives in slot ``p % length``. Whole-prompt prefill
    (``mode="prefill"``, S > 1) writes the ring and attends the input
    K/V; decode and chunk continuations write, then attend the ring.
  * paged serving: chunked prefill (S > 1) and single-token decode attend
    a block pool through per-row block tables: (num_blocks, block_size,
    G, D) keys and values for GQA, the (num_blocks, block_size, rank)
    latent ``ckv`` and the (num_blocks, block_size, rope_dim) ``krope``
    for MLA. GQA's single-token decode can run the paged decode-attention
    kernel (kernels/paged_attention.py), which reads the pool in place;
    every other call, MLA decode included, gathers the row view.

Both attend densely (``_attend``) or, once Sq * Sk passes
``_CHUNKED_THRESHOLD``, with the flash-style online softmax over key
blocks (``_attend_chunked``), as the reference does. Rings and pools
are updated IN PLACE (the JAX package returns a new pytree and donates
the old one; here the same tensors are written).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..kernels.paged_attention import paged_decode_attend
from .common import lecun_init, resolve_device
from .rotary import apply_rope

NEG_INF = -2.0**30

# Above this (Sq * Sk) product attention takes the flash-style chunked
# path (`_attend_chunked`), which never holds the (Sq, Sk) logits: at
# 4096 tokens the dense path's f32 logits are (b, h, 4096, 4096).
_CHUNKED_THRESHOLD = 2048 * 4096


def gqa_init(gen: torch.Generator, cfg):
    a = cfg.attention
    d = cfg.d_model
    p = {
        "wq": lecun_init(gen, (d, a.num_heads, a.head_dim), fan_in=d),
        "wk": lecun_init(gen, (d, a.num_kv_heads, a.head_dim), fan_in=d),
        "wv": lecun_init(gen, (d, a.num_kv_heads, a.head_dim), fan_in=d),
        "wo": lecun_init(gen, (a.num_heads, a.head_dim, d),
                         fan_in=a.num_heads * a.head_dim),
    }
    if a.qkv_bias:
        dev = gen.device
        p["bq"] = torch.zeros(a.num_heads, a.head_dim, device=dev)
        p["bk"] = torch.zeros(a.num_kv_heads, a.head_dim, device=dev)
        p["bv"] = torch.zeros(a.num_kv_heads, a.head_dim, device=dev)
    return p


def init_kv_cache(cfg, batch: int, length: int, is_global: bool,
                  dtype=torch.bfloat16, *, device):
    """Contiguous cache for one layer: a ring of ``length`` slots per row,
    ``min(length, sliding_window)`` on a sliding-window layer that is not
    global. ``pos`` is per row, (batch, length), so rows advance through
    their rings independently (continuous batching admits and retires
    rows at any decode step); an entry with pos < 0 is invalid and masked
    out of attention."""
    a = cfg.attention
    device = resolve_device(device)
    if a.sliding_window is not None and not is_global:
        length = min(length, a.sliding_window)
    if a.kind == "mla":
        shapes = {"ckv": (batch, length, a.kv_lora_rank),
                  "krope": (batch, length, a.qk_rope_head_dim)}
    else:
        shape = (batch, length, a.num_kv_heads, a.head_dim)
        shapes = {"k": shape, "v": shape}
    ring = {n: torch.zeros(sh, dtype=dtype, device=device)
            for n, sh in shapes.items()}
    ring["pos"] = torch.full((batch, length), -1, dtype=torch.int32,
                             device=device)
    return ring


def init_paged_kv_cache(cfg, num_blocks: int, block_size: int,
                        dtype=torch.bfloat16, *, device):
    """Paged cache for one layer: one pool of ``num_blocks`` fixed-size
    token blocks shared by ALL rows (serve/block_manager.py hands blocks
    out); a request reaches its tokens through a per-row block table.
    Sliding-window layers store every position and rely on the window
    term of `make_mask`. Block 0 is the NULL block: its `pos` stays -1
    forever, so unallocated table entries address only masked-out keys."""
    a = cfg.attention
    device = resolve_device(device)
    if a.kind == "mla":
        shapes = {"ckv": (num_blocks, block_size, a.kv_lora_rank),
                  "krope": (num_blocks, block_size, a.qk_rope_head_dim)}
    else:
        shape = (num_blocks, block_size, a.num_kv_heads, a.head_dim)
        shapes = {"k": shape, "v": shape}
    pool = {n: torch.zeros(sh, dtype=dtype, device=device)
            for n, sh in shapes.items()}
    pool["pos"] = torch.full((num_blocks, block_size), -1,
                             dtype=torch.int32, device=device)
    return pool


def _attend(q, k, v, mask, scale: Optional[float] = None):
    """q: (B,Sq,H,Dk); k: (B,Sk,G,Dk); v: (B,Sk,G,Dv) grouped;
    mask: (B,Sq,Sk) bool or None. Softmax in f32, output in q's dtype."""
    b, sq, h, d = q.shape
    g, dv = k.shape[2], v.shape[-1]
    rep = h // g
    scale = scale if scale is not None else 1.0 / float(d) ** 0.5
    qg = q.reshape(b, sq, g, rep, d)
    logits = scale * torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    if mask is not None:
        bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)
        logits = logits + bias[:, None, None]
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", w, v.float())
    return out.reshape(b, sq, h, dv).to(q.dtype)


def _attend_chunked(q, k, v, qpos, kpos, causal: bool,
                    window: Optional[int], scale: Optional[float] = None,
                    is_global: bool = True, block: int = 1024):
    """Flash-style online-softmax attention over key blocks of ``block``:
    never holds the (Sq, Sk) logits or mask. Shapes as `_attend`; qpos
    (Sq,) or (B,Sq), kpos (Sk,) or (B,Sk). The arithmetic is the
    reference's: f32 throughout, keys padded to whole blocks with
    position -1, running max, sum and accumulator, then acc / max(l,
    1e-30). So a row with no valid key averages every key, padding
    included, as the reference does (`_attend` would average the valid
    length only). Each block runs under activation checkpointing, so the
    backward recomputes its (Sq, block) tile instead of storing the
    probabilities of every block."""
    b, sq, h, d = q.shape
    sk, g, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = h // g
    scale = scale if scale is not None else 1.0 / float(d) ** 0.5
    if kpos.ndim == 1:  # shared key positions -> per row
        kpos = kpos[None].expand(b, sk)
    pad = -sk % block
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kpos = torch.nn.functional.pad(kpos, (0, pad), value=-1)
    qg = q.float().reshape(b, sq, g, rep, d)
    kf, vf = k.float(), v.float()

    def body(m, l, acc, kblk, vblk, kp):
        s = torch.einsum("bsgrd,btgd->bgrst", qg, kblk) * scale
        mask = make_mask(qpos, kp, causal, window, is_global)  # (b,sq,blk)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = (acc * corr[..., None]
               + torch.einsum("bgrst,btgd->bgrsd", p, vblk))
        return m_new, l, acc

    m = torch.full((b, g, rep, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, g, rep, sq), device=q.device)
    acc = torch.zeros((b, g, rep, sq, dv), device=q.device)
    for i in range(0, sk + pad, block):
        m, l, acc = checkpoint(body, m, l, acc, kf[:, i:i + block],
                               vf[:, i:i + block], kpos[:, i:i + block],
                               use_reentrant=False)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv).to(q.dtype)


def _attend_any(q, k, v, qpos, kpos, causal: bool, window: Optional[int],
                scale: Optional[float] = None, is_global: bool = True):
    """The reference's dispatch: the chunked path once Sq * Sk passes
    ``_CHUNKED_THRESHOLD``, else the dense masked softmax."""
    b, s = q.shape[:2]
    if k.shape[1] * max(s, 1) > _CHUNKED_THRESHOLD:
        return _attend_chunked(q, k, v, qpos, kpos, causal, window,
                               scale=scale, is_global=is_global)
    mask = make_mask(qpos, kpos, causal, window, is_global)
    if mask.ndim == 2:  # shared (S,) positions -> add batch dim
        mask = mask[None].expand(b, -1, -1)
    return _attend(q, k, v, mask, scale=scale)


def make_mask(q_positions, k_positions, causal: bool,
              window: Optional[int], is_global: bool = True):
    """Boolean (B?,Sq,Sk) mask: True = attend. Positions may be (S,) or
    (B,S); invalid cache entries carry position -1."""
    q = q_positions[..., :, None]
    k = k_positions[..., None, :]
    m = k >= 0
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & ((k > q - window) | bool(is_global))
    return m


def _ring_slots(cache, positions):
    """Ring addressing of every contiguous-cache writer: (B?,S) absolute
    positions -> ((B,S) positions, (B,S) slots, (B,S) written?). Position
    p lands in slot ``p % length``; tokens with position < 0 are not
    written and address slot 0 (the JAX package addresses the
    out-of-bounds slot ``length``, which its scatter drops)."""
    b, length = cache["pos"].shape
    if positions.ndim == 1:
        positions = positions[None].expand(b, positions.shape[0])
    ok = positions >= 0
    slots = torch.where(ok, positions % length, 0).long()
    return positions, slots, ok


def _ring_update(cache, new_vals: dict, positions):
    """Write ``new_vals[name]`` (B,S,...) at each row's ring slots in
    place. Tokens at position < 0 leave both the entry and its ``pos``
    as they are: inactive rows ride through batched decode steps, and
    left-pad tokens of a prefill chunk write nothing.

    Where two tokens of a row map to one slot (a whole-prompt prefill
    longer than the ring), the one at the highest position wins, the
    state that later decode steps read: each slot's winner is found
    first (an ``amax`` over position-major keys), and every lane that
    addresses a slot then stores the slot's final value, so duplicate
    indices carry one value and the scatter order cannot matter. A slot
    that no valid token writes keeps its own value, as the paged
    writer's dropped lanes do; no index depends on the data, so nothing
    synchronises with the host."""
    positions, slots, ok = _ring_slots(cache, positions)
    b, s = slots.shape
    lane = torch.arange(s, device=slots.device)
    key = torch.where(ok, positions.long() * s + lane, -1)
    best = torch.full(cache["pos"].shape, -1, dtype=torch.long,
                      device=slots.device)
    best.scatter_reduce_(1, slots, key, "amax")
    win = best.gather(1, slots)  # (B,S): the final key of each lane's slot
    hit = win >= 0
    src = torch.where(hit, win % s, 0)  # the winning lane
    rows = torch.arange(b, device=slots.device)[:, None]
    for name, val in new_vals.items():
        ring = cache[name]
        keep = hit.reshape(hit.shape + (1,) * (val.ndim - 2))
        ring[rows, slots] = torch.where(keep, val[rows, src].to(ring.dtype),
                                        ring[rows, slots])
    pos = cache["pos"]
    pos[rows, slots] = torch.where(hit, (win // s).to(pos.dtype),
                                   pos[rows, slots])
    return cache


def reset_kv_rows(cache, row):
    """Invalidate row(s) of one layer's ring in place: pos -> -1. The stale
    K/V values stay; ``make_mask`` admits only entries with pos >= 0, and
    a later write replaces value and pos together."""
    cache["pos"][row] = -1
    return cache


def invalidate_kv_positions(cache, positions):
    """Speculative-decoding rollback on the ring, in place: pos -> -1 at
    each row's ring slot for the (B, W) absolute ``positions``; lanes
    below 0 drop. The rejected draft tokens' entries were already
    unreachable (causal masking hides them until the row's own writes
    replace them); clearing them leaves the cache EQUAL to never having
    drafted. The entries to clear are counted per slot first and
    cleared by a mask, so no two lanes ever store to one entry."""
    _, slots, ok = _ring_slots(cache, positions)
    pos = cache["pos"]
    hits = torch.zeros_like(pos).scatter_add_(1, slots, ok.to(pos.dtype))
    pos.masked_fill_(hits > 0, -1)
    return cache


def invalidate_paged_positions(cache, positions, tables):
    """Paged analogue of `invalidate_kv_positions`, in place: pos -> -1
    through the block tables for the (B, W) ``positions``; lanes below 0
    and null-block entries drop. Blocks that held only rejected tokens
    are un-reserved separately (``PagedBackend.rollback_burst``); this
    clears rejected entries inside blocks the row keeps."""
    _, phys, off, ok = _paged_address(cache, positions, tables)
    pos = cache["pos"]
    bs_blk = pos.shape[1]
    hits = torch.zeros(pos.numel(), dtype=pos.dtype, device=pos.device)
    hits.index_add_(0, (phys * bs_blk + off).flatten(),
                    ok.flatten().to(pos.dtype))
    pos.masked_fill_(hits.view(pos.shape) > 0, -1)
    return cache


def _paged_address(cache, positions, tables):
    """Block-table addressing of every paged-cache writer: (B?,S)
    absolute positions -> ((B,S) positions, (B,S) physical block, (B,S)
    offset, (B,S) written?). Token at position p of row b lands in
    physical block ``tables[b, p // block_size]`` at offset
    ``p % block_size``. Tokens with position < 0, and positions whose
    table entry is still the null block, are not written: they address
    block 0, offset 0 with written=False (the JAX package addresses an
    out-of-bounds block that its scatter drops)."""
    bs_blk = cache["pos"].shape[1]
    b = tables.shape[0]
    if positions.ndim == 1:
        positions = positions[None].expand(b, positions.shape[0])
    logical = torch.clamp(
        torch.where(positions >= 0, positions // bs_blk, 0),
        0, tables.shape[1] - 1,
    ).long()
    phys = torch.gather(tables.long(), 1, logical)  # (B,S)
    ok = (positions >= 0) & (phys > 0)
    phys = torch.where(ok, phys, 0)
    off = torch.where(ok, positions % bs_blk, 0).long()
    return positions, phys, off, ok


def _paged_update(cache, new_vals: dict, positions, tables):
    """Scatter `new_vals[name]` (B,S,...) into the paged pool in place
    through the per-row block tables (`_paged_address` has the rules).
    Lanes that are not written store the entry's current value back, so
    inactive rows and left-pad tokens leave the pool unchanged without a
    data-dependent (host-synchronising) index."""
    positions, phys, off, ok = _paged_address(cache, positions, tables)
    for name, val in new_vals.items():
        pool = cache[name]
        keep = ok.reshape(ok.shape + (1,) * (val.ndim - 2))
        pool[phys, off] = torch.where(keep, val.to(pool.dtype),
                                      pool[phys, off])
    pos = cache["pos"]
    pos[phys, off] = torch.where(ok, positions.to(pos.dtype), pos[phys, off])
    return cache


def _paged_view(cache, tables):
    """Gather a per-row (B, blocks_per_row * block_size, ...) KV view out
    of the paged pool, in logical-position order; null-block entries
    carry pos -1 and mask out."""
    b, nb = tables.shape
    bs_blk = cache["pos"].shape[1]
    idx = tables.long()
    vals = {
        n: cache[n][idx].reshape((b, nb * bs_blk) + cache[n].shape[2:])
        for n in cache if n != "pos"
    }
    kpos = cache["pos"][idx].reshape(b, nb * bs_blk)
    return vals, kpos


def reset_block_pos(cache, blocks):
    """Invalidate physical blocks (pos -> -1) in place. ``blocks`` is a
    list or 1-D tensor of block ids, every one a real block."""
    cache["pos"][torch.as_tensor(blocks, dtype=torch.long,
                                 device=cache["pos"].device)] = -1
    return cache


def copy_kv_blocks(cache, src, dst):
    """Copy physical blocks src[i] -> dst[i] in place (copy-on-write
    fork); ``src``/``dst`` are equal-length id lists."""
    dev = cache["pos"].device
    s = torch.as_tensor(src, dtype=torch.long, device=dev)
    d = torch.as_tensor(dst, dtype=torch.long, device=dev)
    for val in cache.values():
        val[d] = val[s]
    return cache


def gqa_apply(params, cfg, x, *, layer_is_global: bool = True,
              positions=None, cache=None, mode: str = "train",
              block_tables=None, paged_kernel: bool = False):
    """Returns (out, cache). positions: (S,) shared or (B,S) per-row
    absolute token positions; entries < 0 are pad/inactive (no cache
    write, masked from attention). ``cache`` is a per-row ring
    (`init_kv_cache`), or with ``block_tables`` (B, blocks_per_row) a
    paged block pool (`init_paged_kv_cache`); either is updated in place.
    ``paged_kernel`` routes single-token paged decode through the paged
    decode-attention kernel instead of gathering the per-row view."""
    a = cfg.attention
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dgk->bsgk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bsgk", x, params["wv"].to(dt))
    if a.qkv_bias:
        q = q + params["bq"].to(dt)
        k = k + params["bk"].to(dt)
        v = v + params["bv"].to(dt)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)
    window = a.sliding_window
    is_global = bool(layer_is_global)

    if cache is None:
        k_all, v_all, kpos = k, v, positions
    elif block_tables is not None:
        # Paged path: scatter this call's KV through the block tables
        # (write-then-read keeps chunked prefill self-attending), then
        # attend the pool in place through the kernel on the decode hot
        # path, or through the gathered row view (S > 1, or the oracle).
        if mode == "prefill":
            raise ValueError("paged cache serves chunked prefill only "
                             "(mode='decode' with S > 1)")
        _paged_update(cache, {"k": k, "v": v}, positions, block_tables)
        if paged_kernel and s == 1:
            qpos = (positions[:, 0] if positions.ndim == 2
                    else positions[0].expand(b))
            out = paged_decode_attend(
                q[:, 0].contiguous(), cache["k"], cache["v"], cache["pos"],
                block_tables, qpos.to(torch.int32).contiguous(),
                causal=cfg.causal, window=window, is_global=is_global,
            )[:, None]
            out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
            return out, cache
        gathered, kpos = _paged_view(cache, block_tables)
        k_all, v_all = gathered["k"], gathered["v"]
    else:
        _ring_update(cache, {"k": k, "v": v}, positions)
        if s > 1 and mode == "prefill":
            # whole-prompt prefill attends its own K/V: the ring may have
            # wrapped (window < prompt), so it serves later steps only
            k_all, v_all, kpos = k, v, positions
        else:
            # decode, and a chunk continuation (S > 1, mode="decode"),
            # attend the ring, which now holds this call's tokens too
            k_all, v_all, kpos = cache["k"], cache["v"], cache["pos"]

    out = _attend_any(q, k_all, v_all, positions, kpos, cfg.causal, window,
                      is_global=is_global)
    out = torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt))
    return out, cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------


def mla_init(gen: torch.Generator, cfg):
    a = cfg.attention
    d = cfg.d_model
    qk_head = a.qk_nope_head_dim + a.qk_rope_head_dim
    return {
        "wq": lecun_init(gen, (d, a.num_heads, qk_head), fan_in=d),
        "w_dkv": lecun_init(gen, (d, a.kv_lora_rank), fan_in=d),
        "w_krope": lecun_init(gen, (d, a.qk_rope_head_dim), fan_in=d),
        "w_uk": lecun_init(gen, (a.kv_lora_rank, a.num_heads,
                                 a.qk_nope_head_dim), fan_in=a.kv_lora_rank),
        "w_uv": lecun_init(gen, (a.kv_lora_rank, a.num_heads, a.v_head_dim),
                           fan_in=a.kv_lora_rank),
        "wo": lecun_init(gen, (a.num_heads, a.v_head_dim, d),
                         fan_in=a.num_heads * a.v_head_dim),
    }


def mla_apply(params, cfg, x, *, positions=None, cache=None,
              mode: str = "train", layer_is_global: bool = True,
              block_tables=None, paged_kernel: bool = False):
    """MLA with a compressed-KV cache, in the absorbed form: q_nope is
    projected into the latent rank space (in f32, against an f32 ``w_uk``)
    so the scores are taken against the (B, S, rank) latent directly, as
    attention with one shared KV "head" of width rank + rope_dim for the
    scores and rank for the values; the weighted latent is expanded
    through ``w_uv`` (in f32) once, then ``wo``. Returns (out, cache).

    ``paged_kernel`` is accepted for signature parity and ignored: MLA
    decode always gathers the paged row view, as in the reference, whose
    paged decode kernel reads GQA pools only (the latent pool's score and
    value widths differ). So the paged decode-attention kernel never runs
    for an MLA model; this is the reference's design, not a fallback."""
    del layer_is_global, paged_kernel
    a = cfg.attention
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    q_nope = q[..., :a.qk_nope_head_dim]
    q_rope = apply_rope(q[..., a.qk_nope_head_dim:], positions, a.rope_theta)
    ckv = torch.einsum("bsd,dr->bsr", x, params["w_dkv"].to(dt))
    krope = apply_rope(
        torch.einsum("bsd,dk->bsk", x, params["w_krope"].to(dt))[:, :, None],
        positions, a.rope_theta)[:, :, 0]
    scale = 1.0 / float(a.qk_nope_head_dim + a.qk_rope_head_dim) ** 0.5

    if cache is None:
        ckv_all, krope_all, kpos = ckv, krope, positions
    elif block_tables is not None:
        if mode == "prefill":
            raise ValueError("paged cache serves chunked prefill only "
                             "(mode='decode' with S > 1)")
        _paged_update(cache, {"ckv": ckv, "krope": krope}, positions,
                      block_tables)
        gathered, kpos = _paged_view(cache, block_tables)
        ckv_all, krope_all = gathered["ckv"], gathered["krope"]
    else:
        _ring_update(cache, {"ckv": ckv, "krope": krope}, positions)
        if s > 1 and mode == "prefill":  # as in gqa_apply
            ckv_all, krope_all, kpos = ckv, krope, positions
        else:
            ckv_all, krope_all = cache["ckv"], cache["krope"]
            kpos = cache["pos"]

    q_lat = torch.einsum("bshk,rhk->bshr", q_nope.float(),
                         params["w_uk"].float()).to(dt)
    q_cat = torch.cat([q_lat, q_rope], dim=-1)  # (b, s, h, rank + rope)
    k_cat = torch.cat([ckv_all, krope_all], dim=-1)[:, :, None]
    lat = _attend_any(q_cat, k_cat, ckv_all[:, :, None], positions, kpos,
                      cfg.causal, None, scale=scale)
    out = torch.einsum("bshr,rhv->bshv", lat.float(), params["w_uv"].float())
    out = torch.einsum("bshv,hvd->bsd", out.to(dt), params["wo"].to(dt))
    return out, cache


def attention_init(gen: torch.Generator, cfg):
    if cfg.attention.kind == "mla":
        return mla_init(gen, cfg)
    return gqa_init(gen, cfg)


def attention_apply(params, cfg, x, **kw):
    if cfg.attention.kind == "mla":
        return mla_apply(params, cfg, x, **kw)
    return gqa_apply(params, cfg, x, **kw)
