"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro/kernels/paged_attention_kernels.py``
(``paged_decode_attend``, a Pallas kernel for the TPU). The kernel is
``csrc/paged_decode_attention.cu``, written for Hopper (``sm_90a``),
built with ``nvcc`` at first use and called through ctypes; the source's
header says what bounds it and how it is laid out.

``paged_decode_attend`` launches the kernel for CUDA tensors and runs
``paged_decode_attend_ref`` for CPU tensors. There is no fallback: a
CUDA call whose kernel does not build or launch raises.
``paged_decode_attend.launches`` counts calls that launched the kernel
(its split pass and its merge: one a call; never plain runs), so a
caller can show that a run went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .tuning import KernelConfig, paged_config, paged_split_tiles

_NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _shapes(q, k_pool, v_pool, pos_pool, tables, q_pos):
    b, h, dk = q.shape
    nblk, block_size, groups, dk2 = k_pool.shape
    if dk2 != dk:
        raise ValueError(f"q head dim {dk} != pool head dim {dk2}")
    if v_pool.shape[:3] != k_pool.shape[:3]:
        raise ValueError(f"v pool {tuple(v_pool.shape)} does not match "
                         f"k pool {tuple(k_pool.shape)}")
    if tuple(pos_pool.shape) != (nblk, block_size):
        raise ValueError(f"pos pool {tuple(pos_pool.shape)} != "
                         f"{(nblk, block_size)}")
    if tables.ndim != 2 or tables.shape[0] != b:
        raise ValueError(f"tables {tuple(tables.shape)} != (B={b}, nb)")
    if tuple(q_pos.shape) != (b,):
        raise ValueError(f"q_pos {tuple(q_pos.shape)} != ({b},)")
    if h % groups != 0:
        raise ValueError(f"heads {h} not a multiple of kv groups {groups}")
    return b, h, dk, block_size, groups, v_pool.shape[-1], tables.shape[1]


def paged_decode_attend_ref(q, k_pool, v_pool, pos_pool, tables, q_pos, *,
                            causal: bool = True,
                            window: Optional[int] = None,
                            is_global: bool = True,
                            scale: Optional[float] = None,
                            cfg: Optional[KernelConfig] = None):
    """Plain PyTorch version of the kernel, with the kernel's arithmetic
    in f32: each row's tiles of ``paged_block_kv`` keys, read through the
    tables, are cut into splits of ``paged_split_tiles`` tiles; a split
    folds into a partial per query head (m = max(-1e30, its valid
    scores), den = sum exp(s - m), acc = sum exp(s - m) V; masked keys
    weigh exactly 0), and the partials merge in split order with the
    online update. Rows without a valid key return zeros through the safe
    divide acc / max(den, 1e-30)."""
    b, h, dk, block_size, groups, dv, nb = _shapes(
        q, k_pool, v_pool, pos_pool, tables, q_pos)
    rep = h // groups
    scale = scale if scale is not None else 1.0 / float(dk) ** 0.5
    cfg = paged_config(block_size, cfg)
    bkv = cfg.paged_block_kv
    sub = block_size // bkv
    split = paged_split_tiles(bkv)
    dt = cfg.acc()
    dev = q.device
    qg = q.to(dt).reshape(b, groups, rep, dk)
    qp = q_pos.long()[:, None]
    tables = tables.long()
    kf, vf = (t.reshape(-1, groups, t.shape[-1]) for t in (k_pool, v_pool))
    posf = pos_pool.reshape(-1)
    offs = torch.arange(bkv, device=dev)
    acc = torch.zeros(b, groups, rep, dv, dtype=dt, device=dev)
    mx = torch.full((b, groups, rep), _NEG, dtype=dt, device=dev)
    den = torch.zeros(b, groups, rep, dtype=dt, device=dev)
    for t0 in range(0, nb * sub, split):  # a CUDA block per (group, split)
        tiles = torch.arange(t0, min(t0 + split, nb * sub), device=dev)
        # pool row of every key of the split, in logical order: (B, keys)
        idx = (tables[:, tiles // sub] * block_size
               + ((tiles % sub) * bkv)[None, :])[..., None] + offs
        idx = idx.reshape(b, -1)
        k, v = kf[idx].to(dt), vf[idx].to(dt)  # (B, keys, G, D)
        kp = posf[idx].long()
        s = scale * torch.einsum("bgrd,btgd->bgrt", qg, k)
        ok = kp >= 0
        if causal:
            ok = ok & (kp <= qp)
        if window is not None:
            ok = ok & ((kp > qp - window) | bool(is_global))
        ok = ok[:, None, None, :]
        s = torch.where(ok, s, torch.full_like(s, -torch.inf))
        m_j = torch.clamp(s.amax(-1), min=_NEG)
        p = torch.where(ok, torch.exp(s - m_j[..., None]),
                        torch.zeros_like(s))
        den_j = p.sum(-1)
        acc_j = torch.einsum("bgrt,btgd->bgrd", p, v)
        # the merge pass: the split's partial joins the row's in order
        m_new = torch.maximum(mx, m_j)
        c_old, c_j = torch.exp(mx - m_new), torch.exp(m_j - m_new)
        den = den * c_old + den_j * c_j
        acc = acc * c_old[..., None] + acc_j * c_j[..., None]
        mx = m_new
    out = acc / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, h, dv).to(q.dtype)


def _check_cuda_operands(q, k_pool, v_pool, pos_pool, tables, q_pos):
    dev = q.device
    named = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
             "pos_pool": pos_pool, "tables": tables, "q_pos": q_pos}
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"k/v pool dtypes {k_pool.dtype}/{v_pool.dtype}: "
                        f"both must be one of {list(_DTYPE_CODE)}")
    for name in ("pos_pool", "tables", "q_pos"):
        if named[name].dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {named[name].dtype}")
    # The kernel stages K and V rows with 16-byte vector loads.
    for name in ("k_pool", "v_pool"):
        t = named[name]
        if (t.shape[-1] * t.element_size()) % 16:
            raise ValueError(f"{name} head dim {t.shape[-1]} x "
                             f"{t.element_size()} B is not a multiple of "
                             f"16 bytes")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")


def _launcher():
    from .build import load

    fn = load("paged_decode_attention").paged_decode_attend_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 15 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def paged_decode_attend(q, k_pool, v_pool, pos_pool, tables, q_pos, *,
                        causal: bool = True, window: Optional[int] = None,
                        is_global: bool = True,
                        scale: Optional[float] = None,
                        cfg: Optional[KernelConfig] = None):
    """Decode attention straight off the paged pool.

    q: (B, H, Dk) one query per row; k_pool/v_pool: (num_blocks,
    block_size, G, D*) shared physical pool; pos_pool: (num_blocks,
    block_size) int32 positions (-1 invalid); tables: (B, blocks_per_row)
    int32 physical block ids (0 = null block); q_pos: (B,) int32 absolute
    positions (-1 = inactive row). Returns (B, H, Dv) in q.dtype.

    CPU tensors run ``paged_decode_attend_ref``; CUDA tensors launch the
    kernel on the current stream or raise."""
    if q.device.type == "cpu":
        return paged_decode_attend_ref(
            q, k_pool, v_pool, pos_pool, tables, q_pos, causal=causal,
            window=window, is_global=is_global, scale=scale, cfg=cfg)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    b, h, dk, block_size, groups, dv, nb = _shapes(
        q, k_pool, v_pool, pos_pool, tables, q_pos)
    _check_cuda_operands(q, k_pool, v_pool, pos_pool, tables, q_pos)
    bkv = paged_config(block_size, cfg).paged_block_kv
    split = paged_split_tiles(bkv)
    n_split = -(-nb * (block_size // bkv) // split)
    scale = scale if scale is not None else 1.0 / float(dk) ** 0.5
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    # each split's partial per head: acc (Dv), then max and denom
    part = torch.empty((b, n_split, h, dv + 2), dtype=torch.float32,
                       device=q.device)
    fn = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                 pos_pool.data_ptr(), tables.data_ptr(), q_pos.data_ptr(),
                 part.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype],
                 _DTYPE_CODE[k_pool.dtype], b, h, groups, dk, dv,
                 block_size, nb, bkv, split, int(causal),
                 int(window is not None), int(window or 0),
                 int(bool(is_global)), float(scale), stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: "
                           f"cudaError {err}")
    paged_decode_attend.launches += 1
    return out


paged_decode_attend.launches = 0
