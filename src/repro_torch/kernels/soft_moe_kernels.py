"""Soft-MoE routing and combine: the CUDA kernels' wrappers and their plain
versions, counterpart of ``repro/kernels/soft_moe_kernels.py`` (Pallas
kernels for the TPU), forward only.

- K1 ``routing_fwd`` (``csrc/soft_moe_routing.cu``; replaces
  ``routing_fwd_pallas``): one logits pass ``l2norm(X) . Phi_n`` gives the
  dispatched slots (b, S, d), the dispatch stats (b, S) and the combine
  stats (b, m).
- K2 ``combine_apply`` (``csrc/soft_moe_combine.cu``; replaces
  ``combine_apply_pallas``): ``Y = C Ys`` with C from K1's saved stats.
- K3 ``combine_online`` (same source; replaces ``combine_online_pallas``):
  the combine with an online softmax over slots, which also returns
  (c_mx, c_den).
- ``dispatch_2d`` / ``combine_2d``: single-sequence wrappers on K1 / K3
  (``dispatch_pallas`` / ``combine_pallas`` in the JAX package).

The kernels are written for Hopper (``sm_90a``), built with ``nvcc`` at
first use and called through ctypes; each source's header says what
bounds it and how it is laid out. Each wrapper runs its plain version
(``*_ref``) for CPU tensors and, for CUDA tensors, launches its kernel
or raises: there is no fallback. ``<wrapper>.launches`` counts kernel
launches (never plain runs). The backward kernels (K4, K5) come with
the training slice: until then a CUDA wrapper refuses inputs that would
need a gradient.

The plain versions repeat the kernels' tile recurrences in PyTorch, with
``block_tokens`` / ``block_slots`` from the ``KernelConfig``, so the CPU
tests can pin them to the JAX kernels' tiling. Each batch row runs on its
own, so row i of a batch equals that row run alone, bitwise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .tuning import SOFT_MOE_TILE, KernelConfig, d_chunk, default_config

_NEG = -1e30
_EPS = 1e-6  # must match ref.l2_normalize
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _resolve(cfg: Optional[KernelConfig], m: int, d: int,
             s: int) -> KernelConfig:
    """``cfg`` as given, or the default policy when None."""
    return default_config(m, d, s) if cfg is None else cfg


def _shapes(x, phi_n, ys=None):
    if x.ndim != 3 or phi_n.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)} must be (b, m, d) and phi_n "
                         f"{tuple(phi_n.shape)} (d, S)")
    b, m, d = x.shape
    if phi_n.shape[0] != d:
        raise ValueError(f"phi_n {tuple(phi_n.shape)} != (d={d}, S)")
    s = phi_n.shape[1]
    if m == 0 or s == 0:
        raise ValueError(f"empty routing problem: m={m}, S={s}")
    if ys is not None and tuple(ys.shape) != (b, s, d):
        raise ValueError(f"ys {tuple(ys.shape)} != {(b, s, d)}")
    return b, m, d, s


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _inv_norm(xf):
    """(n, d) f32 -> (n,): 1 / (||x|| + eps), as the kernels' pre-pass."""
    return 1.0 / (torch.sqrt((xf * xf).sum(-1)) + _EPS)


def _logits(xf, rn, phi):
    """l2norm(x) . phi as the kernels form it: rn * (x . phi)."""
    return (xf @ phi) * rn[:, None]


def _routing_row(xf, phi, bt, bs):
    """K1's recurrence for one row: xf (m, d) f32, phi (d, S) f32."""
    m = xf.shape[0]
    rn = _inv_norm(xf)
    slots, dmx, dden, parts = [], [], [], []
    for s0 in range(0, phi.shape[1], bs):
        ph = phi[:, s0:s0 + bs]
        mx = torch.full((ph.shape[1],), _NEG, device=xf.device)
        den = torch.zeros(ph.shape[1], device=xf.device)
        acc = torch.zeros(ph.shape[1], xf.shape[1], device=xf.device)
        pm, pd = [], []
        for t0 in range(0, m, bt):
            xt = xf[t0:t0 + bt]
            lg = _logits(xt, rn[t0:t0 + bt], ph)  # (nt, ns)
            # combine direction: this slot block's partial per token
            pm.append(lg.amax(1))
            pd.append(torch.exp(lg - pm[-1][:, None]).sum(1))
            # dispatch direction: online softmax over tokens
            m_new = torch.maximum(mx, lg.amax(0))
            corr = torch.exp(mx - m_new)
            p = torch.exp(lg - m_new)
            den = den * corr + p.sum(0)
            acc = acc * corr[:, None] + p.T @ xt
            mx = m_new
        slots.append(acc / den[:, None])
        dmx.append(mx)
        dden.append(den)
        parts.append((torch.cat(pm), torch.cat(pd)))
    # merge the partials in slot-block order
    c_mx = torch.full((m,), _NEG, device=xf.device)
    c_den = torch.zeros(m, device=xf.device)
    for pm, pd in parts:
        m_new = torch.maximum(c_mx, pm)
        c_den = c_den * torch.exp(c_mx - m_new) + pd * torch.exp(pm - m_new)
        c_mx = m_new
    return (torch.cat(slots), torch.cat(dmx), torch.cat(dden), c_mx, c_den)


def routing_fwd_ref(x, phi_n, cfg: Optional[KernelConfig] = None):
    """Plain version of K1. x: (b, m, d); phi_n: (d, S). Returns
    ``(slots (b, S, d) in x's dtype, (d_mx, d_den) (b, S),
    (c_mx, c_den) (b, m))``, stats in f32."""
    b, m, d, s = _shapes(x, phi_n)
    cfg = _resolve(cfg, m, d, s)
    phi = phi_n.float()
    rows = [_routing_row(x[i].float(), phi, cfg.block_tokens,
                         cfg.block_slots) for i in range(b)]
    slots, dmx, dden, cmx, cden = (torch.stack(t) for t in zip(*rows))
    return slots.to(x.dtype), (dmx, dden), (cmx, cden)


def _combine_row(xf, phi, ysf, bt, bs, c_mx=None, c_den=None):
    """K2's (stats given) or K3's (online) recurrence for one row."""
    m = xf.shape[0]
    rn = _inv_norm(xf)
    ys, mxs, dens = [], [], []
    for t0 in range(0, m, bt):
        xt, rt = xf[t0:t0 + bt], rn[t0:t0 + bt]
        nt = xt.shape[0]
        acc = torch.zeros(nt, xf.shape[1], device=xf.device)
        if c_mx is None:
            mx = torch.full((nt,), _NEG, device=xf.device)
            den = torch.zeros(nt, device=xf.device)
        else:
            mx, den = c_mx[t0:t0 + bt], c_den[t0:t0 + bt]
        for s0 in range(0, phi.shape[1], bs):
            lg = _logits(xt, rt, phi[:, s0:s0 + bs])  # (nt, ns)
            if c_mx is None:
                m_new = torch.maximum(mx, lg.amax(1))
                corr = torch.exp(mx - m_new)
                p = torch.exp(lg - m_new[:, None])
                den = den * corr + p.sum(1)
                acc = acc * corr[:, None] + p @ ysf[s0:s0 + bs]
                mx = m_new
            else:  # exact weights from the saved stats: no rescale
                acc = acc + torch.exp(lg - mx[:, None]) @ ysf[s0:s0 + bs]
        ys.append(acc / den[:, None])
        mxs.append(mx)
        dens.append(den)
    return torch.cat(ys), torch.cat(mxs), torch.cat(dens)


def combine_apply_ref(x, phi_n, ys, c_stats,
                      cfg: Optional[KernelConfig] = None):
    """Plain version of K2: y (b, m, d) in x's dtype from K1's per-token
    (c_mx, c_den) (b, m)."""
    b, m, d, s = _shapes(x, phi_n, ys)
    cfg = _resolve(cfg, m, d, s)
    phi = phi_n.float()
    c_mx, c_den = (t.float() for t in c_stats)
    rows = [_combine_row(x[i].float(), phi, ys[i].float(), cfg.block_tokens,
                         cfg.block_slots, c_mx[i], c_den[i])[0]
            for i in range(b)]
    return torch.stack(rows).to(x.dtype)


def combine_online_ref(x, phi_n, ys, cfg: Optional[KernelConfig] = None):
    """Plain version of K3: ``(y (b, m, d), (c_mx, c_den) (b, m))``."""
    b, m, d, s = _shapes(x, phi_n, ys)
    cfg = _resolve(cfg, m, d, s)
    phi = phi_n.float()
    rows = [_combine_row(x[i].float(), phi, ys[i].float(), cfg.block_tokens,
                         cfg.block_slots) for i in range(b)]
    y, cmx, cden = (torch.stack(t) for t in zip(*rows))
    return y.to(x.dtype), (cmx, cden)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _refuse_grad(*tensors):
    """The kernels have no backward yet: refuse inputs that need one,
    rather than return an output that silently has no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the Soft-MoE CUDA kernels have no backward yet (K4/K5 come "
            "with the training slice): call them under torch.no_grad() or "
            "torch.inference_mode(), or on CPU tensors")


def _check_cuda(cfg: KernelConfig, x, phi_n, ys=None, stats=()):
    """Raise on what the kernels do not take; they launch on x's device."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    named = {"x": x, "phi_n": phi_n}
    if ys is not None:
        named["ys"] = ys
    named.update({f"stats[{i}]": t for i, t in enumerate(stats)})
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if ys is not None and ys.dtype != x.dtype:
        raise TypeError(f"ys dtype {ys.dtype} != x dtype {x.dtype}")
    for name, t in named.items():
        if name != "x" and name != "ys" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    d = x.shape[-1]
    if d % 8:
        raise ValueError(f"d={d} is not a multiple of 8: the kernels load "
                         f"x and ys rows in vectors of 4 (16-byte aligned)")
    for name in ("x", "ys"):
        if name in named and named[name].data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    for name, blk in (("block_tokens", cfg.block_tokens),
                      ("block_slots", cfg.block_slots)):
        if not 1 <= blk <= SOFT_MOE_TILE:
            raise ValueError(f"{name}={blk}: the kernels take blocks of "
                             f"1..{SOFT_MOE_TILE}")
    if cfg.acc_dtype != "float32":
        raise ValueError(f"acc_dtype {cfg.acc_dtype!r}: the kernels "
                         f"accumulate in float32")
    if x.shape[0] > 65535:
        raise ValueError(f"batch {x.shape[0]} > 65535 (grid z limit)")


def _launcher(lib: str, fn_name: str, n_ptr: int, n_int: int):
    from .build import load

    fn = getattr(load(lib), fn_name)
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
    return fn


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def routing_fwd(x, phi_n, cfg: Optional[KernelConfig] = None):
    """K1: x (b, m, d) f32 or bf16; phi_n (d, S) f32 pre-normalized.

    Returns ``(slots (b, S, d), (d_mx, d_den) (b, S), (c_mx, c_den)
    (b, m))`` from one logits pass. CPU tensors run ``routing_fwd_ref``;
    CUDA tensors launch the kernel on the current stream or raise."""
    b, m, d, s = _shapes(x, phi_n)
    cfg = _resolve(cfg, m, d, s)
    if x.device.type == "cpu":
        return routing_fwd_ref(x, phi_n, cfg)
    _refuse_grad(x, phi_n)
    _check_cuda(cfg, x, phi_n)
    nsb = -(-s // cfg.block_slots)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    slots = torch.empty((b, s, d), dtype=x.dtype, device=dev)
    d_mx, d_den = torch.empty((b, s), **f32), torch.empty((b, s), **f32)
    c_mx, c_den = torch.empty((b, m), **f32), torch.empty((b, m), **f32)
    rn = torch.empty((b, m), **f32)
    part_mx = torch.empty((b, nsb, m), **f32)
    part_den = torch.empty((b, nsb, m), **f32)
    fn = _launcher("soft_moe_routing", "soft_moe_routing_launch", 10, 8)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), phi_n.data_ptr(), slots.data_ptr(),
                 d_mx.data_ptr(), d_den.data_ptr(), c_mx.data_ptr(),
                 c_den.data_ptr(), rn.data_ptr(), part_mx.data_ptr(),
                 part_den.data_ptr(), _DTYPE_CODE[x.dtype], b, m, d, s,
                 cfg.block_tokens, cfg.block_slots, d_chunk(d),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"soft_moe_routing launch failed: cudaError {err}")
    routing_fwd.launches += 1
    return slots, (d_mx, d_den), (c_mx, c_den)


routing_fwd.launches = 0


def _combine_cuda(x, phi_n, ys, c_stats, cfg):
    b, m, d, s = x.shape[0], x.shape[1], x.shape[2], phi_n.shape[1]
    online = c_stats is None
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    if online:
        c_mx, c_den = torch.empty((b, m), **f32), torch.empty((b, m), **f32)
    else:
        c_mx, c_den = c_stats
    y = torch.empty((b, m, d), dtype=x.dtype, device=dev)
    rn = torch.empty((b, m), **f32)
    fn = _launcher("soft_moe_combine", "soft_moe_combine_launch", 7, 9)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), phi_n.data_ptr(), ys.data_ptr(),
                 c_mx.data_ptr(), c_den.data_ptr(), y.data_ptr(),
                 rn.data_ptr(), int(online), _DTYPE_CODE[x.dtype], b, m, d,
                 s, cfg.block_tokens, cfg.block_slots, d_chunk(d),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"soft_moe_combine launch failed: cudaError {err}")
    return y, (c_mx, c_den)


def combine_apply(x, phi_n, ys, c_stats, cfg: Optional[KernelConfig] = None):
    """K2: y = C Ys (b, m, d) in x's dtype, with C from K1's per-token
    ``c_stats = (c_mx, c_den)``, each (b, m) f32. CPU tensors run
    ``combine_apply_ref``; CUDA tensors launch the kernel or raise."""
    b, m, d, s = _shapes(x, phi_n, ys)
    cfg = _resolve(cfg, m, d, s)
    for t in c_stats:
        if tuple(t.shape) != (b, m):
            raise ValueError(f"c_stats {tuple(t.shape)} != {(b, m)}")
    if x.device.type == "cpu":
        return combine_apply_ref(x, phi_n, ys, c_stats, cfg)
    _refuse_grad(x, phi_n, ys, *c_stats)
    _check_cuda(cfg, x, phi_n, ys, tuple(c_stats))
    y = _combine_cuda(x, phi_n, ys, tuple(c_stats), cfg)[0]
    combine_apply.launches += 1
    return y


combine_apply.launches = 0


def combine_online(x, phi_n, ys, cfg: Optional[KernelConfig] = None):
    """K3: ``(y (b, m, d), (c_mx, c_den) (b, m))`` with an online softmax
    over slots. CPU tensors run ``combine_online_ref``; CUDA tensors
    launch the kernel or raise."""
    b, m, d, s = _shapes(x, phi_n, ys)
    cfg = _resolve(cfg, m, d, s)
    if x.device.type == "cpu":
        return combine_online_ref(x, phi_n, ys, cfg)
    _refuse_grad(x, phi_n, ys)
    _check_cuda(cfg, x, phi_n, ys)
    out = _combine_cuda(x, phi_n, ys, None, cfg)
    combine_online.launches += 1
    return out


combine_online.launches = 0


# ---------------------------------------------------------------------------
# single-sequence wrappers (2-D in, 2-D out)
# ---------------------------------------------------------------------------


def _cfg_2d(bt: int, bs: int) -> KernelConfig:
    return KernelConfig(block_tokens=bt, block_slots=bs)


def dispatch_2d(x, phi_n, *, bt: int = SOFT_MOE_TILE,
                bs: int = SOFT_MOE_TILE):
    """x: (m, d); phi_n: (d, S) pre-normalized -> slots (S, d), on K1."""
    return routing_fwd(x[None], phi_n, _cfg_2d(bt, bs))[0][0]


def combine_2d(x, phi_n, ys, *, bt: int = SOFT_MOE_TILE,
               bs: int = SOFT_MOE_TILE):
    """x: (m, d); phi_n: (d, S); ys: (S, d) expert outputs -> y (m, d), on
    K3."""
    return combine_online(x[None], phi_n, ys[None], _cfg_2d(bt, bs))[0][0]
