"""Soft-MoE routing and combine, forward and backward: the CUDA kernels'
wrappers and their plain versions, counterpart of
``repro/kernels/soft_moe_kernels.py`` (Pallas kernels for the TPU).

- K1 ``routing_fwd`` (``csrc/soft_moe_routing.cu``; replaces
  ``routing_fwd_pallas``): one logits pass ``l2norm(X) . Phi_n`` gives the
  dispatched slots (b, S, d), the dispatch stats (b, S) and the combine
  stats (b, m).
- K2 ``combine_apply`` (``csrc/soft_moe_combine.cu``; replaces
  ``combine_apply_pallas``): ``Y = C Ys`` with C from K1's saved stats.
- K3 ``combine_online`` (same source and body; replaces
  ``combine_online_pallas``): the combine with an online softmax over
  128-slot tiles, which also returns (c_mx, c_den).
- K4 ``dispatch_bwd`` (``csrc/soft_moe_dispatch_bwd.cu``; replaces
  ``dispatch_bwd_pallas``): dX and dPhi_n from the slots' gradient, with
  the dispatch weights recomputed from K1's saved stats.
- K5 ``combine_bwd`` (``csrc/soft_moe_combine_bwd.cu``; replaces
  ``combine_bwd_pallas``): dX, dPhi_n and dYs from the output's gradient,
  with the combine weights recomputed from the saved per-token stats.
- K6 ``routing_health`` (``csrc/soft_moe_routing_health.cu``; replaces
  ``routing_health_pallas``): the paper's Fig. 9 routing-health
  reductions (per-slot dispatch entropy and combine importance, per-token
  combine entropy and dispatch mass) from K1's saved stats, for telemetry.
- ``dispatch_2d`` / ``combine_2d``: single-sequence wrappers on K1 / K3
  (``dispatch_pallas`` / ``combine_pallas`` in the JAX package).

The kernels are written for Hopper (``sm_90a``), built with ``nvcc`` at
first use and called through ctypes; each source's header says what
bounds it and how it is laid out. Each wrapper runs its plain version
(``*_ref``) for CPU tensors and, for CUDA tensors, launches its kernel
or raises: there is no fallback. ``<wrapper>.launches`` counts kernel
launches (never plain runs); each call, plain or not, is the span
``soft_moe/<wrapper>`` (``repro_torch.tracing``). A raw kernel has no
backward of its own: a CUDA wrapper refuses inputs that would need a
gradient, and the differentiable entry points are the
``torch.autograd.Function``s of ``kernels/ops.py``, whose backward calls
K4 and K5.

The plain versions repeat the kernels' tile recurrences in PyTorch, with
``block_tokens`` / ``block_slots`` from the ``KernelConfig``, so the CPU
tests can pin them to the JAX kernels' tiling. Each batch row runs on its
own, so row i of a batch equals that row run alone, bitwise; dPhi_n, the
one output that sums over rows, is the sum of the rows' own partials in
row order, as the CUDA kernels form it. K1 takes each chunk's dispatch
softmax on its own (chunks of ``tuning.routing_chunk`` tokens) and
merges the chunks in chunk order, and the slot blocks' combine partials
in slot-block order, as its kernel does. K3 carries its online
(max, denom) over the kernel's 128-slot tiles, not over ``block_slots``.
K6 takes each row's tokens in K2's chunks and 128-slot tiles and sums
the chunks' per-slot partials in chunk order, as its kernel does; K4 and
K5 do the same for dPhi_n and dYs with chunks of ``BWD_TILES`` token
blocks, and a row's dPhi_n is the sum of its chunks' partials in chunk
order.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..tracing import span
from .recording import kernel_op
from .tuning import (
    BWD_TILES,
    SOFT_MOE_TILE,
    KernelConfig,
    combine_chunk,
    default_config,
    routing_chunk,
)

_NEG = -1e30
_EPS = 1e-6  # must match ref.l2_normalize
_SLOT_TILE = 128  # slots one CUDA block of K2-K5 holds at a time
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


def _routing_row(xf, phi, bs, ct):
    """K1's recurrence for one row: xf (m, d) f32, phi (d, S) f32, slot
    blocks of bs, token chunks of ct."""
    m = xf.shape[0]
    rn = _inv_norm(xf)
    slots, dmx, dden, parts = [], [], [], []
    for s0 in range(0, phi.shape[1], bs):  # a CUDA block per (chunk, s0)
        lg = _logits(xf, rn, phi[:, s0:s0 + bs])  # (m, ns)
        # combine direction: this slot block's partial per token
        pm = lg.amax(1)
        parts.append((pm, torch.exp(lg - pm[:, None]).sum(1)))
        # dispatch direction: each chunk's softmax over its tokens
        chunks = []
        for t0 in range(0, m, ct):
            lc = lg[t0:t0 + ct]
            mx = lc.amax(0)
            p = torch.exp(lc - mx)
            chunks.append((mx, p.sum(0), p.T @ xf[t0:t0 + ct]))
        # the chunks merged in chunk order
        mx = torch.stack([c[0] for c in chunks]).amax(0)
        den = torch.zeros_like(mx)
        acc = torch.zeros_like(chunks[0][2])
        for c_mx, c_den, c_acc in chunks:
            w = torch.exp(c_mx - mx)
            den = den + c_den * w
            acc = acc + c_acc * w[:, None]
        slots.append(acc / den[:, None])
        dmx.append(mx)
        dden.append(den)
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
    ct = routing_chunk(m, s, cfg.block_tokens)
    rows = [_routing_row(x[i].float(), phi, cfg.block_slots, ct)
            for i in range(b)]
    slots, dmx, dden, cmx, cden = (torch.stack(t) for t in zip(*rows))
    return slots.to(x.dtype), (dmx, dden), (cmx, cden)


def _combine_row(xf, phi, ysf, bt, bs, c_mx=None, c_den=None):
    """K2's (stats given: C normalised before the product) or K3's
    (online: per slot tile of bs, the running max, rescale and denominator
    of csrc/soft_moe_combine.cu, y / den at the end) recurrence for one
    row, in token blocks of bt."""
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
                c_w = torch.exp(lg - mx[:, None]) / den[:, None]
                acc = acc + c_w @ ysf[s0:s0 + bs]
        ys.append(acc if c_mx is not None else acc / den[:, None])
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
    """Plain version of K3: ``(y (b, m, d), (c_mx, c_den) (b, m))``, the
    kernel's chunks of ``combine_chunk(block_tokens)`` tokens and its
    online softmax over 128-slot tiles (one tile, no rescale, for S <=
    128)."""
    b, m, d, s = _shapes(x, phi_n, ys)
    cfg = _resolve(cfg, m, d, s)
    phi = phi_n.float()
    ct = combine_chunk(cfg.block_tokens)
    rows = [_combine_row(x[i].float(), phi, ys[i].float(), ct, _SLOT_TILE)
            for i in range(b)]
    y, cmx, cden = (torch.stack(t) for t in zip(*rows))
    return y.to(x.dtype), (cmx, cden)


def _l2n_bwd(xf, rn, dxn):
    """VJP of the L2 norm at raw tokens xf (n, d) f32, given d(l2norm x)
    (n, d) and rn = 1 / (||x|| + eps), as the TPU kernels' ``_l2n_bwd``."""
    n = torch.sqrt((xf * xf).sum(-1))
    inv_n = torch.where(n > 0, 1.0 / torch.clamp(n, min=_EPS),
                        torch.zeros_like(n))
    proj = (xf * dxn).sum(-1)
    return rn[:, None] * dxn - (rn * rn * inv_n * proj)[:, None] * xf


def _row_sum(parts):
    """Partials summed in order from 0, as the kernels' second pass sums
    them: a row's chunks in chunk order, then the rows in row order."""
    acc = torch.zeros_like(parts[0])
    for p in parts:
        acc = acc + p
    return acc


def _dispatch_bwd_row(xf, phi, gf, dmx, dden, sig, bt, bs):
    """K4's recurrences for one row: (dx (m, d), the row's dPhi_n total
    (d, S), its chunks' partials summed in chunk order)."""
    m, s = xf.shape[0], phi.shape[1]
    rn = _inv_norm(xf)

    def tile(t0, s0):
        xt, ph = xf[t0:t0 + bt], phi[:, s0:s0 + bs]
        d_w = torch.exp(_logits(xt, rn[t0:t0 + bt], ph)
                        - dmx[None, s0:s0 + bs]) / dden[None, s0:s0 + bs]
        g = gf[s0:s0 + bs]
        d_lg = d_w * (xt @ g.T - sig[None, s0:s0 + bs])
        return d_w, d_lg, g, ph

    dx = []
    for t0 in range(0, m, bt):  # token-major, slot blocks inner
        acc_raw = torch.zeros(min(bt, m - t0), xf.shape[1], device=xf.device)
        acc_n = torch.zeros_like(acc_raw)
        for s0 in range(0, s, bs):
            d_w, d_lg, g, ph = tile(t0, s0)
            acc_raw = acc_raw + d_w @ g
            acc_n = acc_n + d_lg @ ph.T
        dx.append(acc_raw + _l2n_bwd(xf[t0:t0 + bt], rn[t0:t0 + bt], acc_n))
    parts = []  # one dPhi_n partial per chunk of BWD_TILES token blocks
    for c0 in range(0, m, bt * BWD_TILES):
        dphi = []
        for s0 in range(0, s, bs):  # slot-major, token blocks inner
            acc_p = torch.zeros(xf.shape[1], min(bs, s - s0),
                                device=xf.device)
            for t0 in range(c0, min(c0 + bt * BWD_TILES, m), bt):
                d_lg = tile(t0, s0)[1]
                xn = xf[t0:t0 + bt] * rn[t0:t0 + bt, None]
                acc_p = acc_p + xn.T @ d_lg
            dphi.append(acc_p)
        parts.append(torch.cat(dphi, dim=1))
    # the second pass: the row's chunks summed in chunk order
    return torch.cat(dx), _row_sum(parts)


def _check_shapes(*named):
    """Raise on any (name, tensor, expected shape) that does not match."""
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape}")


def dispatch_bwd_ref(x, phi_n, g_slots, d_stats, slots,
                     cfg: Optional[KernelConfig] = None):
    """Plain version of K4: ``(dx (b, m, d) in x's dtype, dphi_n (d, S) in
    phi_n's dtype)`` from the slots' gradient g_slots (b, S, d), the
    forward's slots (b, S, d) and its per-slot (d_mx, d_den) (b, S)."""
    b, m, d, s = _shapes(x, phi_n, g_slots)
    _check_shapes(("slots", slots, (b, s, d)),
               ("d_stats[0]", d_stats[0], (b, s)),
               ("d_stats[1]", d_stats[1], (b, s)))
    cfg = _resolve(cfg, m, d, s)
    phi = phi_n.float()
    dmx, dden = (t.float() for t in d_stats)
    # sigma_s = g_s . slots_s: the softmax-VJP row term (the CUDA
    # kernel's pre-pass; outside the TPU kernel, in its wrapper)
    sigma = (g_slots.float() * slots.float()).sum(-1)
    if not b:
        return torch.zeros_like(x), torch.zeros_like(phi_n)
    rows = [_dispatch_bwd_row(x[i].float(), phi, g_slots[i].float(), dmx[i],
                              dden[i], sigma[i], cfg.block_tokens,
                              cfg.block_slots) for i in range(b)]
    dx = torch.stack([r[0] for r in rows])
    dphi = _row_sum([r[1] for r in rows])
    return dx.to(x.dtype), dphi.to(phi_n.dtype)


def _combine_bwd_row(xf, phi, ysf, gf, cmx, cden, rho, bt, bs):
    """K5's recurrences for one row: (dx (m, d), the row's dPhi_n total
    (d, S), dys (S, d)), dPhi_n and dys each its chunks' partials summed
    in chunk order."""
    m, s = xf.shape[0], phi.shape[1]
    rn = _inv_norm(xf)

    def tile(t0, s0):
        xt, ph = xf[t0:t0 + bt], phi[:, s0:s0 + bs]
        c_w = torch.exp(_logits(xt, rn[t0:t0 + bt], ph)
                        - cmx[t0:t0 + bt, None]) / cden[t0:t0 + bt, None]
        g = gf[t0:t0 + bt]
        d_lg = c_w * (g @ ysf[s0:s0 + bs].T - rho[t0:t0 + bt, None])
        return c_w, d_lg, g, ph

    dx = []
    for t0 in range(0, m, bt):  # token-major, slot blocks inner
        acc_n = torch.zeros(min(bt, m - t0), xf.shape[1], device=xf.device)
        for s0 in range(0, s, bs):
            _, d_lg, _, ph = tile(t0, s0)
            acc_n = acc_n + d_lg @ ph.T
        dx.append(_l2n_bwd(xf[t0:t0 + bt], rn[t0:t0 + bt], acc_n))
    p_dys, p_dphi = [], []  # partials per chunk of BWD_TILES token blocks
    for c0 in range(0, m, bt * BWD_TILES):
        dys, dphi = [], []
        for s0 in range(0, s, bs):  # slot-major, token blocks inner
            ns = min(bs, s - s0)
            acc_y = torch.zeros(ns, xf.shape[1], device=xf.device)
            acc_p = torch.zeros(xf.shape[1], ns, device=xf.device)
            for t0 in range(c0, min(c0 + bt * BWD_TILES, m), bt):
                c_w, d_lg, g, _ = tile(t0, s0)
                acc_y = acc_y + c_w.T @ g
                xn = xf[t0:t0 + bt] * rn[t0:t0 + bt, None]
                acc_p = acc_p + xn.T @ d_lg
            dys.append(acc_y)
            dphi.append(acc_p)
        p_dys.append(torch.cat(dys))
        p_dphi.append(torch.cat(dphi, dim=1))
    # the second pass: the row's chunks summed in chunk order
    return torch.cat(dx), _row_sum(p_dphi), _row_sum(p_dys)


def combine_bwd_ref(x, phi_n, ys, g, c_stats, y,
                    cfg: Optional[KernelConfig] = None):
    """Plain version of K5: ``(dx (b, m, d) in x's dtype, dphi_n (d, S) in
    phi_n's dtype, dys (b, S, d) in ys' dtype)`` from the output's
    gradient g (b, m, d), the forward's output y (b, m, d) and the
    per-token (c_mx, c_den) (b, m)."""
    b, m, d, s = _shapes(x, phi_n, ys)
    _check_shapes(("g", g, (b, m, d)), ("y", y, (b, m, d)),
               ("c_stats[0]", c_stats[0], (b, m)),
               ("c_stats[1]", c_stats[1], (b, m)))
    cfg = _resolve(cfg, m, d, s)
    phi = phi_n.float()
    cmx, cden = (t.float() for t in c_stats)
    # rho_t = g_t . y_t: the softmax-VJP row term (the CUDA kernel's
    # pre-pass; outside the TPU kernel, in its wrapper)
    rho = (g.float() * y.float()).sum(-1)
    rows = [_combine_bwd_row(x[i].float(), phi, ys[i].float(), g[i].float(),
                             cmx[i], cden[i], rho[i], cfg.block_tokens,
                             cfg.block_slots) for i in range(b)]
    if not b:
        return (torch.zeros_like(x), torch.zeros_like(phi_n),
                torch.zeros_like(ys))
    dx, dys = (torch.stack([r[k] for r in rows]) for k in (0, 2))
    dphi = _row_sum([r[1] for r in rows])
    return dx.to(x.dtype), dphi.to(phi_n.dtype), dys.to(ys.dtype)


def _health_row(xf, phi, dmx, dden, cmx, cden, ct):
    """K6's recurrences for one row, in the kernel's order: token chunks
    of ct, 128-slot tiles inside a chunk with each token's sums carried
    across them in order, the chunks' per-slot sums added in chunk order.
    Pad tokens and pad slots are never formed: the TPU kernel's -1e30
    mask makes their terms exactly zero. Returns (disp_entropy (S,),
    importance (S,), comb_entropy (m,), token_contrib (m,))."""
    m, s = xf.shape[0], phi.shape[1]
    rn = _inv_norm(xf)
    ln_dden, ln_cden = torch.log(dden), torch.log(cden)
    dent_parts, imp_parts, cent, contrib = [], [], [], []
    for t0 in range(0, m, ct):  # one CTA per (chunk, row)
        tk = slice(t0, t0 + ct)
        xt, rt = xf[tk], rn[tk]
        cent_c = torch.zeros(xt.shape[0], device=xf.device)
        contrib_c = torch.zeros_like(cent_c)
        dent_c, imp_c = [], []
        for s0 in range(0, s, _SLOT_TILE):
            sl = slice(s0, s0 + _SLOT_TILE)
            lg = _logits(xt, rt, phi[:, sl])  # (nt, ns)
            # the w log w terms from the shifted logits: no log of a weight
            ln_d = lg - dmx[None, sl] - ln_dden[None, sl]
            ln_c = lg - cmx[tk, None] - ln_cden[tk, None]
            d_w, c_w = torch.exp(ln_d), torch.exp(ln_c)
            cent_c = cent_c - (c_w * ln_c).sum(1)
            contrib_c = contrib_c + d_w.sum(1)
            dent_c.append(-(d_w * ln_d).sum(0))
            imp_c.append(c_w.sum(0))
        cent.append(cent_c)
        contrib.append(contrib_c)
        dent_parts.append(torch.cat(dent_c))
        imp_parts.append(torch.cat(imp_c))
    # the second pass: the chunks' partials summed in chunk order
    return (_row_sum(dent_parts), _row_sum(imp_parts), torch.cat(cent),
            torch.cat(contrib))


def _health_shapes(x, phi_n, d_stats, c_stats):
    b, m, d, s = _shapes(x, phi_n)
    _check_shapes(("d_stats[0]", d_stats[0], (b, s)),
                  ("d_stats[1]", d_stats[1], (b, s)),
                  ("c_stats[0]", c_stats[0], (b, m)),
                  ("c_stats[1]", c_stats[1], (b, m)))
    return b, m, d, s


def routing_health_ref(x, phi_n, d_stats, c_stats,
                       cfg: Optional[KernelConfig] = None):
    """Plain version of K6: ``(disp_entropy (b, S), importance (b, S),
    comb_entropy (b, m), token_contrib (b, m))`` in f32 from K1's per-slot
    ``d_stats`` and per-token ``c_stats`` (each a (max, denom) pair), in
    the kernel's chunks of ``combine_chunk(block_tokens)`` tokens and
    128-slot tiles."""
    b, m, d, s = _health_shapes(x, phi_n, d_stats, c_stats)
    cfg = _resolve(cfg, m, d, s)
    phi = phi_n.float()
    dmx, dden = (t.float() for t in d_stats)
    cmx, cden = (t.float() for t in c_stats)
    ct = combine_chunk(cfg.block_tokens)
    rows = [_health_row(x[i].float(), phi, dmx[i], dden[i], cmx[i], cden[i],
                        ct) for i in range(b)]
    if not b:
        f32 = dict(dtype=torch.float32, device=x.device)
        return (torch.zeros((0, s), **f32), torch.zeros((0, s), **f32),
                torch.zeros((0, m), **f32), torch.zeros((0, m), **f32))
    return tuple(torch.stack(t) for t in zip(*rows))


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------


def _refuse_grad(*tensors):
    """A raw kernel has no backward: refuse inputs that need one, rather
    than return an output that silently has no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "a raw Soft-MoE CUDA kernel has no backward: differentiate "
            "through the autograd Functions of kernels/ops.py "
            "(soft_moe_routing, soft_moe_combine; routing_health carries no "
            "gradient), or call the kernel under "
            "torch.no_grad() or torch.inference_mode()")


def _check_cuda(cfg: KernelConfig, x, phi_n, rows=None, stats=()):
    """Raise on what the kernels do not take; they launch on x's device.
    ``rows``: {name: tensor} of (., ., d) operands in x's dtype (ys, the
    gradients), which the kernels also load in 16-byte vectors."""
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    rows = dict(rows or {})
    named = {"x": x, "phi_n": phi_n, **rows}
    named.update({f"stats[{i}]": t for i, t in enumerate(stats)})
    for name, t in named.items():
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    for name, t in rows.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != x dtype {x.dtype}")
    for name, t in named.items():
        if name != "x" and name not in rows and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    d = x.shape[-1]
    if d % 8:
        raise ValueError(f"d={d} is not a multiple of 8: the kernels load "
                         f"x and ys rows in vectors of 4 (16-byte aligned)")
    for name in ("x", *rows):
        if named[name].data_ptr() % 16:
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


@kernel_op("routing_fwd")
@span("soft_moe/routing_fwd")
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
    ct = routing_chunk(m, s, cfg.block_tokens)
    nch, nsb = -(-m // ct), -(-s // cfg.block_slots)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    slots = torch.empty((b, s, d), dtype=x.dtype, device=dev)
    d_mx, d_den = torch.empty((b, s), **f32), torch.empty((b, s), **f32)
    c_mx, c_den = torch.empty((b, m), **f32), torch.empty((b, m), **f32)
    rn = torch.empty((b, m), **f32)
    # the second pass's scratch, where a row has several slot blocks (the
    # combine partials) or several chunks (the slot partials)
    none = torch.empty(0, **f32)
    c_part = [torch.empty((b, nsb, m), **f32) if nsb > 1 else none
              for _ in range(2)]
    s_part = torch.empty((b, nch, s, d), **f32) if nch > 1 else none
    s_stats = [torch.empty((b, nch, s), **f32) if nch > 1 else none
               for _ in range(2)]
    fn = _launcher("soft_moe_routing", "soft_moe_routing_launch", 13, 7)
    with torch.cuda.device(dev):
        err = fn(x.data_ptr(), phi_n.data_ptr(), slots.data_ptr(),
                 d_mx.data_ptr(), d_den.data_ptr(), c_mx.data_ptr(),
                 c_den.data_ptr(), rn.data_ptr(), c_part[0].data_ptr(),
                 c_part[1].data_ptr(), s_part.data_ptr(),
                 s_stats[0].data_ptr(), s_stats[1].data_ptr(),
                 _DTYPE_CODE[x.dtype], b, m, d, s, ct, cfg.block_slots,
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"soft_moe_routing launch failed: cudaError {err}")
    routing_fwd.launches += 1
    return slots, (d_mx, d_den), (c_mx, c_den)


routing_fwd.launches = 0


def _combine_cuda(x, phi_n, ys, c_stats, cfg):
    """K2 (``c_stats`` given) or K3 (``c_stats`` None: the kernel writes
    them and the call returns ``(y, c_stats)``); one body, one signature."""
    b, m, d = x.shape
    s = phi_n.shape[1]
    f32 = dict(dtype=torch.float32, device=x.device)
    online = c_stats is None
    if online:
        c_stats = (torch.empty((b, m), **f32), torch.empty((b, m), **f32))
    y = torch.empty_like(x)
    rn = torch.empty((b, m), **f32)
    y_acc = torch.empty((b, m, d), **f32) if s > _SLOT_TILE else None
    entry = ("soft_moe_combine_online_launch" if online
             else "soft_moe_combine_apply_launch")
    fn = _launcher("soft_moe_combine", entry, 8, 6)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), phi_n.data_ptr(), ys.data_ptr(),
                 c_stats[0].data_ptr(), c_stats[1].data_ptr(), y.data_ptr(),
                 rn.data_ptr(), 0 if y_acc is None else y_acc.data_ptr(),
                 _DTYPE_CODE[x.dtype], b, m, d, s,
                 combine_chunk(cfg.block_tokens), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"soft_moe_combine launch failed: cudaError {err}")
    return (y, c_stats) if online else y


@kernel_op("combine_apply")
@span("soft_moe/combine_apply")
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
    _check_cuda(cfg, x, phi_n, {"ys": ys}, tuple(c_stats))
    y = _combine_cuda(x, phi_n, ys, tuple(c_stats), cfg)
    combine_apply.launches += 1
    return y


combine_apply.launches = 0


@kernel_op("combine_online")
@span("soft_moe/combine_online")
def combine_online(x, phi_n, ys, cfg: Optional[KernelConfig] = None):
    """K3: ``(y (b, m, d), (c_mx, c_den) (b, m))`` with an online softmax
    over 128-slot tiles. CPU tensors run ``combine_online_ref``; CUDA
    tensors launch the kernel or raise."""
    b, m, d, s = _shapes(x, phi_n, ys)
    cfg = _resolve(cfg, m, d, s)
    if x.device.type == "cpu":
        return combine_online_ref(x, phi_n, ys, cfg)
    _refuse_grad(x, phi_n, ys)
    _check_cuda(cfg, x, phi_n, {"ys": ys})
    out = _combine_cuda(x, phi_n, ys, None, cfg)
    combine_online.launches += 1
    return out


combine_online.launches = 0


def _bwd_scratch(b, m, d, s, cfg, dev, n_dots, n_parts):
    """The backward kernels' scratch: rn and inv_n (b, m), the pre-pass's
    ``n_dots`` softmax-VJP row terms (sigma or rho), ``n_parts``
    chunk-partial buffers (b, n_chunks, S, d) f32, and dX's f32
    accumulator (b, m, d) when S spans more than one 128-slot tile of the
    kernel (else None)."""
    f32 = dict(dtype=torch.float32, device=dev)
    nch = -(-m // (cfg.block_tokens * BWD_TILES))
    parts = [torch.empty((b, nch, s, d), **f32) for _ in range(n_parts)]
    dx_acc = torch.empty((b, m, d), **f32) if s > _SLOT_TILE else None
    return (torch.empty((b, m), **f32), torch.empty((b, m), **f32),
            torch.empty(n_dots, **f32), parts, dx_acc)


def _dispatch_bwd_cuda(x, phi_n, g_slots, d_stats, slots, cfg):
    b, m, d = x.shape
    s = phi_n.shape[1]
    dx = torch.empty_like(x)
    dphi = torch.empty((d, s), dtype=torch.float32, device=x.device)
    rn, inv_n, sigma, (part,), dx_acc = _bwd_scratch(b, m, d, s, cfg,
                                                     x.device, (b, s), 1)
    fn = _launcher("soft_moe_dispatch_bwd", "soft_moe_dispatch_bwd_launch",
                   13, 6)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), phi_n.data_ptr(), g_slots.data_ptr(),
                 slots.data_ptr(), d_stats[0].data_ptr(),
                 d_stats[1].data_ptr(), dx.data_ptr(), dphi.data_ptr(),
                 rn.data_ptr(), inv_n.data_ptr(), sigma.data_ptr(),
                 0 if dx_acc is None else dx_acc.data_ptr(), part.data_ptr(),
                 _DTYPE_CODE[x.dtype], b, m, d, s,
                 cfg.block_tokens * BWD_TILES, _stream(x.device))
    if err != 0:
        raise RuntimeError(
            f"soft_moe_dispatch_bwd launch failed: cudaError {err}")
    return dx, dphi


@kernel_op("dispatch_bwd")
@span("soft_moe/dispatch_bwd")
def dispatch_bwd(x, phi_n, g_slots, d_stats, slots,
                 cfg: Optional[KernelConfig] = None):
    """K4: ``(dx (b, m, d) in x's dtype, dphi_n (d, S) f32)``, the
    gradients of K1's slots through x and phi_n, given the slots' gradient
    g_slots (b, S, d) and the forward's slots (b, S, d) and per-slot
    ``d_stats = (d_mx, d_den)`` (b, S) f32. CPU tensors run
    ``dispatch_bwd_ref``; CUDA tensors launch the kernel on the current
    stream or raise."""
    b, m, d, s = _shapes(x, phi_n, g_slots)
    _check_shapes(("slots", slots, (b, s, d)),
                  ("d_stats[0]", d_stats[0], (b, s)),
                  ("d_stats[1]", d_stats[1], (b, s)))
    cfg = _resolve(cfg, m, d, s)
    if x.device.type == "cpu":
        return dispatch_bwd_ref(x, phi_n, g_slots, d_stats, slots, cfg)
    _refuse_grad(x, phi_n, g_slots, slots, *d_stats)
    _check_cuda(cfg, x, phi_n, {"g_slots": g_slots, "slots": slots},
                tuple(d_stats))
    out = _dispatch_bwd_cuda(x, phi_n, g_slots, d_stats, slots, cfg)
    dispatch_bwd.launches += 1
    return out


dispatch_bwd.launches = 0


def _combine_bwd_cuda(x, phi_n, ys, g, c_stats, y, cfg):
    b, m, d = x.shape
    s = phi_n.shape[1]
    dx, dys = torch.empty_like(x), torch.empty_like(ys)
    dphi = torch.empty((d, s), dtype=torch.float32, device=x.device)
    rn, inv_n, rho, (p_phi, p_ys), dx_acc = _bwd_scratch(
        b, m, d, s, cfg, x.device, (b, m), 2)
    fn = _launcher("soft_moe_combine_bwd", "soft_moe_combine_bwd_launch",
                   16, 6)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), phi_n.data_ptr(), ys.data_ptr(), g.data_ptr(),
                 y.data_ptr(), c_stats[0].data_ptr(), c_stats[1].data_ptr(),
                 dx.data_ptr(), dphi.data_ptr(), dys.data_ptr(),
                 rn.data_ptr(), inv_n.data_ptr(), rho.data_ptr(),
                 0 if dx_acc is None else dx_acc.data_ptr(),
                 p_phi.data_ptr(), p_ys.data_ptr(), _DTYPE_CODE[x.dtype], b,
                 m, d, s, cfg.block_tokens * BWD_TILES, _stream(x.device))
    if err != 0:
        raise RuntimeError(
            f"soft_moe_combine_bwd launch failed: cudaError {err}")
    return dx, dphi, dys


@kernel_op("combine_bwd")
@span("soft_moe/combine_bwd")
def combine_bwd(x, phi_n, ys, g, c_stats, y,
                cfg: Optional[KernelConfig] = None):
    """K5: ``(dx (b, m, d) in x's dtype, dphi_n (d, S) f32, dys (b, S, d)
    in ys' dtype)``, the gradients of the combine through x, phi_n and ys,
    given the output's gradient g (b, m, d), the forward's output y
    (b, m, d) and the per-token ``c_stats = (c_mx, c_den)`` (b, m) f32.
    CPU tensors run ``combine_bwd_ref``; CUDA tensors launch the kernel on
    the current stream or raise."""
    b, m, d, s = _shapes(x, phi_n, ys)
    _check_shapes(("g", g, (b, m, d)), ("y", y, (b, m, d)),
                  ("c_stats[0]", c_stats[0], (b, m)),
                  ("c_stats[1]", c_stats[1], (b, m)))
    cfg = _resolve(cfg, m, d, s)
    if x.device.type == "cpu":
        return combine_bwd_ref(x, phi_n, ys, g, c_stats, y, cfg)
    _refuse_grad(x, phi_n, ys, g, y, *c_stats)
    _check_cuda(cfg, x, phi_n, {"ys": ys, "g": g, "y": y}, tuple(c_stats))
    out = _combine_bwd_cuda(x, phi_n, ys, g, c_stats, y, cfg)
    combine_bwd.launches += 1
    return out


combine_bwd.launches = 0


@kernel_op("routing_health")
@span("soft_moe/routing_health")
def routing_health(x, phi_n, d_stats, c_stats,
                   cfg: Optional[KernelConfig] = None):
    """K6: ``(disp_entropy (b, S), importance (b, S), comb_entropy (b, m),
    token_contrib (b, m))`` f32, the Fig. 9 routing-health reductions of
    the dispatch and combine weights recomputed tile-wise from K1's saved
    ``d_stats = (d_mx, d_den)`` (b, S) and ``c_stats = (c_mx, c_den)``
    (b, m), each f32; x (b, m, d) f32 or bf16, phi_n (d, S) f32. CPU
    tensors run ``routing_health_ref``; CUDA tensors launch the kernel on
    the current stream or raise. Telemetry only: it has no gradient."""
    b, m, d, s = _health_shapes(x, phi_n, d_stats, c_stats)
    cfg = _resolve(cfg, m, d, s)
    if x.device.type == "cpu":
        return routing_health_ref(x, phi_n, d_stats, c_stats, cfg)
    _refuse_grad(x, phi_n, *d_stats, *c_stats)
    _check_cuda(cfg, x, phi_n, stats=tuple(d_stats) + tuple(c_stats))
    ct = combine_chunk(cfg.block_tokens)
    nch = -(-m // ct)
    f32 = dict(dtype=torch.float32, device=x.device)
    dent, imp = torch.empty((b, s), **f32), torch.empty((b, s), **f32)
    cent, contrib = torch.empty((b, m), **f32), torch.empty((b, m), **f32)
    rn = torch.empty((b, m), **f32)
    p_dent, p_imp = (torch.empty((b, nch, s), **f32) for _ in range(2))
    fn = _launcher("soft_moe_routing_health",
                   "soft_moe_routing_health_launch", 13, 6)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), phi_n.data_ptr(), d_stats[0].data_ptr(),
                 d_stats[1].data_ptr(), c_stats[0].data_ptr(),
                 c_stats[1].data_ptr(), dent.data_ptr(), imp.data_ptr(),
                 cent.data_ptr(), contrib.data_ptr(), rn.data_ptr(),
                 p_dent.data_ptr(), p_imp.data_ptr(),
                 _DTYPE_CODE[x.dtype], b, m, d, s, ct, _stream(x.device))
    if err != 0:
        raise RuntimeError(
            f"soft_moe_routing_health launch failed: cudaError {err}")
    routing_health.launches += 1
    return dent, imp, cent, contrib


routing_health.launches = 0


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
