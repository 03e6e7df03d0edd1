"""Mamba-2 (SSD, state-space duality), counterpart of
``repro/layers/ssm.py``.

Training and prefill use the chunked matmul form: the sequence is split
into chunks, the intra-chunk terms are dense masked einsums in f32, and
a Python loop over the chunks carries the state from one to the next
(the reference's ``lax.scan``). The decays, exponentials of segment sums
of dt * A, are formed in f64 and rounded once to f32, where the
reference forms them in f32 (see ``ssd_chunked``). Decode keeps a constant-size recurrent
state (B, heads, head_dim, state) and a causal-conv ring (B, W-1, C).
The reference runs all of it on XLA ops, with no Pallas kernel, so the
port runs stock torch ops.

A cache passed to ``ssm_apply`` is updated IN PLACE (conv ring in the
cache's dtype, state in f32), as the port's attention pools are; a
narrow view of one row (``cache[slot:slot + 1]``) updates that row.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import _mean_sq, lecun_init, resolve_device


def ssm_init(gen: torch.Generator, cfg):
    """Separate projections per role (z/x/B/C/dt), as in the reference;
    drawn from ``gen`` on its device in f32."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.num_heads(d)
    gn = s.ngroups * s.state_dim
    conv_ch = di + 2 * gn
    dev = gen.device
    return {
        "w_z": lecun_init(gen, (d, di), fan_in=d),
        "w_x": lecun_init(gen, (d, di), fan_in=d),
        "w_B": lecun_init(gen, (d, gn), fan_in=d),
        "w_C": lecun_init(gen, (d, gn), fan_in=d),
        "w_dt": lecun_init(gen, (d, nh), fan_in=d),
        "conv_w": lecun_init(gen, (s.conv_width, conv_ch),
                             fan_in=s.conv_width),
        "conv_b": torch.zeros(conv_ch, device=dev),
        # A in [-16, -1]
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "D": torch.ones(nh, device=dev),
        "dt_bias": torch.log(torch.expm1(
            torch.full((nh,), 1e-2, device=dev) * 100.0)),
        "norm_scale": torch.ones(di, device=dev),
        "w_out": lecun_init(gen, (di, d), fan_in=di),
    }


def _causal_conv(xbc, conv_w, conv_b, conv_state=None):
    """Depthwise causal conv1d over xbc (B,S,C) as a sum of W shifted
    slices in xbc's dtype, then SiLU. ``conv_state`` (B,W-1,C), the ring
    of the previous call, is prepended. Returns (out, new ring)."""
    w = conv_w.shape[0]
    dt = xbc.dtype
    if conv_state is None:
        pad = xbc.new_zeros((xbc.shape[0], w - 1, xbc.shape[2]))
    else:
        pad = conv_state.to(dt)
    full = torch.cat([pad, xbc], dim=1)  # (B, S+W-1, C)
    s = xbc.shape[1]
    out = sum(full[:, i:i + s] * conv_w[i].to(dt) for i in range(w))
    out = F.silu(out + conv_b.to(dt))
    new_state = full[:, full.shape[1] - (w - 1):] if w > 1 else pad[:, :0]
    return out, new_state


def _segsum(x):
    """out[..., i, j] = sum of x[..., k] for k in (j, i], -inf above the
    diagonal."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD scan in chunked matmul form.

    x: (b,s,h,dh); dt: (b,s,h) (after softplus); A: (h,) negative; B, C:
    (b,s,g,n). Returns (y (b,s,h,dh) f32, final state (b,h,dh,n) f32).
    A length that is not a multiple of ``chunk`` is padded with dt = 0
    tokens (decay 1, contribution 0), which leave y and the state as
    they are."""
    b, s, h, dh = x.shape
    g, n = B.shape[2], B.shape[3]
    orig_s = s
    if s % chunk:
        pad = -(-s // chunk) * chunk - s
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // chunk
    hpg = h // g  # heads per B/C group

    f32, f64 = torch.float32, torch.float64
    xc = (x * dt[..., None]).to(f32).reshape(b, nc, chunk, h, dh)
    dA = (dt.to(f32) * A.to(f32)).reshape(b, nc, chunk, h).to(f64)
    Bh = B.to(f32).reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
    Ch = C.to(f32).reshape(b, nc, chunk, g, n).repeat_interleave(hpg, dim=3)
    # The decays exp(sum of dA over a segment) are formed in f64 and
    # rounded once to f32; the products stay f32. In f32 (the reference)
    # the differences of the cumulative sums cancel (|sum| ~ 3e3 at
    # mamba2's width) and cost an entry near the diagonal ~1e-4 of its
    # relative accuracy, more than the layer's f32 products lose.
    dA_cs = torch.cumsum(dA, dim=2)  # (b,nc,l,h)

    # 1) intra-chunk (block-diagonal) term
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2))).to(f32)  # (b,nc,h,l,l)
    scores = torch.einsum("bclhn,bcthn->bchlt", Ch, Bh) * L
    y_diag = torch.einsum("bchlt,bcthd->bclhd", scores, xc)

    # 2) chunk states: sum_t exp(dA_cs[-1] - dA_cs[t]) B_t x_t^T
    decay = torch.exp(dA_cs[:, :, -1:, :] - dA_cs).to(f32)  # (b,nc,l,h)
    states = torch.einsum("bclhn,bclh,bclhd->bchdn", Bh, decay, xc)

    # 3) inter-chunk recurrence; each chunk reads the state entering it
    chunk_decay = torch.exp(dA_cs[:, :, -1, :]).to(f32)  # (b,nc,h)
    carry = (x.new_zeros((b, h, dh, n), dtype=f32) if initial_state is None
             else initial_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b,nc,h,dh,n)

    # 4) inter-chunk output: C_t . (decay to t . state in)
    state_decay = torch.exp(dA_cs).to(f32)  # (b,nc,l,h)
    y_off = torch.einsum("bclhn,bclh,bchdn->bclhd", Ch, state_decay,
                         prev_states)
    y = (y_diag + y_off).reshape(b, s, h, dh)[:, :orig_s]
    return y, carry


def ssd_decode_step(x, dt, A, B, C, state):
    """One-token recurrent update. x: (b,1,h,dh); dt: (b,1,h) f32; B, C:
    (b,1,g,n); state: (b,h,dh,n) or None. Returns (y (b,1,h,dh), new
    state), both f32."""
    b, _, h, dh = x.shape
    g, n = B.shape[2], B.shape[3]
    hpg = h // g
    f32 = torch.float32
    x0 = x[:, 0].to(f32)  # (b,h,dh)
    dt0 = dt[:, 0]  # (b,h)
    B0 = B[:, 0].to(f32).repeat_interleave(hpg, dim=1)  # (b,h,n)
    C0 = C[:, 0].to(f32).repeat_interleave(hpg, dim=1)
    decay = torch.exp(dt0 * A)  # (b,h)
    state = (x.new_zeros((b, h, dh, n), dtype=f32) if state is None
             else state.to(f32))
    new_state = state * decay[..., None, None] + torch.einsum(
        "bhd,bh,bhn->bhdn", x0, dt0, B0)
    y = torch.einsum("bhdn,bhn->bhd", new_state, C0)[:, None]
    return y, new_state


def ssm_apply(params, cfg, x, *, cache=None, mode: str = "train",
              positions=None):
    """The Mamba-2 block. cache: ``{"conv": (B,W-1,C), "state":
    (B,h,dh,n)}`` (updated in place) or None. Returns (out, cache).

    ``positions`` ((S,) or (B,S)) is read on cached paths only: tokens at
    position < 0 (chunked-prefill left pad, inactive serving rows) leave
    the recurrent state as it is (their dt is forced to 0 and their conv
    input zeroed), and a row with no valid token keeps its conv ring
    unshifted, so an inactive row's cache is bitwise unchanged."""
    s_cfg = cfg.ssm
    d = cfg.d_model
    di = s_cfg.d_inner(d)
    nh = s_cfg.num_heads(d)
    dh = s_cfg.head_dim
    gn = s_cfg.ngroups * s_cfg.state_dim
    dt_ = x.dtype
    f32 = torch.float32

    z = x @ params["w_z"].to(dt_)
    xbc = torch.cat([x @ params["w_x"].to(dt_), x @ params["w_B"].to(dt_),
                     x @ params["w_C"].to(dt_)], dim=-1)
    dt_raw = x @ params["w_dt"].to(dt_)

    valid = None
    if cache is not None and positions is not None:
        valid = positions >= 0
        if valid.ndim == 1:
            valid = valid[None].expand(x.shape[:2])
        xbc = xbc * valid[..., None].to(xbc.dtype)

    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 None if cache is None else cache["conv"])
    x_ssm, B, C = torch.split(xbc, [di, gn, gn], dim=-1)
    b_, s_, _ = x_ssm.shape
    x_ssm = x_ssm.reshape(b_, s_, nh, dh)
    B = B.reshape(b_, s_, s_cfg.ngroups, s_cfg.state_dim)
    C = C.reshape(b_, s_, s_cfg.ngroups, s_cfg.state_dim)
    # torch's softplus is linear above 20, where log1p(exp(-x)) is below
    # half an f32 ulp of x: the same f32 numbers as the reference's
    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"].to(f32))
    if valid is not None:
        dt = dt * valid[..., None]  # dt = 0: the state update is a no-op
    A = -torch.exp(params["A_log"].to(f32))

    init_state = None if cache is None else cache["state"]
    if mode == "decode" and s_ == 1:
        y, new_state = ssd_decode_step(x_ssm, dt, A, B, C, init_state)
    else:
        chunk = min(s_cfg.chunk_size, s_)
        y, new_state = ssd_chunked(x_ssm, dt, A, B, C, chunk, init_state)

    y = y + x_ssm.to(f32) * params["D"].to(f32)[:, None]
    y = y.reshape(b_, s_, di).to(dt_)
    # gated RMSNorm (before out_proj): mean square accumulated in f32,
    # applied in the compute dtype
    y = y * F.silu(z)
    y = y * torch.rsqrt(_mean_sq(y) + 1e-6).to(dt_)
    y = y * params["norm_scale"].to(dt_)
    out = y @ params["w_out"].to(dt_)

    if cache is not None:
        new_conv = new_conv.to(cache["conv"].dtype)
        if valid is not None:
            # the conv shift has no algebraic no-op: keep the ring of a row
            # with no valid token
            live = valid.any(dim=1)[:, None, None]
            new_conv = torch.where(live, new_conv, cache["conv"])
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(new_state)
    return out, cache


def reset_ssm_rows(cache, row):
    """Zero row(s) of an SSM cache in place: unlike KV entries no position
    mask guards stale state, so a reused slot must be scrubbed."""
    cache["conv"][row] = 0
    cache["state"][row] = 0
    return cache


def init_ssm_cache(cfg, batch: int, dtype=torch.bfloat16, *, device):
    """Zero SSM cache of ``batch`` rows on ``device``: the conv ring in
    ``dtype``, the state in f32."""
    device = resolve_device(device)
    s = cfg.ssm
    d = cfg.d_model
    conv_ch = s.d_inner(d) + 2 * s.ngroups * s.state_dim
    return {
        "conv": torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, s.num_heads(d), s.head_dim,
                              s.state_dim), dtype=torch.float32,
                             device=device),
    }
